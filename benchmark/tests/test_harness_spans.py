"""The program's spans in the benchmark (benchmark/spans.py): the three
readers that read them on a hand-made record, the per-thread charge of the
device's idle time, and a traced CPU run of the tiny sr and cdna cells in
which the program's launch work counters equal roofline.py's units from
the wrappers' records of the same window."""
from types import SimpleNamespace

import pytest

from benchmark import spans as S
from benchmark.metrics import (ext_host_ms_per_mbase, host_offcpu_pct,
                               skeleton_ms_per_mbase)
from benchmark.tests import tiny

NEW = ("skeleton_ms_per_mbase", "ext_host_ms_per_mbase", "host_offcpu_pct")


def span(id, name, thread, a, b, cpu=0, parent=0, role="batch", batch=1):
    return SimpleNamespace(id=id, parent=parent, name=name, batch=batch,
                           role=role, thread=thread, start_ns=a, end_ns=b,
                           cpu_ns=cpu)


def test_new_readers():
    rec = dict(timers=dict(skeleton=0.5, ext_wave=3.0, ext_pack=0.25,
                           ext_upload=0.25, ext_launch=0.5, ext_decode=1.0,
                           device_wait=2.0),
               counters={}, frags=100, bases=10_000_000)
    assert skeleton_ms_per_mbase.read(rec) == pytest.approx(50.0)
    assert ext_host_ms_per_mbase.read(rec) == pytest.approx(200.0)
    # no spans in the record (benchmark/run.py's): nothing
    assert host_offcpu_pct.read(rec) is None
    # two batches of 10 s wall on their threads, 2 s of it waits on the
    # card: 16 s of host work, 12 s of it on a core; the steal lane's
    # device_wait is not a batch thread's
    rec["spans"] = [
        span(1, "map_batch", 1, 0, 10_000_000_000, cpu=6_000_000_000),
        span(2, "device_wait", 1, 1, 2_000_000_001, cpu=0, parent=1),
        span(3, "map_batch", 2, 0, 10_000_000_000, cpu=7_000_000_000),
        span(4, "device_wait", 9, 0, 5_000_000_000, role="steal_lane"),
        span(5, "device_wait", 2, 5, 2_000_000_005, cpu=1_000_000_000,
             parent=3)]
    assert host_offcpu_pct.read(rec) == pytest.approx(100 * (1 - 12 / 16))
    # a program without these spans (the parent of the tracer): nothing
    bare = dict(timers=dict(ext_wave=3.0, align=1.0), counters={},
                frags=100, bases=10_000_000, spans=[])
    for m in (skeleton_ms_per_mbase, ext_host_ms_per_mbase,
              host_offcpu_pct):
        assert m.read(bare) is None


def test_idle_by_span_charges_each_batch_thread():
    # thread 1: map_batch [0, 100) > seed [10, 40); thread 2: map_batch
    # [20, 60); main: feed_wait [70, 90). Idle gaps [0, 30), [50, 100).
    spans = [span(1, "map_batch", 1, 0, 100),
             span(2, "seed", 1, 10, 40, parent=1),
             span(3, "map_batch", 2, 20, 60, batch=2),
             span(4, "feed_wait", 0, 70, 90, role="main", batch=0),
             span(5, "ext_native", 7, 0, 100, role="host_lane")]
    got = S.idle_by_span([(s.start_ns, s.end_ns, s) for s in spans],
                         [(0, 30), (50, 100)])
    ns = {k: v * 1e9 for k, v in got.items()}
    # [0,10) map_batch; [10,20) seed; [20,30) seed/2 + map_batch(2)/2;
    # [50,60) map_batch(1)/2 + map_batch(2)/2; [60,100) map_batch(1)
    assert ns == pytest.approx({"batch/map_batch": 10 + 5 + 5 + 5 + 40,
                                "batch/seed": 10 + 5})
    # no batch span: the main thread's, else none
    got = S.idle_by_span([(s.start_ns, s.end_ns, s) for s in spans[3:4]],
                         [(60, 100)])
    assert {k: v * 1e9 for k, v in got.items()} == pytest.approx(
        {"main/feed_wait": 20, "none": 20})


def test_idle_intervals():
    assert S.idle_intervals((0, 100), [(10, 20), (15, 30), (50, 60),
                                       (95, 120)]) == [(0, 10), (30, 50),
                                                      (60, 95)]
    assert S.idle_intervals((0, 10), []) == [(0, 10)]


@pytest.mark.parametrize("kind", ["sr", "cdna"])
def test_traced_cpu_run_counts_the_roofline_units(kind):
    cell = tiny.cell()
    cell["per_layer"] += [dict(name=m, unit="x") for m in NEW]
    res = S.run(cell, tiny.CONFIGS[kind], tiny.MIXES[kind], 2**31 + 29,
                1.0, True, device="cpu")
    assert res["correct"], res["checked"]
    prog = res["program"]
    work = prog["launch_work"]
    assert work["equal"], work
    mode = "cdna" if kind == "cdna" else "many_segs"
    assert work["program"][f"chain_pairs_{mode}"] > 0
    assert work["program"]["walk_steps"] > 0
    for m in NEW:
        assert prog["metrics"][m] >= 0
    for m in NEW[:2]:      # readable from benchmark/run.py's record too
        assert res["metrics"][m]["value"] == pytest.approx(
            prog["metrics"][m])
    assert 0 < prog["spans_per_batch"]["max"] <= 2000
    idle = prog["idle_by_span"]
    assert sum(idle.values()) == pytest.approx(prog["idle_s"])
    assert idle.get("none", 0) <= 0.05 * prog["idle_s"]
