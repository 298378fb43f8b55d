"""The ONT cell (`ont-lognorm-10k` on `chr250-map-ont`): it is found by
name with its metrics, the three readers of the fused flow and the native
finish give a number from a hand-made record and nothing where the span or
counter is missing, and a traced CPU run of the tiny ONT cell through
benchmark/spans.py reads them, charges idle time to the flow's spans and
counts the flow's launch work as roofline.py does."""
import pytest

from benchmark import run as R
from benchmark import spans as S
from benchmark.metrics import (finish_ms_per_mbase, flow_prep_ms_per_mbase,
                               flow_read_share_pct)
from benchmark.tests import tiny

NEW = ("flow_read_share_pct", "flow_prep_ms_per_mbase",
       "finish_ms_per_mbase")
# the accepted metrics with no `workloads` list: every cell reports them
EVERY_CELL = ("card_chain_share_pct", "seed_ms_per_mbase",
              "chain_roofline_pct", "device_idle_pct")


def test_the_cell_is_found_with_its_metrics():
    cell, config, mix = R.load_cell("ont-lognorm-10k")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "chr250-map-ont", "ont-lognorm-10k", 1)
    assert config["preset"] == "map-ont" and "loci" not in config["genome"]
    assert mix["kind"] == "ont" and mix["batches"] * mix["reads"] == 4800
    assert mix["check_frags"] % mix["batches"] == 0   # even over batches
    names = {m["name"] for m in cell["per_layer"]}
    assert names == set(NEW + EVERY_CELL)
    for other in ("sr-pairs-150", "cdna-splice-zipf"):
        assert not set(NEW) & {m["name"]
                               for m in R.load_cell(other)[0]["per_layer"]}


@pytest.mark.parametrize("reader,rec,want", [
    (flow_read_share_pct,
     dict(counters=dict(flow_units=200, device_reads=170)), 85.0),
    (flow_read_share_pct, dict(counters=dict(device_reads=170)), None),
    (flow_read_share_pct, dict(counters=dict(flow_units=0)), None),
    (flow_prep_ms_per_mbase, dict(timers=dict(flow_prep=0.4)), 40.0),
    (flow_prep_ms_per_mbase, dict(timers=dict(flow=0.4)), None),
    (finish_ms_per_mbase,
     dict(timers=dict(native_finish=3.0),
          counters=dict(native_finish_bases=8_000_000)), 375.0),
    (finish_ms_per_mbase,
     dict(timers=dict(native_finish=3.0), counters=dict(native_finish=9)),
     None),
    (finish_ms_per_mbase,
     dict(timers={}, counters=dict(native_finish_bases=8_000_000)), None),
], ids=["share", "share-no-units", "share-zero-units", "prep",
        "prep-no-span", "finish", "finish-no-bases", "finish-no-span"])
def test_readers(reader, rec, want):
    rec = dict(dict(timers={}, counters={}, frags=100, bases=10_000_000,
                    window_s=10.0, device=None), **rec)
    got = reader.read(rec)
    assert got == (None if want is None else pytest.approx(want))


def test_traced_cpu_run_reads_the_flow():
    cell = tiny.cell()
    cell["per_layer"] = [dict(name=m, unit="x") for m in NEW + EVERY_CELL]
    res = S.run(cell, tiny.CONFIGS["ont"], tiny.MIXES["ont"], 2**31 + 41,
                1.0, True, device="cpu")
    assert res["correct"], res["checked"]
    for m in NEW:
        assert res["metrics"][m]["value"] > 0, m
    assert res["metrics"]["flow_read_share_pct"]["value"] <= 100
    prog = res["program"]
    assert {"batch/flow", "batch/flow_prep"} <= set(prog["span_s"])
    assert any(k.startswith("batch/flow") or k in ("batch/kernel",
                                                   "batch/bottom")
               for k in prog["idle_by_span"])
    work = prog["launch_work"]
    assert work["equal"] and work["program"]["chain_pairs_single"] > 0
