"""The port's interval tracer (utils/trace.py) on the CPU: with tracing off
the runtime's Timers sum exactly as the plain Timers do; with it on, tiny
sr-pair, splice and map-ont runs through map_stream (two batches in
flight) give a well-formed span tree, batch by batch; the launch work
counters equal a direct count from each chain launch's stw/nn and from
each extension job and its result; the JAX package's plain Timers is
still taken wherever the port takes a timers object."""
import os
import re
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu_torch import constants as C
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu_torch.models import device_flow as DF
from minimap2_chaindp_tpu_torch.models import runtime as RT
from minimap2_chaindp_tpu_torch.ops import ksw2 as K
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.options import set_opt
from minimap2_chaindp_tpu_torch.utils import genome_synth as G
from minimap2_chaindp_tpu_torch.utils.timers import Timers
from minimap2_chaindp_tpu_torch.utils.trace import Tracer, active, carry

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
KINDS = ("sr", "splice", "map-ont")
BATCH = {"sr": 2, "splice": 1, "map-ont": 2}    # fragments a batch


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(mi, mo, batches) of each kind, built once: sr pairs and map-ont
    reads on a synthetic genome, the splice fixture of tests/data."""
    d = tmp_path_factory.mktemp("trace")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=100_000, seed=61)
    G.simulate_pairs(ref, str(d / "1.fq"), str(d / "2.fq"), 6, seed=62,
                     err=0.02)
    G.simulate(ref, str(d / "ont.fa"), 4, 1000, 0.05, seed=63)
    spec = {"sr": (ref, [str(d / "1.fq"), str(d / "2.fq")], True),
            "splice": (os.path.join(DATA, "splice_genome.fa"),
                       [os.path.join(DATA, "splice_cdna.fa")], False),
            "map-ont": (ref, [str(d / "ont.fa")], False)}

    @lru_cache(maxsize=None)
    def get(kind):
        genome, queries, frag_mode = spec[kind]
        io, mo = set_opt(kind)
        mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
        recs = list(read_fastx(genome))
        mi = build_index([r.name for r in recs],
                         [C.seq_to_nt4(r.seq) for r in recs],
                         io.w, io.k, io.flag, io.bucket_bits)
        mo.update(mi)
        frags = [f for b in read_frags(queries, 1 << 30, frag_mode)
                 for f in b]
        if kind == "splice":      # the two shorter transcripts
            frags = frags[1::2]
        n = BATCH[kind]
        return mi, mo, [frags[i:i + n] for i in range(0, len(frags), n)]
    return get


def _plain_timers(rt, timers):
    rt.timers = rt.align_exec.timers = timers
    return rt


def _masked(summary: str) -> str:
    """The [timers] line without its times: names, span counts and
    counters."""
    return re.sub(r"=\d+\.\dms/", "=ms/", summary)


@pytest.fixture(scope="module")
def runs(inputs):
    """Per kind: the runtime's Timers after an untraced pass, a plain
    Timers' after the same pass, then a traced pass's spans, counters and
    every chain and extension launch it made (captured around the
    runtime's call sites)."""
    @lru_cache(maxsize=None)
    def get(kind):
        mi, mo, batches = inputs(kind)
        plain = _plain_timers(RT.TorchRuntime(mi, mo, device="cpu"),
                              Timers())
        want = [ls for b in plain.map_stream(iter(batches)) for ls in b]
        plain.close()
        rt = RT.TorchRuntime(mi, mo, device="cpu")
        got = [ls for b in rt.map_stream(iter(batches)) for ls in b]
        assert got == want
        off = dict(acc=dict(rt.timers.acc), n=dict(rt.timers.n),
                   counters=dict(rt.timers.counters),
                   line=rt.timers.summary(), spans=rt.timers.stop_trace())
        launches = dict(chain=[], ksw=[])
        mp = pytest.MonkeyPatch()
        for mod in (RT, DF):
            real = mod.chain_scores_batch

            def chain(*a, _real=real, **kw):
                launches["chain"].append((a[:9], kw))
                return _real(*a, **kw)
            mp.setattr(mod, "chain_scores_batch", chain)
        for name, splice in (("extd2_batch", False), ("exts2_batch", True)):
            real = getattr(KE, name)

            def batch(jobs, *a, _real=real, _splice=splice, **kw):
                res = _real(jobs, *a, **kw)
                launches["ksw"].append((list(jobs), list(res), _splice))
                return res
            mp.setattr(KE, name, batch)
        before = dict(rt.timers.counters)
        rt.timers.start_trace()
        try:
            traced = [ls for b in rt.map_stream(iter(batches)) for ls in b]
        finally:
            spans = rt.timers.stop_trace()
            mp.undo()
            rt.close()
        assert traced == want
        counted = {k: v - before.get(k, 0)
                   for k, v in rt.timers.counters.items()}
        return dict(off=off, plain=dict(
            acc=dict(plain.timers.acc), n=dict(plain.timers.n),
            counters=dict(plain.timers.counters),
            line=plain.timers.summary()), spans=spans, counted=counted,
            launches=launches, batches=len(batches))
    return get


@pytest.mark.parametrize("kind", KINDS)
def test_tracing_off_sums_as_plain_timers(runs, kind):
    r = runs(kind)
    off, plain = r["off"], r["plain"]
    assert off["spans"] == []
    assert off["counters"] == plain["counters"]
    assert off["n"] == plain["n"] and set(off["acc"]) == set(plain["acc"])
    assert _masked(off["line"]) == _masked(plain["line"])
    # no launch work counter without a trace
    assert not any(k.startswith(("chain_pairs", "ksw_cells", "walk_",
                                 "ksw_signal"))
                   for k in off["counters"])


@pytest.mark.parametrize("kind", KINDS)
def test_span_tree(runs, kind):
    r = runs(kind)
    spans = r["spans"]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s.name == "map_batch"]
    assert len(roots) == r["batches"]
    assert len({s.batch for s in roots}) == len(roots) and all(
        s.batch > 0 and s.parent == 0 and s.role == "batch" for s in roots)
    # two batches in flight: some two map_batch spans overlap in time, on
    # two threads
    assert any(a.thread != b.thread and a.start_ns < b.end_ns
               and b.start_ns < a.end_ns for a in roots for b in roots)
    per_batch = {s.batch: 0 for s in roots}
    for s in spans:
        assert s.start_ns <= s.end_ns and 0 <= s.cpu_ns <= s.end_ns \
            - s.start_ns, s
        if s.name == "feed_wait":
            assert (s.role, s.batch, s.parent) == ("main", 0, 0)
            continue
        root = s
        while root.parent:
            p = by_id[root.parent]
            assert p.start_ns <= root.start_ns and root.end_ns <= p.end_ns
            assert p.thread == root.thread and p.batch == root.batch
            root = p
        assert root.name == "map_batch" and s.batch == root.batch, s
        per_batch[s.batch] += 1
    assert max(per_batch.values()) <= 2000
    parent = lambda s: by_id[s.parent].name
    names = {s.name for s in spans}
    assert {"seed", "sketch", "seed_hits", "kernel", "chain_upload",
            "chain_launch", "device_wait", "align", "epilogue",
            "feed_wait"} <= names
    for s in spans:
        if s.name in ("sketch", "seed_hits"):
            assert parent(s) == "seed"
        elif s.name in ("chain_upload", "chain_launch"):
            assert parent(s) == "kernel"
        elif s.name == "device_wait":
            assert parent(s) in ("kernel", "ext_wave")
        elif s.name in ("native_finish", "staged_align"):
            assert parent(s) == "align"
        elif s.name == "skeleton":
            assert parent(s) == "staged_align"
        elif s.name in ("ext_pack", "ext_upload", "ext_launch", "ext_decode"):
            assert parent(s) == "ext_wave"
        elif s.name == "flow_prep":
            assert parent(s) == "flow"
        elif s.name == "flow":
            assert parent(s) == "map_batch"
    if kind == "map-ont":
        assert {"native_finish", "flow", "flow_prep"} <= names
        # the flow's kernel and bottom half nest under its span, the
        # staged path's beside it
        for name in ("kernel", "bottom"):
            assert any(parent(s) == "flow" for s in spans
                       if s.name == name)
    else:
        assert {"staged_align", "skeleton", "ext_wave", "ext_pack",
                "ext_upload", "ext_launch", "ext_decode"} <= names


def test_carry_hands_the_batch_to_a_worker():
    tr = Tracer()
    tr.start_trace()
    seen = []

    def work():
        seen.append(active())
        with tr.time("lane_work"):
            pass
    with ThreadPoolExecutor(1) as ex:
        with tr.time("map_batch"):
            with tr.time("seed"):
                ex.submit(carry(work)).result()
            worker = threading.Thread(target=carry(work, "steal_lane"))
            worker.start()
            worker.join(30)
        assert not worker.is_alive()
        ex.submit(carry(work)).result()     # outside any span: not carried
    spans = {(s.name, s.role): s for s in tr.stop_trace()}
    root, seed = spans["map_batch", "batch"], spans["seed", "batch"]
    lane = spans["lane_work", "host_lane"]
    assert (lane.batch, lane.parent) == (root.batch, seed.id)
    assert lane.thread != seed.thread
    steal = spans["lane_work", "steal_lane"]
    assert (steal.batch, steal.parent) == (root.batch, root.id)
    loose = spans["lane_work", "other"]
    assert (loose.batch, loose.parent) == (0, 0)
    assert seen == [True, True, False]
    assert carry(work) is work      # no trace: the function itself


def _window_pairs(stw, nn) -> int:
    stw, nn = stw.cpu().numpy(), nn.cpu().numpy()
    return sum(i - max(int(stw[r, i]), 0) for r in range(stw.shape[0])
               for i in range(int(nn[r, 0])))


def _job_cells(job, ez, splice) -> int:
    ql, tl = len(job["qseq"]), len(job["tseq"])
    rows = ql + tl - 1
    if ez.zdropped:
        rows = min(rows, max(ez.max_t + ez.max_q + 1, 1))
    w = job["w"] if not splice and job["w"] >= 0 else max(ql, tl)
    n = 0
    for r in range(rows):
        st, en = max(0, r - ql + 1), min(tl - 1, r)
        if not splice:
            st, en = max(st, (r - w + 1) // 2), min(en, (r + w) // 2)
        n += max(en - st + 1, 0)
    return n


@pytest.mark.parametrize("chunk", [1, 7, 1 << 22])
def test_band_cells_equal_a_row_loop(chunk):
    """ksw2_ext._band_cells, closed where no band binds and a lane a row
    elsewhere, against a loop over every anti-diagonal, on random jobs:
    banded (the band binding or not) and unbanded, cut short or not."""
    rng = np.random.default_rng(71)
    for _ in range(40):
        n = int(rng.integers(1, 30))
        ql, tl = rng.integers(1, 200, n), rng.integers(1, 200, n)
        w = rng.integers(0, 450, n)
        rows = np.minimum(ql + tl - 1, rng.integers(1, 400, n))
        for band in (w, None):
            want = []
            for i in range(n):
                job = dict(qseq=[0] * int(ql[i]), tseq=[0] * int(tl[i]),
                           w=int(w[i]))
                cut = types.SimpleNamespace(zdropped=1, max_t=int(rows[i]) - 1,
                                            max_q=0)
                want.append(_job_cells(job, cut, band is None))
            assert KE._band_cells(ql, tl, band, rows, chunk).tolist() == want


@pytest.mark.parametrize("kind", KINDS)
def test_launch_counters_equal_a_direct_count(runs, kind):
    r = runs(kind)
    c, launches = r["counted"], r["launches"]
    want: dict = {}

    def add(k, v):
        want[k] = want.get(k, 0) + v
    for args, kw in launches["chain"]:
        mode = "cdna" if kw["is_cdna"] else (
            "many_segs" if kw["many_segs"] else "single")
        add(f"chain_pairs_{mode}", _window_pairs(args[5], args[6]))
        add("chain_in_bytes", sum(t.numel() * t.element_size()
                                  for t in args))
        # f and p, int32 a slot, and the flag column, as roofline.py's
        add("chain_out_bytes", 2 * args[5].numel() * 4 + args[6].shape[0] * 4)
    for jobs, res, splice in launches["ksw"]:
        kind2 = "exts2" if splice else "extd2"
        for job, ez in zip(jobs, res):
            n = _job_cells(job, ez, splice)
            add(f"ksw_cells_{kind2}", n)
            add(f"ksw_cells_{kind2}_approx",
                n if job["flag"] & K.KSW_EZ_APPROX_MAX else 0)
            add(f"ksw_cells_{kind2}_score",
                n if job["flag"] & K.KSW_EZ_SCORE_ONLY else 0)
            add("walk_steps", 0 if job["flag"] & K.KSW_EZ_SCORE_ONLY
                else sum(x >> 4 for x in ez.cigar))
            add("ksw_in_bytes", len(job["qseq"])
                + len(job["tseq"]) * (2 if splice else 1))
            # the uploaded arrays: target and reversed query with their
            # pads, a meta row, poff and twice the order (no splice
            # signal: the card computes it)
            add("ksw_h2d_bytes", (len(job["tseq"]) + 15) // 16 * 16 + 32
                + len(job["qseq"]) + 16 + 16 * 4 + 8 + 2 * 4)
        add(f"ksw_jobs_{kind2}", len(jobs))
        add("ksw_signal_jobs", len(jobs) if splice else 0)
    assert launches["chain"]
    assert {k: c.get(k, 0) for k in want} == want
    assert c["chain_h2d_bytes"] > 0 and c["chain_d2h_bytes"] > 0
    if kind == "map-ont":
        assert want["chain_pairs_single"] > 0
    else:
        assert launches["ksw"] and c["walk_steps"] > 0
        assert c["ksw_h2d_bytes"] > 0 and c["ksw_d2h_bytes"] > 0


def test_plain_timers_are_taken(inputs):
    """DeviceFlow.run, the executor and run_scheduler take the JAX
    package's plain Timers, inside a trace too: its spans and counters
    sum there, and the launch work counters reach it."""
    from minimap2_chaindp_tpu.utils.timers import Timers as JTimers
    from minimap2_chaindp_tpu_torch.models.batch_align import (
        CudaAlignExecutor, run_scheduler)
    from minimap2_chaindp_tpu_torch.models.pipeline import (
        finish_unit_gen, prepare_frag, seed_unit)
    mi, mo, batches = inputs("map-ont")
    units = [(u, seed_unit(mi, mo, u, collect_hits=False))
             for b in batches for f in b
             for u in prepare_frag(mo, f.segs)[2]]
    tr = Tracer()
    tr.start_trace()
    jt = JTimers()
    with tr.time("map_batch"):
        chains = DF.DeviceFlow(mi, mo, device="cpu").run(units, jt)
    assert chains and jt.counters["device_reads"] == len(chains)
    assert jt.counters["chain_pairs_single"] > 0
    assert {"kernel", "chain_upload", "chain_launch", "device_wait",
            "bottom"} <= set(jt.acc)
    assert all(s.name == "map_batch" for s in tr.stop_trace())
    mi, mo, batches = inputs("splice")
    jt = JTimers()
    ex = CudaAlignExecutor(mo, device="cpu", timers=jt)
    units = [(u, seed_unit(mi, mo, u)) for b in batches for f in b
             for u in prepare_frag(mo, f.segs)[2]]
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    chains = rt._chain_batch(units)
    gens = [finish_unit_gen(mi, ex.opt, info, ch)
            for (_u, info), ch in zip(units, chains)]
    regs = run_scheduler(gens, ex)
    assert len(regs) == len(units) and any(regs)
    assert jt.counters["ext_device"] > 0
    assert {"skeleton", "ext_wave", "ext_pack", "ext_launch",
            "ext_decode"} <= set(jt.acc)
    assert np.isfinite(sum(jt.acc.values()))
