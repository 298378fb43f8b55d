"""utils/kernel_inputs.record() around TorchRuntime on the CPU (the plain
versions), in this process. By chain mode (single: map-ont reads;
many_segs: -x sr pairs; cdna: -x splice reads) it keeps the input with the
most anchor slots of the run, and on it the port's chain wrapper equals the
JAX package's Pallas kernel in interpret mode. It keeps the extension
launch with the most DP cells (extd2 under -x sr, exts2 under -x splice)
with the forward wrapper's scoring for its mode, and, apart, the largest
launch that holds base code 4. The block's exit, by an exception too, puts
the wrappers back. Under map_stream's two batch threads every kept input
is the largest of the whole run. A spy installed under record()'s wrappers
sees every call, so that "the largest" is counted apart from the code
under test."""
import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.ops import chain_pallas as CPJ
from minimap2_chaindp_tpu_torch import constants as C
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu_torch.models import (device_flow, device_pipeline,
                                               runtime)
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
from minimap2_chaindp_tpu_torch.ops import ksw2_ext
from minimap2_chaindp_tpu_torch.ops.chain_dp import chain_scores_batch
from minimap2_chaindp_tpu_torch.options import set_opt
from minimap2_chaindp_tpu_torch.utils import genome_synth as G
from minimap2_chaindp_tpu_torch.utils import kernel_inputs as KI

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
SITES = (device_flow, device_pipeline, runtime)
PAIRS = 16


def _has_code4(jobs) -> bool:
    return any((j["qseq"] == 4).any() or (j["tseq"] == 4).any()
               for j in jobs)


@contextlib.contextmanager
def spied():
    """Every chain call's (mode, anchor slots, thread) and every
    extension launch's (DP cells, holds code 4, splice, thread), and each
    _batch_async call's (mat, gaps, splice), from wrappers that record()
    then wraps in turn."""
    seen = dict(chain=[], ksw=[], batch=[])
    real_chain = {m: m.chain_scores_batch for m in SITES}
    real_pack, real_batch = ksw2_ext.pack_jobs, ksw2_ext._batch_async

    def chain_at(site):
        def chain(*a, **kw):
            seen["chain"].append((KI.chain_mode(kw), a[1].numel(),
                                  threading.get_ident()))
            return real_chain[site](*a, **kw)
        return chain

    def pack(jobs, *, splice, noncan=0):
        cells = sum(len(j["qseq"]) * len(j["tseq"]) for j in jobs)
        seen["ksw"].append((cells, _has_code4(jobs), splice,
                            threading.get_ident()))
        return real_pack(jobs, splice=splice, noncan=noncan)

    def batch(jobs, mat, gaps, **kw):
        seen["batch"].append((np.asarray(mat).copy(), tuple(gaps),
                              kw["splice"]))
        return real_batch(jobs, mat, gaps, **kw)

    for m in SITES:
        m.chain_scores_batch = chain_at(m)
    ksw2_ext.pack_jobs, ksw2_ext._batch_async = pack, batch
    try:
        yield seen
    finally:
        for m in SITES:
            m.chain_scores_batch = real_chain[m]
        ksw2_ext.pack_jobs, ksw2_ext._batch_async = real_pack, real_batch


def _index(preset, ref):
    """The preset's index of `ref` and its options, SAM with CIGARs (so
    that every read takes the extension)."""
    io, mo = set_opt(preset)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    return mi, mo


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """run(kind) -> (Recorder, seen, mo): one TorchRuntime run on the CPU
    under spied() and record(), made once a kind."""
    d = tmp_path_factory.mktemp("kernel_inputs")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=61)
    ont = str(d / "ont.fa")
    # two read lengths: two minimizer buckets of the flow, two launches
    G.simulate(ref, str(d / "ont1.fa"), 3, 1000, 0.10, seed=63)
    G.simulate(ref, str(d / "ont3.fa"), 3, 3000, 0.10, seed=64)
    with open(ont, "w") as fh:
        for n in (1, 3):
            fh.write((d / f"ont{n}.fa").read_text())
    r1, r2 = str(d / "r1.fq"), str(d / "r2.fq")
    G.simulate_pairs(ref, r1, r2, PAIRS, seed=65, err=0.02)
    # Ns in the first batch's pairs alone: launches with base code 4 and
    # launches without
    n1, n2 = str(d / "n1.fq"), str(d / "n2.fq")
    for src, dst, seed in ((r1, n1, 67), (r2, n2, 68)):
        G.transform_reads(src, dst + ".all", seed=seed, n_rate=0.02)
        with open(dst + ".all") as a, open(src) as b, open(dst, "w") as fh:
            fh.writelines(a.readlines()[:4 * (PAIRS // 3)]
                          + b.readlines()[4 * (PAIRS // 3):])
    inputs = {
        "ont": ("map-ont", ref, [ont], False),
        "sr": ("sr", ref, [r1, r2], True),
        "sr_n": ("sr", ref, [n1, n2], True),
        "splice": ("splice", os.path.join(DATA, "splice_genome.fa"),
                   [os.path.join(DATA, "splice_cdna.fa")], False),
        "stream": ("sr", ref, [r1, r2], True),
    }
    done = {}

    def run(kind):
        if kind not in done:
            preset, genome, reads, frag_mode = inputs[kind]
            mi, mo = _index(preset, genome)
            frags = [f for b in read_frags(reads, 1 << 40, frag_mode)
                     for f in b]
            # batches of unequal sizes, so that each mode has launches of
            # unequal sizes and the first is not the largest
            third = len(frags) // 3
            batches = [frags[:third], frags[third:]]
            rt = TorchRuntime(mi, mo, device="cpu")
            try:
                with spied() as seen, KI.record() as rec:
                    if kind == "stream":
                        batches[1:] = [frags[third:2 * third],
                                       frags[2 * third:]]
                        out = [ls for b in rt.map_stream(batches) for ls in b]
                    else:
                        out = [ls for b in batches for ls in rt.map_batch(b)]
            finally:
                rt.close()
            assert len(out) == len(frags)
            done[kind] = (rec, seen, mo)
        return done[kind]
    return run


def _pallas(args, kw):
    """The JAX package's chain kernel in interpret mode on `args`, its rows
    padded to a multiple of 8 (empty rows: nn 0, exceptions -1)."""
    R = args[0].shape[0]
    pad = -R % 8

    def fill(i, t):
        a = t.numpy()
        return np.concatenate(
            [a, np.full((pad, *a.shape[1:]), -1 if i == 8 else 0, a.dtype)])
    out = CPJ.chain_scores_batch(*(fill(i, t) for i, t in enumerate(args)),
                                 interpret=True, **kw)
    return [np.asarray(t)[:R] for t in out]


def check_chain(runs, kind, mode):
    rec, seen, _mo = runs(kind)
    slots = [s for m, s, _t in seen["chain"] if m == mode]
    assert slots, f"no {mode} launch"
    kept, args, kw = rec.chain[mode]
    assert kept == max(slots) == args[1].numel()
    assert kw["max_n"] == args[1].shape[1] and int(args[6][:, 0].max()) > 0
    got = [t.numpy() for t in chain_scores_batch(*args, **kw)]
    for name, g, w in zip(("f", "p", "flag"), got, _pallas(args, kw)):
        assert np.array_equal(g, w), name


def check_ksw(runs, kind, splice):
    rec, seen, mo = runs(kind)
    cells = [c for c, _n, s, _t in seen["ksw"] if s == splice]
    assert cells and rec.ksw is not None
    kept_cells, jobs, kept_splice, _noncan = rec.ksw
    assert kept_splice == splice
    assert kept_cells == max(c for c, *_ in seen["ksw"]) == sum(
        len(j["qseq"]) * len(j["tseq"]) for j in jobs)
    calls = [(m, g) for m, g, s in seen["batch"] if s == splice]
    assert len({(m.tobytes(), g) for m, g in calls}) == 1
    mat, gaps = calls[0]
    want = ksw2_ext.forward_scoring(mat, gaps, splice=splice)
    assert rec.scoring[splice] == want
    q, e, _q2, _e2, mat0, sc_mis, *_ = want
    assert (q, e, mat0, sc_mis) == (mo.q, mo.e, mo.a, -mo.b)


def check_ksw_n(runs):
    rec, seen, _mo = runs("sr_n")
    cells = [c for c, n, _s, _t in seen["ksw"] if n]
    assert cells and rec.ksw_n is not None
    assert any(not n for _c, n, _s, _t in seen["ksw"])
    kept_cells, jobs, _splice, _noncan = rec.ksw_n
    assert _has_code4(jobs) and kept_cells == max(cells)


def check_restored(_runs):
    def current():
        return ([m.chain_scores_batch for m in SITES], ksw2_ext.pack_jobs,
                ksw2_ext._batch_async)
    before = current()
    with KI.record():
        inside = current()
    assert all(a is not b for a, b in zip(inside[0], before[0]))
    assert inside[1] is not before[1] and inside[2] is not before[2]
    after = current()
    with pytest.raises(RuntimeError, match="inside the block"):
        with KI.record():
            raise RuntimeError("inside the block")
    for now in (after, current()):
        assert all(a is b for a, b in zip(now[0], before[0]))
        assert now[1] is before[1] and now[2] is before[2]


def check_stream(runs):
    rec, seen, _mo = runs("stream")
    assert len({t for *_x, t in seen["chain"]}) == 2    # two batch threads
    for mode in {m for m, _s, _t in seen["chain"]}:
        assert rec.chain[mode][0] == max(
            s for m, s, _t in seen["chain"] if m == mode)
    assert rec.ksw[0] == max(c for c, *_ in seen["ksw"])


CASES = {
    "chain_single": lambda r: check_chain(r, "ont", "single"),
    "chain_many_segs": lambda r: check_chain(r, "sr", "many_segs"),
    "chain_cdna": lambda r: check_chain(r, "splice", "cdna"),
    "ksw_extd2": lambda r: check_ksw(r, "sr", False),
    "ksw_exts2": lambda r: check_ksw(r, "splice", True),
    "ksw_n": check_ksw_n,
    "restored": check_restored,
    "two_threads": check_stream,
}


@pytest.mark.parametrize("case", list(CASES))
def test_record_keeps_the_largest_inputs(runs, case):
    CASES[case](runs)
