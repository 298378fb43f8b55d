"""The plain reference: its vectorised sketch equals the golden automaton,
its index the port's, and its mapping the port's host runtime (a second
witness), on small inputs."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run as R
from benchmark.reference.index import build as RB
from benchmark.tests import tiny
from benchmark.traffic import synth


def contigs(seed, n=6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        s = rng.integers(0, 4, int(rng.integers(30, 5000))).astype(np.uint8)
        for _ in range(len(s) // 300):     # microsatellites and N runs
            p = int(rng.integers(0, max(1, len(s) - 200)))
            u = rng.integers(0, 4, int(rng.integers(1, 5))).astype(np.uint8)
            run = np.tile(u, 60)[:int(rng.integers(10, 150))]
            s[p:p + len(run)] = run[:len(s) - p]
        for _ in range(len(s) // 2000):
            p = int(rng.integers(0, len(s) - 40))
            s[p:p + int(rng.integers(1, 40))] = 4
        out.append(s)
    return out + [np.full(30, 4, np.uint8), np.zeros(5, np.uint8)]


@pytest.mark.parametrize("w,k,chunk", [(10, 15, 64), (11, 21, 100),
                                       (5, 15, 4096), (3, 5, 17)])
def test_sketch_equals_the_golden_automaton(w, k, chunk):
    from benchmark.reference.index.sketch import _sketch_py
    cs = contigs(w * k)
    want = [_sketch_py(c, len(c), w, k, rid, False)
            for rid, c in enumerate(cs) if len(c)]
    want = sorted(map(tuple, np.concatenate(want).tolist()))
    x, y = RB.sketch_contigs(cs, w, k, chunk=chunk, group=7)
    assert sorted(zip(x.tolist(), y.tolist())) == want


def test_index_equals_the_ports():
    from minimap2_chaindp_tpu_torch.index.build import build_index
    cs = [c for c in contigs(1, 4) if len(c) > 100]
    names = [f"c{i}" for i in range(len(cs))]
    mine = RB.build_index(names, cs, 10, 15)
    port = build_index(names, [c.copy() for c in cs], 10, 15, 0, 14)
    for f in ("keys", "starts", "values", "S", "name_rank"):
        assert np.array_equal(getattr(mine, f), getattr(port, f)), f


@pytest.mark.parametrize("kind", ["ont", "sr", "cdna"])
def test_mapping_equals_the_ports_host_runtime(kind, tmp_path):
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    config, mix = tiny.CONFIGS[kind], dict(tiny.MIXES[kind], batches=1)
    inputs = R.make_inputs(config, mix, 17, str(tmp_path))
    io, mo = set_opt(config["preset"])
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(inputs["genome"]))
    mi = build_index([r.name for r in recs],
                     [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags(inputs["files"], 10**9,
                                   inputs["frag_mode"]) for f in b][:4]
    want = HostRuntime(mi, mo).map_batch(frags)
    out = R.reference(dict(genome=inputs["genome"], preset=config["preset"],
                           flags=config["flags"], workers=2,
                           frags=[R.frag_job(f) for f in frags]))
    assert out["lines"] == want
    assert out["mid_occ"] == mo.mid_occ


def _row_scores_by_blocks(s, sf, qr, qrr_base, st0, en0, m, mch, mis, sc_n):
    """The frozen copy's loop over 16-base blocks, which row_scores
    replaced."""
    for t0 in range(st0, en0 + 1, 16):
        sq = sf[t0:t0 + 16]
        stq = qr[qrr_base + t0:qrr_base + t0 + 16]
        mask = (sq == m - 1) | (stq == m - 1)
        blk = np.where(sq == stq, mch, mis)
        s[t0:t0 + 16] = np.where(mask, sc_n, blk)


def test_row_scores_equal_the_block_loop():
    from benchmark.reference.ops import ksw2
    rng = np.random.default_rng(2**31 + 3)
    mch, mis, sc_n = np.int8(2), np.int8(-4), np.int8(-1)
    for _ in range(500):
        qlen, tlen = (int(x) for x in rng.integers(1, 300, 2))
        tlen16 = (tlen + 15) // 16 * 16
        sf = np.zeros(tlen16 + 16, np.uint8)
        sf[:tlen] = rng.integers(0, 5, tlen)
        qr = np.zeros(qlen + 32 + tlen16, np.uint8)
        qr[:qlen] = rng.integers(0, 5, qlen)
        r = int(rng.integers(0, qlen + tlen - 1))
        st0, en0 = max(0, r - qlen + 1), min(tlen - 1, r)
        want = rng.integers(-9, 9, tlen16 + 16).astype(np.int8)
        got = want.copy()
        _row_scores_by_blocks(want, sf, qr, qlen - 1 - r, st0, en0, 5, mch,
                              mis, sc_n)
        ksw2.row_scores(got, sf, qr, qlen - 1 - r, st0, en0, 5, mch, mis,
                        sc_n)
        assert np.array_equal(got, want)
