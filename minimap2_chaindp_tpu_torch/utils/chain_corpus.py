"""Boundary corpus of the chaining-DP score pass: small batches aimed at the
places where a staged, tiled implementation goes wrong. The same cases hold
the plain PyTorch version against the JAX package on the CPU
(tests/test_torch_chain_dp.py) and the CUDA kernel against the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py phase 3).

What the cases cover, in each of the three modes:
  sizes     reads with n = 0, 1 and n = max_n; windows that are empty
            (stw[i] == i) because every anchor is out of reach or sits on
            another reference sequence or strand;
  windows   of exactly 31, 32 and 33 candidates (the 32-wide tile and one
            either side of it);
  wide      windows of more than 512 candidates (cdna: big gaps), far more
            tiles than anchors;
  ties      the same best score on candidates in different 32-wide tiles
            and on different lanes of one tile: the LARGEST j must win;
  skip      the count of valid candidates above p[i] exactly at max_skip
            (no flag) and at max_skip + 1 (flag);
  exc       c_lin exception patches on gaps that occur.
Only numpy is needed to build the cases.
"""
from __future__ import annotations

import numpy as np

from ..ops.chain_host import split_anchors
from ..ops.chain_pack import pack_reads

FIELDS = ("xhi", "rpos", "qpos", "span", "sid", "stw")
MODES = {"single": dict(is_cdna=False, many_segs=False),
         "many_segs": dict(is_cdna=False, many_segs=True),
         "cdna": dict(is_cdna=True, many_segs=False)}
# exact windows: rpos in steps of WINDOW_DIST / W puts exactly W candidates
# in reach of every anchor i >= W
WINDOW_DIST = 31 * 32 * 33
TIE_SKIP = 25


def anchors_of(rp, qp, span, rid=None, seg=None):
    """(n, 2) uint64 anchors sorted by x (stable), as collect_seed_hits
    leaves them."""
    rp, qp, span = (np.asarray(v, dtype=np.uint64) for v in (rp, qp, span))
    x = rp.copy()
    if rid is not None:
        x |= np.asarray(rid, dtype=np.uint64) << np.uint64(32)
    y = span << np.uint64(32) | qp
    if seg is not None:
        y |= np.asarray(seg, dtype=np.uint64) << np.uint64(48)
    a = np.stack([x, y], axis=1)
    return a[np.argsort(a[:, 0], kind="stable")]


def pack_batch(batch, max_n: int, max_dist_x: int, avg_qspan=None):
    """Anchor arrays -> the nine kernel inputs in call order. avg_qspan
    replaces each read's own mean span (from which pack_reads derives w1
    and exc) where the case sets w1 itself."""
    reads = []
    for a in batch:
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(max(len(a), 1))
                          if avg_qspan is None else np.float32(avg_qspan)))
    packed, nn, w1, exc, host_flag = pack_reads(reads, max_n, max_dist_x)
    assert not host_flag.any(), "corpus read needs the host path"
    return [packed[k] for k in FIELDS] + [nn, w1, exc]


def _diagonal(rng, n, step, jitter, two_segs):
    """n anchors on a noisy diagonal, rpos in exact steps of `step`."""
    rp = 1000 + step * np.arange(n)
    qp = rp + rng.integers(-jitter, jitter + 1, n)
    seg = (np.arange(n) % 2) if two_segs else None
    return anchors_of(rp, qp, rng.integers(13, 20, n), seg=seg)


def _sizes(rng, mode, max_n):
    two = mode == "many_segs"
    far = 10 * WINDOW_DIST
    batch = [
        np.empty((0, 2), np.uint64),                       # n = 0
        _diagonal(rng, 1, 7, 0, False),                    # n = 1
        _diagonal(rng, max_n, 11, 3, two),                 # n = max_n
        # every anchor out of reach of the one before
        anchors_of(1000 + far * np.arange(40), 50 + 20 * np.arange(40),
                 np.full(40, 15)),
        # every anchor on a reference sequence of its own
        anchors_of(1000 + 9 * np.arange(40), 50 + 9 * np.arange(40),
                 np.full(40, 15), rid=np.arange(40)),
        _diagonal(rng, 77, 11, 3, two),
    ]
    return batch


def _windows(rng, mode):
    two = mode == "many_segs"
    return [_diagonal(rng, 150, WINDOW_DIST // w, 4, two)
            for w in (31, 32, 33)] + [_diagonal(rng, 31, 5, 2, two),
                                      _diagonal(rng, 32, 5, 2, two),
                                      _diagonal(rng, 33, 5, 2, two)]


def _tie_read(k_all, k_strong, n_after):
    """k_all candidates with one qpos (so none chains from another), rpos one
    apart; the first k_strong of them with span 200, the rest 100. The
    n_after anchors that follow see all of them at the same gap cost once
    w1 is 0 (dd within [1024, 2047]: one value of ilog2), so the strong ones
    tie for the best score and k_all - k_strong valid weaker ones lie above
    the winner. The anchors after share one qpos too, so each chains from
    the tie group alone."""
    rp = list(5000 + np.arange(k_all))
    qp = [400] * k_all
    span = [200] * k_strong + [100] * (k_all - k_strong)
    for t in range(n_after):
        rp.append(5000 + k_all + 1800 + t)
        qp.append(400 + 300)
        span.append(15)
    return anchors_of(rp, qp, span)


def boundary_cases(wide_n: int = 640):
    """List of dict(name, arrays, kw, anchors, n_segs, exact_host):
    arrays are the nine numpy inputs of chain_scores_batch in call order,
    kw its keywords (max_n and use_exc among them), anchors the reads as
    (n, 2) uint64 arrays. exact_host says whether w1 and exc are the ones
    pack_reads derived, so that an unflagged read must also agree with
    ops/chain.py:chain_dp after backtrack. wide_n sets the anchors of the
    wide-window reads (their windows hold up to wide_n - 1 candidates)."""
    cases = []
    gaps = {"single": dict(max_dist_x=5000, max_dist_y=5000, bw=500),
            "many_segs": dict(max_dist_x=800, max_dist_y=600, bw=100),
            "cdna": dict(max_dist_x=200000, max_dist_y=2000, bw=500)}
    for m, (mode, flags) in enumerate(MODES.items()):
        n_segs = 2 if mode == "many_segs" else 1
        rng = np.random.default_rng(100 + m)
        base = dict(flags, max_skip=25, use_exc=True)
        # sizes and empty windows
        max_n = 128
        batch = _sizes(rng, mode, max_n)
        cases.append(dict(
            name=f"{mode} sizes", anchors=batch, n_segs=n_segs,
            arrays=pack_batch(batch, max_n, gaps[mode]["max_dist_x"]),
            kw=dict(base, max_n=max_n, **gaps[mode]), exact_host=True))
        # windows of exactly 31, 32, 33 candidates
        wide = dict(max_dist_x=WINDOW_DIST, max_dist_y=WINDOW_DIST, bw=500)
        if mode == "cdna":
            wide["max_dist_y"] = 2000
        batch = _windows(rng, mode)
        arrays = pack_batch(batch, 256, WINDOW_DIST)
        stw = arrays[5]
        for r, w in enumerate((31, 32, 33)):
            i = np.arange(w, 150)
            assert (i - stw[r, w:150] == w).all()
        cases.append(dict(
            name=f"{mode} windows 31/32/33", anchors=batch, n_segs=n_segs,
            arrays=arrays, kw=dict(base, max_n=256, **wide),
            exact_host=True))
        # ties and the skip count: w1 = 0 makes the gap cost of the tie
        # group one value, so these reads are not held against chain_dp
        for above in (TIE_SKIP, TIE_SKIP + 1):
            batch = [_tie_read(70 + above, 70, 6),      # winner in tile 2
                     _tie_read(33 + above, 33, 3),
                     _tie_read(40, 40, 5),              # winner: newest j
                     _tie_read(above + 1, 1, 4)]
            arrays = pack_batch(batch, 128, 5000, avg_qspan=15)
            arrays[8][:] = -1
            arrays[7][:] = 0.0
            tie = dict(max_dist_x=5000, max_dist_y=2000, bw=2047 - 1)
            cases.append(dict(
                name=f"{mode} ties, {above} above the winner",
                anchors=batch, n_segs=n_segs, arrays=arrays,
                kw=dict(base, max_n=128, max_skip=TIE_SKIP, **tie),
                exact_host=False, flagged=above > TIE_SKIP))
        # exception patches that bite, on and off
        batch = [_diagonal(rng, 120, 7, 6, mode == "many_segs")
                 for _ in range(4)]
        for use_exc in (True, False):
            arrays = pack_batch(batch, 128, gaps[mode]["max_dist_x"])
            derived_none = bool((arrays[8][:, 0] < 0).all())
            arrays[8][0::2, 0:4] = (3, 7, 11, 0)
            cases.append(dict(
                name=f"{mode} exception patches use_exc={use_exc}",
                anchors=batch, n_segs=n_segs, arrays=arrays,
                kw=dict(base, max_n=128, use_exc=use_exc, **gaps[mode]),
                exact_host=not use_exc and derived_none))
    # windows over 512 candidates: cdna big gaps, dense anchors
    rng = np.random.default_rng(200)
    max_n = -(-wide_n // 128) * 128
    batch = []
    for n in (wide_n, wide_n - 37):
        rp = np.sort(rng.integers(0, 60 * n, n)) + 1000
        qp = np.maximum(rp // 30 + rng.integers(-200, 200, n), 0)
        batch.append(anchors_of(rp, qp, rng.integers(13, 20, n)))
    arrays = pack_batch(batch, max_n, 200000)
    assert int((np.arange(wide_n) - arrays[5][0, :wide_n]).max()) > \
        min(512, wide_n - 2)
    cases.append(dict(
        name=f"cdna wide windows n={wide_n}", anchors=batch, n_segs=1,
        arrays=arrays, exact_host=True,
        kw=dict(MODES["cdna"], max_n=max_n, max_dist_x=200000,
                max_dist_y=2000, bw=500, max_skip=25, use_exc=True)))
    return cases
