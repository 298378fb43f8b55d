# Frozen copy of minimap2_chaindp_tpu/sdust.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/sdust.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Symmetric DUST low-complexity masker (Morgulis et al., 2006).

Behavioral equivalent of the reference's sdust.c (sdust_core, sdust.c:134-166)
and the query-minimizer masking hook mm_dust_minier (reference map.c:61-85),
enabled with `-T` / `sdust_thres`.

The algorithm scans the sequence with a window of up to W bases, tracking
3-mer ("word") counts.  A window suffix is *perfect* when its DUST score —
sum over words w of count(w)*(count(w)-1)/2, divided by (suffix_len - 1) —
exceeds T/10 and is no lower than the score of every contained or containing
perfect suffix.  Reported intervals are unions of overlapping perfect
intervals, emitted once they fall out of the sliding window.

This is a host-side preprocessing step (per-read O(len) with tiny constants),
so it stays NumPy/CPython; the downstream minimizer filter is vectorized.
"""
from __future__ import annotations

import numpy as np

WLEN = 3
WTOT = 1 << (2 * WLEN)
WMSK = WTOT - 1

_NT4 = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    _NT4[ord(_c)] = _i
    _NT4[ord(_c.lower())] = _i


class _State:
    __slots__ = ("w", "P", "res", "L", "rw", "rv", "cw", "cv")

    def __init__(self):
        self.w: list[int] = []     # word deque for the current window
        # perfect intervals (start, finish, r, l), sorted by descending start
        # then ascending finish
        self.P: list[list[int]] = []
        self.res: list[tuple[int, int]] = []
        self.L = 0                 # length of the scored window suffix
        self.rw = 0                # running score of the whole window
        self.rv = 0                # running score of the suffix
        self.cw = [0] * WTOT       # word counts, whole window
        self.cv = [0] * WTOT       # word counts, suffix


def _save_masked(st: _State, start: int) -> None:
    """Emit perfect intervals that start before `start` (fell out of window),
    merging overlapping/adjacent ones into the last reported region."""
    P, res = st.P, st.res
    if not P or P[-1][0] >= start:
        return
    p_start, p_finish = P[-1][0], P[-1][1]
    if res and p_start <= res[-1][1]:
        s, f = res[-1]
        res[-1] = (s, max(f, p_finish))
    else:
        res.append((p_start, p_finish))
    i = len(P) - 1
    while i >= 0 and P[i][0] < start:
        i -= 1
    del P[i + 1:]


def _shift_window(st: _State, t: int, T: int, W: int) -> None:
    w = st.w
    if len(w) >= W - WLEN + 1:
        s = w.pop(0)
        st.cw[s] -= 1
        st.rw -= st.cw[s]
        if st.L > len(w):
            st.L -= 1
            st.cv[s] -= 1
            st.rv -= st.cv[s]
    w.append(t)
    st.L += 1
    st.rw += st.cw[t]
    st.cw[t] += 1
    st.rv += st.cv[t]
    st.cv[t] += 1
    if st.cv[t] * 10 > 2 * T:
        # drop the suffix up to (and including) the previous occurrence of t
        while True:
            s = w[len(w) - st.L]
            st.cv[s] -= 1
            st.rv -= st.cv[s]
            st.L -= 1
            if s == t:
                break


def _find_perfect(st: _State, T: int, start: int) -> None:
    """Extend the scored suffix leftwards one word at a time; record every
    suffix that is perfect (score above T/10 and >= all contained perfect
    intervals), keeping P sorted by descending start / ascending finish."""
    c = st.cv[:]
    r = st.rv
    w, P = st.w, st.P
    max_r = max_l = 0
    for i in range(len(w) - st.L - 1, -1, -1):
        t = w[i]
        r += c[t]
        c[t] += 1
        new_l = len(w) - i - 1
        if r * 10 > T * new_l:
            j = 0
            while j < len(P) and P[j][0] >= i + start:
                p = P[j]
                if max_r == 0 or p[2] * max_l > max_r * p[3]:
                    max_r, max_l = p[2], p[3]
                j += 1
            if max_r == 0 or r * max_l >= max_r * new_l:
                max_r, max_l = r, new_l
                P.insert(j, [i + start, len(w) + WLEN - 1 + start, r, new_l])


def sdust(seq, T: int = 20, W: int = 64) -> list[tuple[int, int]]:
    """Return low-complexity intervals [(start, end)) of `seq` (str or bytes).
    Matches the reference sdust_core(seq, len, T, W) output exactly."""
    if isinstance(seq, str):
        seq = seq.encode()
    b4 = _NT4[np.frombuffer(seq, dtype=np.uint8)]
    from .nonative import sdust_native
    nat = sdust_native(b4, T, W)
    if nat is not None:
        return nat
    st = _State()
    l = t = 0
    n = len(b4)
    for i in range(n + 1):
        b = int(b4[i]) if i < n else 4
        if b < 4:
            l += 1
            t = (t << 2 | b) & WMSK
            if l >= WLEN:
                start = max(l - W, 0) + (i + 1 - l)
                _save_masked(st, start)
                _shift_window(st, t, T, W)
                if st.rw * 10 > st.L * T:
                    _find_perfect(st, T, start)
        else:
            # N (or end) flushes pending perfect intervals; NB the reference
            # resets only (l, t) here — window word counts persist across the
            # break (sdust.c:156-159) — reproduced for exactness
            start = max(l - W + 1, 0) + (i + 1 - l)
            while st.P:
                _save_masked(st, start)
                start += 1
            l = t = 0
    return st.res


def dust_mask_minimizers(mv: np.ndarray, seq: str, sdust_thres: int) -> np.ndarray:
    """Drop query minimizers whose k-mer span overlaps low-complexity regions
    by more than half (reference mm_dust_minier, map.c:61-85).

    mv: (n, 2) uint64 minimizer array in the sketch encoding
    (x = hash<<8|span, y = rid<<32|pos<<1|strand)."""
    if sdust_thres <= 0 or len(mv) == 0:
        return mv
    dregs = sdust(seq, sdust_thres, 64)
    if not dregs:
        return mv
    span = (mv[:, 0] & 0xFF).astype(np.int64)
    qpos = ((mv[:, 1] & 0xFFFFFFFF) >> 1).astype(np.int64)
    s = qpos - (span - 1)
    e = s + span
    ds = np.array([d[0] for d in dregs], dtype=np.int64)
    de = np.array([d[1] for d in dregs], dtype=np.int64)
    # overlap length of each minimizer with each LCR (few LCRs per read)
    ov = np.zeros(len(mv), dtype=np.int64)
    for k in range(len(ds)):
        ov += np.clip(np.minimum(e, de[k]) - np.maximum(s, ds[k]), 0, None)
    return mv[ov <= span >> 1]


def main(argv=None) -> int:
    """Standalone masker CLI (reference sdust.c:_SDUST_MAIN): prints
    `name<TAB>start<TAB>end` per masked interval."""
    import argparse
    from .io.fastx import read_fastx

    ap = argparse.ArgumentParser(prog="sdust")
    ap.add_argument("-w", type=int, default=64, dest="W")
    ap.add_argument("-t", type=int, default=20, dest="T")
    ap.add_argument("fasta")
    ns = ap.parse_args(argv)
    for rec in read_fastx(ns.fasta):
        for s, e in sdust(rec.seq, ns.T, ns.W):
            print(f"{rec.name}\t{s}\t{e}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
