"""The reference's minimizer index, built from the genome it is handed.

`MinimizerIndex` is a frozen copy of the JAX package's
minimap2_chaindp_tpu/index/build.py:27-92 (the fields and lookups the mapping
models read; the same lines in the port at commit 241cda7). `build_index` is new:
it sketches every contig with the (w,k)-minimizer automaton of the reference
sketch.c:77-143 (the golden model index/sketch.py:_sketch_py), run in lockstep
over many chunks of the genome at once with numpy, and sorts the minimizers
into the same CSR tables (key = x >> 8, each key's values sorted ascending,
index.c:352-394).

Why chunks give the exact output: the automaton's state after a position is
its buffer of the last w k-mers, the most recent smallest among them, and the
run of valid bases capped at w + k; each k-mer depends on the k bases before
it. So an automaton started afresh w + k + 1 positions before a chunk holds the
same state as the one run from the contig's start once it reaches the chunk,
and pushes the same minimizers from there on. Positions before a contig are
run as N (ambiguous) bases, which leave a fresh automaton as it is and push
nothing; the contig's last state pushes its minimum, as sketch.c:142 does.
Only odd k without homopolymer compression (every preset the benchmark runs):
an even k has symmetric k-mers, which the automaton skips without advancing.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX = np.uint64(0xFFFFFFFFFFFFFFFF)
CHUNK = 4096          # positions a chunk emits
GROUP = 16384         # chunks run in lockstep at once


@dataclass
class RefSeq:
    name: str
    offset: int
    length: int


@dataclass
class MinimizerIndex:
    k: int
    w: int
    flag: int
    b: int = 14
    seqs: list[RefSeq] = field(default_factory=list)
    S: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint8))
    keys: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    starts: np.ndarray = field(default_factory=lambda: np.zeros(1, np.int64))
    values: np.ndarray = field(default_factory=lambda: np.empty(0, np.uint64))
    name_rank: np.ndarray = field(default_factory=lambda: np.empty(0, np.int64))
    sorted_names: list[str] = field(default_factory=list)

    @property
    def n_seq(self) -> int:
        return len(self.seqs)

    @property
    def is_hpc(self) -> bool:
        return bool(self.flag & 1)

    def get(self, minier: int) -> np.ndarray:
        i = int(np.searchsorted(self.keys, np.uint64(minier)))
        if i >= len(self.keys) or self.keys[i] != np.uint64(minier):
            return self.values[0:0]
        return self.values[self.starts[i]:self.starts[i + 1]]

    def getseq(self, rid: int, st: int, en: int) -> np.ndarray:
        s = self.seqs[rid]
        en = min(en, s.length)
        return self.S[s.offset + st:s.offset + en]

    def cal_max_occ(self, f: float) -> int:
        return max_occ(np.diff(self.starts), f)


def max_occ(cnt: np.ndarray, f: float) -> int:
    """The occurrence-count quantile of the keys' counts `cnt`
    (index.c:307-328, index/build.py:72-78)."""
    if f <= 0.0 or len(cnt) == 0:
        return np.iinfo(np.int32).max
    cnt = cnt.astype(np.uint32)
    kk = int((1.0 - f) * len(cnt))
    return int(np.partition(cnt, kk)[kk]) + 1


def hash64_np(key: np.ndarray, mask: int) -> np.ndarray:
    """sketch.c:28-38 over uint64 arrays (constants.py:119-130)."""
    m = np.uint64(mask)
    key = ((~key + (key << np.uint64(21))) & m)
    key ^= key >> np.uint64(24)
    key = ((key + (key << np.uint64(3))) + (key << np.uint64(8))) & m
    key ^= key >> np.uint64(14)
    key = ((key + (key << np.uint64(2))) + (key << np.uint64(4))) & m
    key ^= key >> np.uint64(28)
    key = (key + (key << np.uint64(31))) & m
    return key


def _packed(c: np.ndarray, d: np.ndarray, k: int):
    """(forward, reverse) k-mers ending at each position (sketch.c:111-112):
    F[i] = sum c[i - j] << 2j and R[i] = sum d[i - j] << 2(k - 1 - j) over
    j < k, with bases before the start taken as 0. Built by doubling:
    F_(a+b)[i] = F_a[i] | F_b[i - a] << 2a, R_(a+b)[i] = R_a[i] << 2b |
    R_b[i - a]."""
    def join(fa, ra, a, fb, rb, b):
        f = fa.copy()
        m = max(len(fb) - a, 0)
        f[a:] |= fb[:m] << np.uint64(2 * a)
        r = ra << np.uint64(2 * b)
        r[a:] |= rb[:m]
        return f, r

    pows = [(c, d, 1)]
    while 2 * pows[-1][2] <= k:
        f, r, m = pows[-1]
        pows.append(join(f, r, m, f, r, m) + (2 * m,))
    f = r = None
    got = 0
    for fb, rb, m in reversed(pows):
        if got + m <= k:
            if f is None:
                f, r = fb, rb
            else:
                f, r = join(f, r, got, fb, rb, m)
            got += m
    return f, r


def kmer_infos(codes: np.ndarray, rid: int, k: int):
    """(x, y, run) of each position of one contig's nt4 codes: the k-mer
    ending there as sketch.c:111-116 encodes it (x = hash << 8 | k,
    y = rid << 32 | pos << 1 | strand), MAX where fewer than k valid bases
    end there; run is the count of valid bases ending there."""
    n = len(codes)
    valid = codes < 4
    c = np.where(valid, codes, 0).astype(np.uint64)
    fwd, rev = _packed(c, np.uint64(3) ^ c, k)
    if np.any(fwd == rev):
        raise NotImplementedError("symmetric k-mers (even k) are not "
                                  "modelled")
    z = (fwd > rev).astype(np.uint64)
    km = np.where(z == 1, rev, fwd)
    idx = np.arange(n, dtype=np.int64)
    last_bad = np.maximum.accumulate(np.where(valid, -1, idx))
    run = idx - last_bad
    x = (hash64_np(km, (1 << (2 * k)) - 1) << np.uint64(8)) | np.uint64(k)
    y = (np.uint64(rid) << np.uint64(32)) | (idx.astype(np.uint64)
                                              << np.uint64(1)) | z
    ok = run >= k
    x[~ok] = MAX
    y[~ok] = MAX
    return x, y, run


def _lockstep(X, Y, RUN, t_last, w, k, t0):
    """sketch.c:117-143 on every column of X, Y (steps x chunks) at once.
    RUN holds each step's run of valid bases as the chunk's fresh automaton
    counts it; t_last the step of a contig's last base (-1: none in this
    chunk), where the final minimum is pushed. What steps before t0 push
    belongs to the chunk before. Returns the pushed (x, y)."""
    T, nc = X.shape
    bx = np.full((w, nc), MAX, np.uint64)
    by = np.full((w, nc), MAX, np.uint64)
    mx = np.full(nc, MAX, np.uint64)
    my = np.full(nc, MAX, np.uint64)
    mpos = np.zeros(nc, np.int64)
    outx, outy = [], []

    def push(mask, xs, ys):
        if t >= t0 and mask.any():
            outx.append(xs[mask])
            outy.append(ys[mask])

    for t in range(T):
        bp = t % w
        ix, iy, l = X[t], Y[t], RUN[t]
        bx[bp] = ix
        by[bp] = iy
        have = mx != MAX
        first = have & (l == w + k - 1)
        if first.any():
            for j in list(range(bp + 1, w)) + list(range(bp)):
                push(first & (bx[j] == mx) & (by[j] != my), bx[j], by[j])
        new = ix <= mx
        push(new & (l >= w + k) & have, mx, my)
        out = ~new & (mpos == bp)
        push(out & (l >= w + k - 1) & have, mx, my)
        mx = np.where(new, ix, mx)
        my = np.where(new, iy, my)
        mpos = np.where(new, bp, mpos)
        if out.any():
            cols = np.flatnonzero(out)
            order = list(range(bp + 1, w)) + list(range(bp + 1))
            sx, sy = bx[order][:, cols], by[order][:, cols]
            # the last of the smallest in scan order (">=" in sketch.c:131)
            pick = len(order) - 1 - np.argmin(sx[::-1], axis=0)
            nx = sx[pick, np.arange(len(cols))]
            ny = sy[pick, np.arange(len(cols))]
            mx[cols], my[cols] = nx, ny
            mpos[cols] = np.asarray(order)[pick]
            tie = (l[cols] >= w + k - 1) & (nx != MAX)
            for r in range(len(order)):
                push(tie & (sx[r] == nx) & (sy[r] != ny), sx[r], sy[r])
        fin = t_last == t
        push(fin & (mx != MAX), mx, my)
    if not outx:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    return np.concatenate(outx), np.concatenate(outy)


def sketch_contigs(contigs: list[np.ndarray], w: int, k: int,
                   chunk: int = CHUNK, group: int = GROUP, rid0: int = 0):
    """Every minimizer of every contig (nt4 codes, rid = rid0 + list
    index), in no particular order: (x, y) uint64 arrays."""
    margin = w + k + 1
    T = chunk + margin
    xs, ys, runs, starts, lasts, owner = [], [], [], [], [], []
    base = 0
    for rid, codes in enumerate(contigs):
        n = len(codes)
        if n == 0:
            continue
        x, y, run = kmer_infos(codes, rid0 + rid, k)
        xs.append(x)
        ys.append(y)
        runs.append(run)
        for s in range(0, n, chunk):
            starts.append(base + s - margin)
            lasts.append(n - 1 - (s - margin) if s + chunk >= n else -1)
            owner.append((base, base + n))
        base += n
    if not xs:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    # one N-like slot at the end for the positions outside every contig
    X = np.concatenate(xs + [np.array([MAX])])
    Y = np.concatenate(ys + [np.array([MAX])])
    RUNS = np.concatenate(runs + [np.array([0])])
    pad = len(X) - 1
    starts = np.asarray(starts, np.int64)
    lasts = np.asarray(lasts, np.int64)
    lo = np.asarray([o[0] for o in owner], np.int64)
    hi = np.asarray([o[1] for o in owner], np.int64)
    outx, outy = [], []
    steps = np.arange(T, dtype=np.int64)[:, None]
    for g in range(0, len(starts), group):
        st, gl, gh = starts[g:g + group], lo[g:g + group], hi[g:g + group]
        pos = st[None, :] + steps
        inside = (pos >= gl[None, :]) & (pos < gh[None, :])
        gidx = np.where(inside, pos, pad)
        # the fresh automaton counts valid bases from the chunk's start only
        run = np.minimum(RUNS[gidx], steps + 1 - np.maximum(
            gl - st, 0)[None, :])
        run = np.where(inside, np.maximum(run, 0), 0)
        px, py = _lockstep(X[gidx], Y[gidx], run, lasts[g:g + group], w, k,
                            margin)
        outx.append(px)
        outy.append(py)
    return np.concatenate(outx), np.concatenate(outy)


def build_index(names: list[str], contigs: list[np.ndarray], w: int, k: int,
                flag: int = 0, bucket_bits: int = 14) -> MinimizerIndex:
    """The CSR index of the contigs (nt4 codes), as the port's build_index
    makes it (index/build.py:104-270): keys ascending, each key's values
    ascending, the reference's 4-bit sequence in S, the name-rank tables."""
    if flag & 1:
        raise NotImplementedError("homopolymer-compressed k-mers are not "
                                  "modelled")
    mi = MinimizerIndex(k=k, w=w, flag=flag, b=bucket_bits)
    off = 0
    for name, c in zip(names, contigs):
        mi.seqs.append(RefSeq(name=name, offset=off, length=len(c)))
        off += len(c)
    mi.S = np.concatenate(contigs) if contigs else np.empty(0, np.uint8)
    x, y = sketch_contigs(contigs, w, k)
    key = x >> np.uint64(8)
    order = np.lexsort((y, key))
    key, val = key[order], y[order]
    if len(key):
        neq = np.empty(len(key), bool)
        neq[0] = True
        np.not_equal(key[1:], key[:-1], out=neq[1:])
        st = np.flatnonzero(neq)
        mi.keys = key[st]
        mi.starts = np.concatenate([st, [len(val)]]).astype(np.int64)
        mi.values = val
    srt = sorted(range(len(names)), key=lambda i: names[i])
    mi.sorted_names = [names[i] for i in srt]
    rank = np.empty(len(names), np.int64)
    rank[np.asarray(srt, np.int64)] = np.arange(len(names), dtype=np.int64)
    mi.name_rank = rank
    return mi
