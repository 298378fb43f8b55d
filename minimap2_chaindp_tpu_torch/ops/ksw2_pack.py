"""Host half of the ksw2 extension kernels: column layouts, job packing and
the decode of the backtrack walk.

The constants, `_pow2_at_least`, `_ez_from_row` and `_decode_walk` are
copied from minimap2_chaindp_tpu/ops/ksw2_pallas.py (that module imports
jax at :28, so it cannot be imported here); each names its origin, and
`_decode_walk` decodes through `_decode_cigar`, which keeps the
interpreter lock.
`pack_jobs` is the port's own: it lays every job's sequences and state out
back to back (ragged, one offset per job) instead of the TPU's padded
16-job groups, and each job's backtrack bytes go straight into the
reference's flat layout (row stride `n_col`, ksw2_extd2_sse.c:98-100), so
the spill aliasing that `ksw2_pallas._p_flat_c_layout` replays falls out of
the write order and is not needed here.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np

from . import ksw2 as K

# ---- copied from minimap2_chaindp_tpu/ops/ksw2_pallas.py:42-57
# scal_ref column assignments (per-job scalar state carried across diagonals)
# C_BX1/C_BX21/C_BV1 cache the raw previous-row x/x2/v at lane st(r)-1 so no
# separate extraction pass is needed (writes never touch lanes < st, so the
# cache stays valid while st is unchanged and is refreshed when st advances)
C_LAST_ST, C_LAST_EN, C_MAX, C_MAX_T, C_MAX_Q, C_MQE, C_MQE_T, C_MTE, \
    C_MTE_Q, C_SCORE, C_ZDROP, C_DONE, C_H0, C_H0T, C_BX1, C_BX21, \
    C_BV1 = range(17)

# meta column assignments (per-job static inputs); EXTZ/SCONLY/ENDB feed the
# fused on-chip backtrack's walk-start decision (mm_align's ksw_backtrack
# entry conditions, align.c / ksw2.h:119)
M_QLEN, M_TLEN, M_W, M_ZDROP, M_RIGHT, M_APPROX, M_ADROP, M_EXTZ, \
    M_SCONLY, M_ENDB = range(10)

# ez_ref fin columns written by the fused walk (beyond the scal C_* range)
C_FIN_I, C_FIN_J, C_FIN_K = 20, 21, 22
# ---- end of the copy

# the port's own meta columns: the C row stride of the job's backtrack
# bytes (0 for score-only jobs), the offsets of its target/state, reversed
# query and walk step codes in the ragged buffers, the lanes its DP rows
# need on chip (the widest aligned band plus the score block tail), and the
# job's splice-signal flags (SPLICE_BITS of its flag in exts2 waves, 0 in
# extd2 waves), which the signal kernel reads
M_NCOL, M_TOFF, M_QOFF, M_OPOFF, M_LANES, M_SPLICE = range(10, 16)
META_COLS = 16
SPLICE_BITS = K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV | K.KSW_EZ_SPLICE_FLANK
EZ_COLS = 24          # C_* state columns and the walk's fin (i, j, k)
T_PAD = 32            # per-job target/state slack past tlen16 (s[] blocks)
Q_PAD = 16            # per-job reversed-query slack (16-lane score loads)

# forward-kernel variants (csrc/ksw2.cu), chosen by the power-of-two ring of
# lanes that holds a job's rows: a block per job with the rows in shared
# memory, or, past the 16384 lanes of 14 bytes that one block's shared
# memory (227 KB) holds, a block per job with the rows in device memory.
VARIANTS = ("block", "global")
RING_MIN = 64
SMEM_RING_MAX = 16384
MAX_THREADS = 512     # forward block size cap


def _pow2_at_least(x, lo):
    """Copied from minimap2_chaindp_tpu/ops/ksw2_pallas.py:831-835."""
    v = lo
    while v < x:
        v *= 2
    return v


def _ez_from_row(ez_row) -> "K.Ez":
    """Copied from minimap2_chaindp_tpu/ops/ksw2_pallas.py:838-849."""
    res = K.Ez()
    res.zdropped = int(ez_row[C_ZDROP])
    res.max = int(ez_row[C_MAX])
    res.max_t = int(ez_row[C_MAX_T])
    res.max_q = int(ez_row[C_MAX_Q])
    res.mqe = int(ez_row[C_MQE])
    res.mqe_t = int(ez_row[C_MQE_T])
    res.mte = int(ez_row[C_MTE])
    res.mte_q = int(ez_row[C_MTE_Q])
    res.score = int(ez_row[C_SCORE])
    return res


@functools.cache
def _held_decode():
    """The native library's mm2tpu_decode_cigar through a handle that keeps
    the interpreter lock (ctypes.PyDLL), or None without the library. A
    call takes microseconds; one that lets the lock go (native.py's CDLL
    handle) waits on its return for the other batch thread's switch
    interval whenever that thread runs Python, and a wave makes one call
    a job."""
    from .. import native
    lib = native.load_align()
    if lib is None:
        return None
    fn = ctypes.PyDLL(native._AL_SO).mm2tpu_decode_cigar
    fn.restype = lib.mm2tpu_decode_cigar.restype
    fn.argtypes = lib.mm2tpu_decode_cigar.argtypes
    return fn


def _decode_cigar(ops, n_ops, fin_i, fin_j, is_rev, min_intron_len=0):
    """ksw2_backtrack.decode_cigar, its native call made through
    `_held_decode`."""
    fn = _held_decode() if n_ops else None
    if fn is None:
        from .ksw2_backtrack import decode_cigar
        return decode_cigar(ops, n_ops, fin_i, fin_j, is_rev, min_intron_len)
    o = np.ascontiguousarray(ops[:n_ops], dtype=np.int8)
    out = np.empty(n_ops + 2, dtype=np.uint32)
    n = fn(o.__array_interface__["data"][0], n_ops, fin_i, fin_j,
           1 if is_rev else 0, min_intron_len,
           out.__array_interface__["data"][0])
    return out[:n].tolist()


def _decode_walk(jobs, out, ez_h, ops_h, *, splice, long_thres):
    """Host decode of the fused walk's step codes: mirrors the kernel's
    walk-start decision (same ez inputs, so deterministic agreement), then
    run-length encodes the codes into each ez.cigar.

    Copied from minimap2_chaindp_tpu/ops/ksw2_pallas.py:852-873, the
    CIGAR through `_decode_cigar`."""
    for j, (job, res) in enumerate(zip(jobs, out)):
        flag = job["flag"]
        if flag & K.KSW_EZ_SCORE_ONLY:
            continue
        if not splice and not res.zdropped and (flag & K.KSW_EZ_EXTZ_ONLY) \
                and res.mqe + job["end_bonus"] > res.max:
            res.reach_end = 1
        elif not res.zdropped and not (flag & K.KSW_EZ_EXTZ_ONLY):
            pass
        elif res.max_t >= 0 and res.max_q >= 0:
            pass
        else:
            continue
        rev = bool(flag & K.KSW_EZ_REV_CIGAR)
        res.cigar = _decode_cigar(
            ops_h[j], int(ez_h[j, C_FIN_K]), int(ez_h[j, C_FIN_I]),
            int(ez_h[j, C_FIN_J]), rev, long_thres if splice else 0)


def ring_of(lanes):
    """Lanes of the on-chip ring that holds a job's rows: the power of two
    at or above `lanes` (meta[M_LANES]), at least RING_MIN; on an array of
    lanes, the array of rings."""
    lanes = np.asarray(lanes, dtype=np.int64)
    ring = np.full(lanes.shape, RING_MIN, dtype=np.int64)
    while (ring < lanes).any():
        ring = np.where(ring < lanes, 2 * ring, ring)
    return int(ring) if ring.ndim == 0 else ring


def variant_of(lanes: int) -> str:
    """The forward-kernel variant a job of `lanes` row lanes takes."""
    return "block" if ring_of(lanes) <= SMEM_RING_MAX else "global"


def block_threads(ring: int) -> int:
    """Block size of a block-per-job launch: half a ring (a band fills
    between half its ring and all of it, less the slack), 64 to
    MAX_THREADS."""
    return min(MAX_THREADS, max(64, ring // 2))


def launch_plan(meta: np.ndarray, force: str | None = None):
    """Cut a call's jobs into forward-kernel launches and order each
    longest first (rows = qlen + tlen - 1, descending, ties in the caller's
    order). Returns (order, groups): `order` int32 lists meta rows, the
    groups' jobs back to back and then every job once more, longest first,
    for the walk (its last len(meta) entries); each group is a
    dict(variant, ring, threads, start, count) over a slice of `order`.
    Groups, at most two: the jobs whose ring exceeds shared memory are one
    device-memory launch, the others one shared-memory launch with the
    ring of the widest. The launch waits for its longest job, and a second
    launch that shares that job's SM slows it, so small jobs ride along in
    the wide launch. Results are written at each job's own row, so nothing
    is permuted back. `force` puts every job into one group of that
    variant, and raises where a job's ring does not fit."""
    R = len(meta)
    rows = meta[:, M_QLEN].astype(np.int64) + meta[:, M_TLEN] - 1
    by_len = np.argsort(-rows, kind="stable").astype(np.int32)
    rings = ring_of(meta[:, M_LANES])
    if force is not None:
        if force not in VARIANTS:
            raise ValueError(f"unknown forward variant {force!r}")
        top = int(rings.max()) if R else RING_MIN
        if force == "block" and top > SMEM_RING_MAX:
            raise ValueError(f"a job needs a ring of {top} lanes; shared "
                             f"memory holds {SMEM_RING_MAX}")
        parts = [(force, np.ones(R, dtype=bool))]
    else:
        on_chip = rings <= SMEM_RING_MAX
        parts = [("global", ~on_chip),   # the longest chains first
                 ("block", on_chip)]
    order, groups = [], []
    for variant, mask in parts:
        idx = by_len[mask[by_len]]
        if not len(idx):
            continue
        ring = int(rings[idx].max())
        threads = block_threads(ring) if variant == "block" else min(
            MAX_THREADS, _pow2_at_least(int(meta[idx, M_LANES].max()), 64))
        groups.append(dict(variant=variant, ring=ring, threads=threads,
                           start=sum(map(len, order)), count=len(idx)))
        order.append(idx)
    order.append(by_len)
    return np.concatenate(order).astype(np.int32), groups


def gap_params(q, e, q2, e2, splice):
    """Scoring constants of one launch: (q, e, q2, e2, long_thres,
    long_diff). extd2 swaps the two gap profiles when the second is cheaper
    (ksw2_pallas.plan_batch :788-790) and derives the long-gap crossover as
    at :920-926; exts2 has no second deletion profile (:1030-1033)."""
    if splice:
        long_thres = (q2 - q) // e - 1
        if q2 > q + e + long_thres * e:
            long_thres += 1
        return q, e, q2, 0, long_thres, long_thres * e - (q2 - q)
    if q2 + e2 < q + e:
        q, q2 = q2, q
        e, e2 = e2, e
    long_thres = (q2 - q) // (e - e2) - 1 if e != e2 else 0
    if q2 + e2 + long_thres * e2 > q + e + long_thres * e:
        long_thres += 1
    return q, e, q2, e2, long_thres, long_thres * (e - e2) - (q2 - q) - e2


def n_col_of(qlen, tlen, w, splice: bool):
    """Row stride of the reference's flat backtrack bytes: extd2
    ksw2_extd2_sse.c:98-100 (as ksw2_pallas.py:989), exts2 :96 (as :1098).
    Every aligned band fits in one row, so rows never overlap. Takes
    numbers or arrays of them."""
    if splice:
        return (np.minimum(qlen, tlen) + 15) // 16 * 16 + 16
    return ((np.minimum(np.minimum(qlen, tlen), w + 1) + 15) // 16 + 1) * 16


def donor_acceptor(target: np.ndarray, noncan: int, flag: int):
    """Donor and acceptor splice-signal arrays (reference
    ksw2_exts2_sse.c:112-131): the same int8 arrays of length tlen16 as
    ops/ksw2_splice.make_donor_acceptor, computed with whole-array numpy
    compares instead of its per-base Python loops. One target at a time:
    the model that ksw2_ext.splice_signal (the card's kernel and its
    plain version, which compute every job of a wave at once) is held
    to."""
    tlen = len(target)
    tlen16 = (tlen + 15) // 16 * 16
    donor = np.zeros(tlen16, dtype=np.int8)
    acceptor = np.zeros(tlen16, dtype=np.int8)
    fwd, rev = flag & K.KSW_EZ_SPLICE_FOR, flag & K.KSW_EZ_SPLICE_REV
    if not (fwd or rev):
        return donor, acceptor
    semi = int(-noncan / 2) if flag & K.KSW_EZ_SPLICE_FLANK else 0
    donor[:] = -noncan
    acceptor[:] = -noncan
    n = tlen - 4
    if n > 0:   # donor at t: GT.. (forward) or CT.. (reverse) at t+1
        s1, s2, s3 = target[1:n + 1], target[2:n + 2], target[3:n + 3]
        can = np.zeros(n, dtype=bool)
        if fwd:
            can |= (s1 == 2) & (s2 == 3)
        if rev:
            can |= (s1 == 1) & (s2 == 3)
        flank = can & ((s3 == 0) | (s3 == 2))
        donor[:n] = np.where(flank, 0, np.where(can, semi, donor[:n]))
    if tlen > 2:   # acceptor at t: ..AG (forward) or ..AC (reverse)
        s0, s1, s2 = target[2:], target[1:-1], target[:-2]
        can = np.zeros(tlen - 2, dtype=bool)
        if fwd:
            can |= (s1 == 0) & (s0 == 2)
        if rev:
            can |= (s1 == 0) & (s0 == 1)
        flank = can & ((s2 == 1) | (s2 == 3))
        acceptor[2:tlen] = np.where(flank, 0, np.where(
            can, semi, acceptor[2:tlen]))
    return donor, acceptor


def _job_fields(jobs, splice: bool):
    """The fields of a wave's jobs that the pack reads, one int64 array
    each: (qlen, tlen, flag, w), w the band the kernels run (the longer
    side under splice or where the job's w < 0)."""
    R = len(jobs)
    qlen = np.fromiter((len(j["qseq"]) for j in jobs), np.int64, R)
    tlen = np.fromiter((len(j["tseq"]) for j in jobs), np.int64, R)
    flag = np.fromiter((j["flag"] for j in jobs), np.int64, R)
    w = np.maximum(qlen, tlen)
    if not splice:
        w_job = np.fromiter((j["w"] for j in jobs), np.int64, R)
        w = np.where(w_job < 0, w, w_job)
    return qlen, tlen, flag, w


def _p_sizes(qlen, tlen, flag, w, splice: bool):
    """(n_col, backtrack bytes) of each job: no bytes for score-only."""
    ncol = n_col_of(qlen, tlen, w, splice)
    return ncol, np.where(flag & K.KSW_EZ_SCORE_ONLY, 0,
                          (qlen + tlen - 1) * ncol)


def pack_jobs(jobs, *, splice: bool, noncan: int = 0):
    """Per-job kernel inputs, ragged: returns a dict of numpy arrays
    - tseq uint8 (T,): each job's target at meta[M_TOFF], zero-padded to
      tlen16 + T_PAD (the offsets also place the job's DP state rows);
    - qrev uint8 (Q,): each job's query reversed at meta[M_QOFF],
      zero-padded by Q_PAD;
    - meta int32 (R, META_COLS): the M_* columns of ksw2_pallas.py:937-953
      and :1046-1065 plus the port's stride, offsets and splice flags;
    - poff int64 (R,): each job's first byte in the flat backtrack buffer;
    - order int32: `launch_plan`'s job order, with its `groups`;
    plus p_bytes, ops_total (walk step-code capacity), t_total, band_max
    (widest aligned band plus the score block tail, in lanes), rows_max
    and noncan (the wave's, 0 for extd2). The splice signal is not packed:
    ksw2_ext.splice_signal computes it on the device from tseq and meta.
    Every array is filled for the whole wave at once; jobs need qlen >= 1
    and tlen >= 1, and the offsets of the whole wave have to fit int32
    (ValueError otherwise)."""
    R = len(jobs)
    qlen, tlen, flag, w = _job_fields(jobs, splice)
    if R and (qlen.min() < 1 or tlen.min() < 1):
        raise ValueError("pack_jobs needs non-empty query and target")
    tsz = (tlen + 15) // 16 * 16 + T_PAD
    toff = np.cumsum(tsz) - tsz
    qsz = qlen + Q_PAD
    qoff = np.cumsum(qsz) - qsz
    nrows = qlen + tlen - 1
    opoff = np.cumsum(nrows + 1) - (nrows + 1)
    if max(int(tsz.sum()), int(qsz.sum()), int((nrows + 1).sum())) >= 2**31:
        raise ValueError("a launch's offsets pass int32: split the wave")
    # each sequence and its zero pad, back to back, in one copy
    zeros = np.zeros(T_PAD + 15, dtype=np.uint8)
    tseq = np.concatenate([x for j, pad in zip(jobs, (tsz - tlen).tolist())
                           for x in (j["tseq"], zeros[:pad])]
                          or [zeros[:0]]).astype(np.uint8, copy=False)
    qrev = np.concatenate([x for j in jobs
                           for x in (j["qseq"][::-1], zeros[:Q_PAD])]
                          or [zeros[:0]]).astype(np.uint8, copy=False)
    ncol, p_sz = _p_sizes(qlen, tlen, flag, w, splice)
    sconly = (flag & K.KSW_EZ_SCORE_ONLY) != 0
    meta = np.zeros((R, META_COLS), dtype=np.int32)
    meta[:, M_QLEN] = qlen
    meta[:, M_TLEN] = tlen
    meta[:, M_W] = w
    meta[:, M_ZDROP] = np.fromiter((j["zdrop"] for j in jobs), np.int64, R)
    for c, bit in ((M_RIGHT, K.KSW_EZ_RIGHT), (M_APPROX, K.KSW_EZ_APPROX_MAX),
                   (M_ADROP, K.KSW_EZ_APPROX_DROP),
                   (M_EXTZ, K.KSW_EZ_EXTZ_ONLY),
                   (M_SCONLY, K.KSW_EZ_SCORE_ONLY)):
        meta[:, c] = (flag & bit) != 0
    if not splice:
        meta[:, M_ENDB] = np.fromiter((j["end_bonus"] for j in jobs),
                                      np.int64, R)
    meta[:, M_NCOL] = np.where(sconly, 0, ncol)
    meta[:, M_TOFF] = toff
    meta[:, M_QOFF] = qoff
    meta[:, M_OPOFF] = opoff
    meta[:, M_LANES] = ncol + 16
    if splice:
        meta[:, M_SPLICE] = flag & SPLICE_BITS
    poff = np.cumsum(p_sz) - p_sz
    order, groups = launch_plan(meta)
    return dict(tseq=tseq, qrev=qrev, meta=meta, poff=poff,
                order=order, groups=groups, p_bytes=int(p_sz.sum()),
                ops_total=int((nrows + 1).sum()),
                t_total=int(tsz.sum()),
                band_max=int(ncol.max()) + 16 if R else 0,
                rows_max=int(nrows.max()) if R else 0,
                noncan=noncan if splice else 0)


def split_by_budget(jobs, splice: bool, budget: int) -> list[list[int]]:
    """Cut a wave into launches whose backtrack bytes stay within `budget`
    (a job larger than the budget gets a launch of its own), each a list
    of indices into `jobs`. The jobs are taken longest first (rows,
    descending; ties in the wave's order): a launch waits for its longest
    job, and a wave's launches run one after another, so the long jobs
    share the first launch instead of each holding up one of its own."""
    qlen, tlen, flag, w = _job_fields(jobs, splice)
    sizes = _p_sizes(qlen, tlen, flag, w, splice)[1]
    groups, cur, used = [], [], 0
    for i in np.argsort(-(qlen + tlen), kind="stable").tolist():
        b = int(sizes[i])
        if cur and used + b > budget:
            groups.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += b
    if cur:
        groups.append(cur)
    return groups
