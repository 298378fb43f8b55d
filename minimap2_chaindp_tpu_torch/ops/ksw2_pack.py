"""Host half of the ksw2 extension kernels: column layouts, job packing and
the decode of the backtrack walk.

The constants, `_pow2_at_least`, `_ez_from_row` and `_decode_walk` are
copied verbatim from minimap2_chaindp_tpu/ops/ksw2_pallas.py (that module
imports jax at :28, so it cannot be imported here); each names its origin.
`pack_jobs` is the port's own: it lays every job's sequences and state out
back to back (ragged, one offset per job) instead of the TPU's padded
16-job groups, and each job's backtrack bytes go straight into the
reference's flat layout (row stride `n_col`, ksw2_extd2_sse.c:98-100), so
the spill aliasing that `ksw2_pallas._p_flat_c_layout` replays falls out of
the write order and is not needed here.
"""
from __future__ import annotations

import numpy as np

from minimap2_chaindp_tpu.ops import ksw2 as K

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
# bytes (0 for score-only jobs) and the offsets of its target/state,
# reversed query and walk step codes in the ragged buffers
M_NCOL, M_TOFF, M_QOFF, M_OPOFF = range(10, 14)
META_COLS = 16
EZ_COLS = 24          # C_* state columns and the walk's fin (i, j, k)
T_PAD = 32            # per-job target/state slack past tlen16 (s[] blocks)
Q_PAD = 16            # per-job reversed-query slack (16-lane score loads)


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


def _decode_walk(jobs, out, ez_h, ops_h, *, splice, long_thres):
    """Host decode of the fused walk's step codes: mirrors the kernel's
    walk-start decision (same ez inputs, so deterministic agreement), then
    run-length encodes the codes into each ez.cigar.

    Copied from minimap2_chaindp_tpu/ops/ksw2_pallas.py:852-873."""
    from minimap2_chaindp_tpu.ops.ksw2_backtrack import decode_cigar
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
        res.cigar = decode_cigar(
            ops_h[j], int(ez_h[j, C_FIN_K]), int(ez_h[j, C_FIN_I]),
            int(ez_h[j, C_FIN_J]), rev, long_thres if splice else 0)


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


def n_col_of(qlen: int, tlen: int, w: int, splice: bool) -> int:
    """Row stride of the reference's flat backtrack bytes: extd2
    ksw2_extd2_sse.c:98-100 (as ksw2_pallas.py:989), exts2 :96 (as :1098).
    Every aligned band fits in one row, so rows never overlap."""
    if splice:
        return (min(qlen, tlen) + 15) // 16 * 16 + 16
    return ((min(qlen, tlen, w + 1) + 15) // 16 + 1) * 16


def donor_acceptor(target: np.ndarray, noncan: int, flag: int):
    """Donor and acceptor splice-signal arrays (reference
    ksw2_exts2_sse.c:112-131): the same int8 arrays of length tlen16 as
    ops/ksw2_splice.make_donor_acceptor, computed with whole-array numpy
    compares instead of its per-base Python loops, which made it the
    largest host cost of a splice wave."""
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


def pack_jobs(jobs, *, splice: bool, noncan: int = 0):
    """Per-job kernel inputs, ragged: returns a dict of numpy arrays
    - tseq uint8 (T,): each job's target at meta[M_TOFF], zero-padded to
      tlen16 + T_PAD (the offsets also place the job's DP state rows);
    - qrev uint8 (Q,): each job's query reversed at meta[M_QOFF],
      zero-padded by Q_PAD;
    - dac int16 (T,): splice donor (low byte) and acceptor (high byte)
      signals (`donor_acceptor`), packed as ksw2_pallas.py:1053-1055
      (zero for extd2);
    - meta int32 (R, META_COLS): the M_* columns of ksw2_pallas.py:937-953
      and :1046-1065 plus the port's stride and offsets;
    - poff int64 (R,): each job's first byte in the flat backtrack buffer;
    plus p_bytes, ops_total (walk step-code capacity), t_total, band_max
    (widest aligned band plus the score block tail, in lanes) and rows_max.
    Jobs need qlen >= 1 and tlen >= 1."""
    R = len(jobs)
    qlen = np.array([len(j["qseq"]) for j in jobs], dtype=np.int64)
    tlen = np.array([len(j["tseq"]) for j in jobs], dtype=np.int64)
    if R and (qlen.min() < 1 or tlen.min() < 1):
        raise ValueError("pack_jobs needs non-empty query and target")
    tsz = (tlen + 15) // 16 * 16 + T_PAD
    toff = np.cumsum(tsz) - tsz
    qsz = qlen + Q_PAD
    qoff = np.cumsum(qsz) - qsz
    nrows = qlen + tlen - 1
    opoff = np.cumsum(nrows + 1) - (nrows + 1)
    meta = np.zeros((R, META_COLS), dtype=np.int32)
    tseq = np.zeros(int(tsz.sum()), dtype=np.uint8)
    qrev = np.zeros(int(qsz.sum()), dtype=np.uint8)
    dac = np.zeros(int(tsz.sum()), dtype=np.int16)
    poff = np.zeros(R, dtype=np.int64)
    p_bytes = band_max = 0
    for j, job in enumerate(jobs):
        qs, ts = job["qseq"], job["tseq"]
        ql, tl = len(qs), len(ts)
        to, qo = int(toff[j]), int(qoff[j])
        tseq[to:to + tl] = ts
        qrev[qo:qo + ql] = qs[::-1]
        flag = job["flag"]
        w = max(ql, tl) if splice or job["w"] < 0 else job["w"]
        if splice:
            donor, acceptor = donor_acceptor(ts, noncan, flag)
            dac[to:to + len(donor)] = ((donor.astype(np.int16) & 0xFF)
                                       | ((acceptor.astype(np.int16) & 0xFF)
                                          << 8))
        ncol = n_col_of(ql, tl, w, splice)
        band_max = max(band_max, ncol + 16)
        sconly = bool(flag & K.KSW_EZ_SCORE_ONLY)
        meta[j, M_QLEN] = ql
        meta[j, M_TLEN] = tl
        meta[j, M_W] = w
        meta[j, M_ZDROP] = job["zdrop"]
        meta[j, M_RIGHT] = 1 if flag & K.KSW_EZ_RIGHT else 0
        meta[j, M_APPROX] = 1 if flag & K.KSW_EZ_APPROX_MAX else 0
        meta[j, M_ADROP] = 1 if flag & K.KSW_EZ_APPROX_DROP else 0
        meta[j, M_EXTZ] = 1 if flag & K.KSW_EZ_EXTZ_ONLY else 0
        meta[j, M_SCONLY] = 1 if sconly else 0
        meta[j, M_ENDB] = 0 if splice else job["end_bonus"]
        meta[j, M_NCOL] = 0 if sconly else ncol
        meta[j, M_TOFF] = to
        meta[j, M_QOFF] = qo
        meta[j, M_OPOFF] = int(opoff[j])
        poff[j] = p_bytes
        if not sconly:
            p_bytes += (ql + tl - 1) * ncol
    return dict(tseq=tseq, qrev=qrev, dac=dac, meta=meta, poff=poff,
                p_bytes=p_bytes, ops_total=int((nrows + 1).sum()),
                t_total=int(tsz.sum()), band_max=band_max,
                rows_max=int(nrows.max()) if R else 0)


def p_bytes_of(job, splice: bool) -> int:
    """Backtrack bytes one job needs (0 for score-only jobs)."""
    if job["flag"] & K.KSW_EZ_SCORE_ONLY:
        return 0
    ql, tl = len(job["qseq"]), len(job["tseq"])
    w = max(ql, tl) if splice or job["w"] < 0 else job["w"]
    return (ql + tl - 1) * n_col_of(ql, tl, w, splice)


def split_by_budget(jobs, splice: bool, budget: int) -> list[list[int]]:
    """Cut a wave into launches whose backtrack bytes stay within `budget`
    (a job larger than the budget gets a launch of its own)."""
    groups, cur, used = [], [], 0
    for i, job in enumerate(jobs):
        b = p_bytes_of(job, splice)
        if cur and used + b > budget:
            groups.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += b
    if cur:
        groups.append(cur)
    return groups
