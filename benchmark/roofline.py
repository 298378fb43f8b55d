"""The least time the H100 could take for the work of each kernel launch the
window drives: the larger of its integer operations over the integer peak and
its bytes over the memory peak. The counts are of the algorithm (DP pairs in
each chain window, cells of each ksw2 band, steps of each backtrack walk),
worked out from each launch's inputs, so a redesigned kernel is judged on the
same work.

Frozen copy of chip_smoke.py:155-200 (the constants and the reasons for each
count) and of its `_bound` (:447-451), `chain_bound` (:454-470) and
`ksw_bounds` (:770-811) at commit 241cda7. The ksw2 counts are taken here from
the extension jobs and their results (query, target, band, flags, where the
DP z-dropped, the CIGAR) rather than from the port's packed launch arrays, so
they read nothing of the program's layout.
"""
from __future__ import annotations

import numpy as np

# published: NVIDIA's H100 SXM data sheet, 3.35 TB/s of HBM3
HBM_BYTES_S = 3.35e12
# derived: 132 SMs x 64 INT32 lanes x 1.98 GHz (the Hopper white paper's SM
# and the clock behind the sheet's 67 TFLOP/s of fp32), one operation a lane
# a cycle; not a published figure
INT32_OPS_S = 132 * 64 * 1.98e9
# Integer operations per unit of work (chip_smoke.py:161-195): a cell of the
# ksw2 recurrence on int8 lanes (extd2 55, exts2 47); 4 fewer where the job
# keeps no exact H row (approximate maximum); 16 (exts2 12) fewer where it
# keeps no origin and no flags (score only); a walk step 24; a candidate pair
# of the chaining recurrence 34 single-segment, 55 many-segment and cdna.
KSW_OPS_PER_CELL = {False: 55, True: 47}      # extd2, exts2
KSW_OPS_H_ROW = 4
KSW_OPS_CIGAR = {False: 16, True: 12}
WALK_OPS_PER_STEP = 24
CHAIN_OPS_PER_PAIR = {"single": 34, "many_segs": 55, "cdna": 55}
# ksw2.h's flags (minimap2 v2.10)
KSW_EZ_SCORE_ONLY = 0x01
KSW_EZ_APPROX_MAX = 0x08
# bytes of a job's fixed record in and its result row out
JOB_BYTES = 64


def least_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds: the larger of the bytes over the memory rate and
    the operations over the integer rate."""
    return max(n_bytes / HBM_BYTES_S, n_ops / INT32_OPS_S)


def chain_mode(is_cdna: bool, many_segs: bool) -> str:
    return "cdna" if is_cdna else ("many_segs" if many_segs else "single")


def chain_work(stw, nn, n_input_bytes: int, mode: str) -> tuple[int, int]:
    """(operations, bytes) of one chain launch: one unit of work per
    candidate pair (j in [stw[i], i) for each anchor i < n: the kernel
    scores the whole window), every input read once, f, p and flag written
    once (chip_smoke.chain_bound). stw (R, max_n) and nn (R, 1) may be
    torch tensors or numpy arrays."""
    stw = np.asarray(stw.cpu() if hasattr(stw, "cpu") else stw, np.int64)
    nn = np.asarray(nn.cpu() if hasattr(nn, "cpu") else nn,
                    np.int64)[:, 0]
    max_n = stw.shape[1]
    i = np.arange(max_n, dtype=np.int64)[None, :]
    live = i < nn[:, None]
    pairs = int(((i - np.maximum(stw, 0)) * live).sum())
    n_bytes = n_input_bytes + 2 * stw.size * 4 + nn.size * 4
    return pairs * CHAIN_OPS_PER_PAIR[mode], n_bytes


def ksw_work(jobs, results, splice: bool) -> tuple[int, int, int, int]:
    """(forward operations, forward bytes, walk operations, walk bytes) of
    one batch of extension jobs. Forward: the cells of the live band of
    every anti-diagonal a job computes (all of them, or up to its maximum
    where it z-dropped: the least it can have computed), each at the
    operations its job's mode needs; bytes: the query and target once (and
    a splice signal per target base), one backtrack byte per cell of a job
    with a CIGAR, a job's record and result. Walk: one step per cell of the
    CIGAR, one byte of backtrack in and one code out per step."""
    f_ops = f_bytes = steps = 0
    for job, ez in zip(jobs, results):
        ql, tl = len(job["qseq"]), len(job["tseq"])
        if ql <= 0 or tl <= 0:
            continue
        rows = ql + tl - 1
        if ez.zdropped:
            rows = min(rows, max(ez.max_t + ez.max_q + 1, 1))
        r = np.arange(rows, dtype=np.int64)
        st0 = np.maximum(0, r - ql + 1)
        en0 = np.minimum(tl - 1, r)
        if not splice:
            w = job["w"] if job["w"] >= 0 else max(ql, tl)
            st0 = np.maximum(st0, (r - w + 1) >> 1)
            en0 = np.minimum(en0, (r + w) >> 1)
        n = int(np.maximum(en0 - st0 + 1, 0).sum())
        per_cell = KSW_OPS_PER_CELL[splice]
        if job["flag"] & KSW_EZ_APPROX_MAX:
            per_cell -= KSW_OPS_H_ROW
        if job["flag"] & KSW_EZ_SCORE_ONLY:
            per_cell -= KSW_OPS_CIGAR[splice]
        else:
            f_bytes += n
            steps += sum(c >> 4 for c in ez.cigar)
        f_ops += n * per_cell
        f_bytes += ql + tl * (2 if splice else 1) + 2 * JOB_BYTES
    w_bytes = 2 * steps + 2 * JOB_BYTES * len(jobs)
    return f_ops, f_bytes, steps * WALK_OPS_PER_STEP, w_bytes
