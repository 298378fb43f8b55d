# Frozen copy of minimap2_chaindp_tpu/ops/ksw2_backtrack.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/ops/ksw2_backtrack.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Host-side decode for the on-chip CIGAR backtrack.

The backtrack walk itself is FUSED into the forward ksw2 kernel
(ops/ksw2_pallas._fused_walk, run on the forward grid's last row-block per
group): shipping the full backtrack-byte matrix p to the host costs
O(rows × band) bytes per job — the dominant cost on transfer-limited
links — so the kernel walks the ksw_backtrack state machine (ksw2.h:119-151)
ON the TPU, reading p in row stripes DMA'd HBM→VMEM on demand through the C
kernel's FLAT layout semantics (row stride n_col with row-tail spill
aliasing, see ops/ksw2_pallas._p_flat_c_layout), and ships only O(rows)
step codes per job.  The walk-start corner is decided in-kernel from the
just-computed ez state; the host mirrors that decision
(ksw2_pallas._decode_walk) and run-length encodes the codes here.

Validated against the host backtrack on identical p bytes
(tests/test_ksw2_backtrack.py)."""
from __future__ import annotations

import numpy as np


def decode_cigar(ops, n_ops, fin_i, fin_j, is_rev, min_intron_len=0):
    """Run-length encode the device step codes into a CIGAR
    (tail + reverse conventions of ksw_backtrack, ksw2.h:137-150);
    vectorized — the walks are thousands of steps per job."""
    from .ksw2 import _push_cigar
    if n_ops:
        from ..nonative import decode_cigar_native
        res = decode_cigar_native(ops, n_ops, fin_i, fin_j, is_rev,
                                  min_intron_len)
        if res is not None:
            return res
    cigar: list[int] = []
    if n_ops:
        st = ops[:n_ops].astype(np.int64)
        # ksw2.h:137-143 state machine: 0 -> M; 1 (and 3 without splice)
        # -> D; 3 with splice -> N; everything ELSE (2 = insertion, 4 =
        # second-affine long-gap insertion) -> I. State 4 only occurs in
        # dual-affine extd2 (splice has no second gap profile).
        op = np.where(st == 0, 0,
                      np.where((st == 2) | (st == 4), 1,
                               np.where(st == 1, 2,
                                        3 if min_intron_len > 0 else 2)))
        cut = np.nonzero(np.diff(op))[0] + 1
        starts = np.concatenate([[0], cut])
        ends = np.concatenate([cut, [n_ops]])
        cigar = list(((ends - starts) << 4 | op[starts]).astype(np.int64))
        cigar = [int(v) for v in cigar]
    if fin_i >= 0:
        _push_cigar(cigar, 3 if (min_intron_len > 0
                                 and fin_i >= min_intron_len) else 2,
                    fin_i + 1)
    if fin_j >= 0:
        _push_cigar(cigar, 1, fin_j + 1)
    if not is_rev:
        cigar.reverse()
    return cigar
