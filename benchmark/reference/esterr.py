# Frozen copy of minimap2_chaindp_tpu/esterr.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/esterr.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Per-region divergence estimate (reference esterr.c, exact float32 semantics)."""
from __future__ import annotations

import numpy as np

from . import constants as C


def _get_for_qpos(qlen: int, ax: int, ay: int) -> int:
    x = int(np.int32(np.uint64(ay) & np.uint64(0xFFFFFFFF)))
    q_span = (ay >> 32) & 0xFF
    if ax >> 63:
        x = qlen - 1 - (x + 1 - q_span)
    return x


def est_err(mi, qlen: int, regs, a: np.ndarray, mini_pos: np.ndarray) -> None:
    n = len(mini_pos)
    if n == 0:
        return
    sum_k = int((mini_pos >> np.uint64(32) & np.uint64(0xFF)).sum())
    avg_k = np.float32(sum_k) / np.float32(n)  # f32 division, esterr.c:39
    mp_lo = (mini_pos & np.uint64(0xFFFFFFFF)).astype(np.int64)
    from .nonative import est_err_merge
    ax = ay = None
    for r in regs:
        r.div = -1.0
        if r.cnt == 0:
            continue
        l_ref = mi.seqs[r.rid].length
        # anchor/minimizer merge loop: native scan when built (the float32
        # divergence arithmetic stays here for bit-exact dv:f output)
        if ax is None:
            ax = np.ascontiguousarray(a[:, 0])
            ay = np.ascontiguousarray(a[:, 1])
        nat = est_err_merge(ax, ay, r.as_, r.cnt, r.rev, qlen, mp_lo)
        if nat is not None:
            found, n_tot, n_match = nat
            if not found:
                continue
        else:
            k0 = r.as_ + r.cnt - 1 if r.rev else r.as_
            x = _get_for_qpos(qlen, int(a[k0, 0]), int(a[k0, 1]))
            # binary search into mini_pos (esterr.c:16-28)
            st = int(np.searchsorted(mp_lo, x))
            if st >= n or mp_lo[st] != x:
                continue
            en = st
            n_match = 1
            k = 1
            j = st + 1
            while j < n and k < r.cnt:
                ki = r.as_ + r.cnt - 1 - k if r.rev else r.as_ + k
                x = _get_for_qpos(qlen, int(a[ki, 0]), int(a[ki, 1]))
                if x == mp_lo[j]:
                    k += 1
                    en = j
                    n_match += 1
                j += 1
            n_tot = en - st + 1
        if r.qs > avg_k and r.rs > avg_k:
            n_tot += 1
        if qlen - r.qs > avg_k and l_ref - r.re > avg_k:
            n_tot += 1
        ratio = float(np.float32(np.float32(n_tot) / np.float32(n_match)))
        from .nonative import logf_native
        lg = logf_native(ratio)
        if lg is None:
            lg = float(np.log(np.float32(ratio)))
        r.div = float(np.float32(np.float32(lg) / avg_k))
