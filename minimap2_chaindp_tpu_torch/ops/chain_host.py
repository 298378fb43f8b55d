"""Host-side numpy helpers around the chaining kernel: anchor splitting and
the exact reconstruction of the compact offload arrays from f/p/v.

Copied verbatim from minimap2_chaindp_tpu/ops/chain_jax.py:144-185
(`split_anchors`, `compact_from_fpv`) and
minimap2_chaindp_tpu/models/device_flow.py:558-563 (`_v_from_fp`); both
modules import jax, so they cannot be imported here.
"""
from __future__ import annotations

import numpy as np

from .. import constants as C


def split_anchors(anchors: np.ndarray):
    """64-bit (x, y) anchors -> int32 component arrays."""
    x, y = anchors[:, 0], anchors[:, 1]
    xhi = (x >> np.uint64(32)).astype(np.int64).astype(np.int32)
    rpos = (x & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    qpos = (y & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    span = ((y >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int32)
    sid = ((y & np.uint64(C.MM_SEED_SEG_MASK)) >> np.uint64(C.MM_SEED_SEG_SHIFT)).astype(np.int32)
    return xhi, rpos, qpos, span, sid


def compact_from_fpv(anchors: np.ndarray, f: np.ndarray, p: np.ndarray,
                     v: np.ndarray, min_sc: int):
    """Rebuild the offload-contract compact arrays from f/p/v, exactly as
    chain.c:286-316 does per iteration."""
    n = len(anchors)
    fpga_id = np.full(n, -1, dtype=np.int64)
    cseed_x: list[int] = []
    cseed_y: list[int] = []
    cf: list[int] = []
    cp: list[int] = []
    ax, ay = anchors[:, 0], anchors[:, 1]
    for i in range(n):
        max_j = int(p[i])
        if max_j >= 0 and fpga_id[max_j] == -1:
            cseed_x.append(int(ax[max_j]))
            cseed_y.append(int(ay[max_j]))
            cf.append(int(f[max_j]))
            cp.append((-1 << 2) | (1 if v[max_j] >= min_sc else 0)
                      | ((1 if f[max_j] < v[max_j] else 0) << 1))
            fpga_id[max_j] = len(cp) - 1
        alive = v[i] >= min_sc
        if alive or max_j >= 0:
            cseed_x.append(int(ax[i]))
            cseed_y.append(int(ay[i]))
            cf.append(int(f[i]))
            pred = int(fpga_id[max_j]) if max_j >= 0 else -1
            cp.append((pred << 2) | (1 if alive else 0)
                      | ((1 if f[i] < v[i] else 0) << 1))
            fpga_id[i] = len(cp) - 1
    return (np.array(cseed_x, dtype=np.uint64), np.array(cseed_y, dtype=np.uint64),
            cf, cp)


def _v_from_fp(f: np.ndarray, p: np.ndarray) -> np.ndarray:
    v = np.zeros(len(f), dtype=np.int64)
    for i in range(len(f)):
        pi = p[i]
        v[i] = v[pi] if pi >= 0 and v[pi] > f[i] else f[i]
    return v
