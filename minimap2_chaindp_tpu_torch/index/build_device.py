"""The index CSR built with the minimizer pair sort on a torch device.

Port of minimap2_chaindp_tpu/index/build_device.py:40-74. The JAX package
sorts the (key, value) pairs with one 4-key `jax.lax.sort` over split,
biased u32 halves and finds the run starts in a host pass. XLA did that
sort, not a Pallas kernel, so this port uses the stock `torch.sort`.
PyTorch has no u64 sort: each u64 maps to the int64 whose signed order is
the unsigned order (the sign bit flipped, the bits viewed as int64), and
the pairs sort lexicographically by two stable sorts, by value and then by
key. Equal pairs are interchangeable, so the result equals the host
build's np.lexsort exactly. The run starts are found on the device too;
keys, starts and values come back as the host build's numpy arrays.

The pairs go to the device one per-contig array at a time, into int64
key and value tables allocated there once: the host never concatenates
them nor makes a whole-table copy, so it holds the pair set once (the
caller's arrays: 561.5M pairs, 8.98 GB, at 3 Gbp). The device holds the
two tables, and during each sort its sorted copy and int64 order.

The default build stays on the native host path (index/build.py); this
one runs under `build_index(device=...)` or MM2TPU_DEVICE_INDEX=1. There
is no fallback: a device that cannot run the sort raises.
"""
from __future__ import annotations

import numpy as np
import torch

_SIGN64 = np.uint64(1 << 63)
# a u64 key is the minimizer's (hash << 8 | span) shifted right by 8: the
# int64 shift is arithmetic, so the top byte is masked off
_KEY_MASK = (1 << 56) - 1
_SIGN_I64 = -(1 << 63)


def _from_ordered(i64: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(i64).view(np.uint64) ^ _SIGN64


def build_csr_device(mvs: list[np.ndarray], device="cuda"):
    """Sorted CSR tables (keys u64, starts int64, values u64) from
    per-contig minimizer arrays ((n, 2) u64), with the pair sort and the
    run-start pass on `device`."""
    n = sum(len(m) for m in mvs)
    if n == 0:
        return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.empty(0, np.uint64))
    dev = torch.device(device)
    # each u64 as the int64 whose signed order is its unsigned order (the
    # sign bit flipped)
    key = torch.empty(n, dtype=torch.int64, device=dev)
    val = torch.empty(n, dtype=torch.int64, device=dev)
    off = 0
    for m in mvs:
        if len(m):
            t = torch.from_numpy(
                np.ascontiguousarray(m, dtype=np.uint64).view(np.int64)
            ).to(dev)
            key[off:off + len(m)] = ((t[:, 0] >> 8) & _KEY_MASK) ^ _SIGN_I64
            val[off:off + len(m)] = t[:, 1] ^ _SIGN_I64
            off += len(m)
    # lexicographic (key, value): the minor key first, then a stable sort
    # by the major key keeps each key's values in order
    val, order = torch.sort(val, stable=True)
    key = key[order]
    del order
    key, order = torch.sort(key, stable=True)
    val = val[order]
    del order
    neq = torch.ones(len(key), dtype=torch.bool, device=dev)
    torch.ne(key[1:], key[:-1], out=neq[1:])
    starts = torch.nonzero(neq).squeeze(1)
    keys = key[starts]
    del key, neq
    starts = np.concatenate([starts.cpu().numpy(), [n]]).astype(np.int64)
    return (_from_ordered(keys.cpu().numpy()), starts,
            _from_ordered(val.cpu().numpy()))
