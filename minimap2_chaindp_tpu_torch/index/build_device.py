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

The default build stays on the native host path (index/build.py); this
one runs under `build_index(device=...)` or MM2TPU_DEVICE_INDEX=1. There
is no fallback: a device that cannot run the sort raises.
"""
from __future__ import annotations

import numpy as np
import torch

_SIGN64 = np.uint64(1 << 63)


def _to_ordered(u64: np.ndarray) -> np.ndarray:
    """u64 -> int64 whose signed order equals the unsigned u64 order."""
    return (np.ascontiguousarray(u64, dtype=np.uint64) ^ _SIGN64) \
        .view(np.int64)


def _from_ordered(i64: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(i64).view(np.uint64) ^ _SIGN64


def build_csr_device(mvs: list[np.ndarray], device="cuda"):
    """Sorted CSR tables (keys u64, starts int64, values u64) from
    per-contig minimizer arrays ((n, 2) u64), with the pair sort and the
    run-start pass on `device`."""
    mv = np.concatenate(mvs, axis=0) if mvs \
        else np.empty((0, 2), dtype=np.uint64)
    if len(mv) == 0:
        return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.empty(0, np.uint64))
    dev = torch.device(device)
    key = torch.from_numpy(_to_ordered(mv[:, 0] >> np.uint64(8))).to(dev)
    val = torch.from_numpy(_to_ordered(mv[:, 1])).to(dev)
    # lexicographic (key, value): the minor key first, then a stable sort
    # by the major key keeps each key's values in order
    order = torch.sort(val, stable=True).indices
    key, val = key[order], val[order]
    order = torch.sort(key, stable=True).indices
    key, val = key[order], val[order]
    neq = torch.ones(len(key), dtype=torch.bool, device=dev)
    torch.ne(key[1:], key[:-1], out=neq[1:])
    starts = torch.nonzero(neq).squeeze(1)
    keys = key[starts]
    starts = np.concatenate([starts.cpu().numpy(), [len(val)]]) \
        .astype(np.int64)
    return (_from_ordered(keys.cpu().numpy()), starts,
            _from_ordered(val.cpu().numpy()))
