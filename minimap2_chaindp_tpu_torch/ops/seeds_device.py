"""Device seed-hit collection in PyTorch: the CSR index tables as device
tensors and the H2D-slim collect of the fused flow.

Port of minimap2_chaindp_tpu/ops/seeds_device.py (`DeviceIndex` :72-93,
`device_index_cached` :57-69, `_collect_dev_pos` :194-253, `_rep_len`
:380-395); the split-key helpers wait for the key-path collect. The
collect is stock torch ops (gathers, cumsum, a batched searchsorted and a
stable sort), as the JAX package left it to XLA; it matches
ops/seeds.collect_seed_hits anchor for anchor.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import constants as C

SIGN = -0x80000000            # int32 sign bit
PAD_HI = 0x7FFFFFFF           # sort-key high half of padded slots


class DeviceIndex:
    """The CSR tables the collect reads, as int32 tensors on `device`:
    `starts` (n_keys + 1) and the values split into `vhi`/`vlo`. The key
    table stays on the host, which looks up key positions itself."""

    def __init__(self, mi, device):
        vhi = (mi.values >> np.uint64(32)).astype(np.int64).astype(np.int32)
        vlo = (mi.values & np.uint64(0xFFFFFFFF)).astype(np.int64) \
            .astype(np.int32)
        self._upload(mi.starts.astype(np.int32), vhi, vlo, device)

    @classmethod
    def from_arrays(cls, starts, vhi, vlo, device) -> "DeviceIndex":
        """Tables given as int32 arrays, e.g. the JAX package's
        `DeviceIndex` tables converted with np.asarray."""
        dx = cls.__new__(cls)
        dx._upload(starts, vhi, vlo, device)
        return dx

    def _upload(self, starts, vhi, vlo, device):
        as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.int32),
                                      device=device)
        self.starts, self.vhi, self.vlo = as_t(starts), as_t(vhi), as_t(vlo)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.starts, self.vhi, self.vlo))


def index_fingerprint(mi) -> str:
    """Content fingerprint of an index: a strided sample of keys, starts
    and values (about 4096 entries each) with their lengths, hashed. A
    fresh load of the same index maps to the same tables; a different
    index of the same size differs in its sampled content."""
    h = hashlib.sha256()
    for a in (mi.keys, mi.starts, mi.values):
        a = np.asarray(a)
        h.update(str((a.dtype.str, len(a))).encode())
        if len(a):
            step = max(1, len(a) // 4096)
            h.update(np.ascontiguousarray(a[::step]).tobytes())
            h.update(np.ascontiguousarray(a[-1:]).tobytes())
    return h.hexdigest()


_DEVICE_INDEX_CACHE: dict = {}


def device_key(device) -> str:
    """One name per card: "cuda" resolves to "cuda:<current device>", so
    "cuda" and "cuda:0" share a cache entry."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def device_index_cached(mi, device) -> DeviceIndex:
    """Process-level DeviceIndex reuse keyed by (content fingerprint,
    device_key); at most 2 live entries, so an old genome's tables free
    when evicted."""
    key = (index_fingerprint(mi), device_key(device))
    dx = _DEVICE_INDEX_CACHE.get(key)
    if dx is None:
        dx = DeviceIndex(mi, device)
        if len(_DEVICE_INDEX_CACHE) >= 2:
            _DEVICE_INDEX_CACHE.pop(next(iter(_DEVICE_INDEX_CACHE)))
        _DEVICE_INDEX_CACHE[key] = dx
    return dx


def _collect_dev_pos(starts, vhi, vlo, qposidx, qpos, qspan, qseg, qtandem,
                     max_occ, qlen_sum, *, cap):
    """CSR expansion, anchor encoding and the stable x-sort for a padded
    batch. q* inputs are (R, M) tensors: qposidx the CSR key position of
    each minimizer (-1 = absent), qpos (any int dtype), qspan, qseg,
    qtandem int32; qlen_sum (R, 1). Returns (xhi, xlo, yhi, ylo) sorted by
    x, each (R, cap) int32, plus total (R,), cnt and over (R, M). Indices
    are clamped exactly where the JAX version clamps them."""
    R, M = qposidx.shape
    dev = qposidx.device
    i32 = torch.int32
    found = qposidx >= 0
    pos_c = qposidx.clamp(min=0).long()
    cnt = torch.where(found, starts[pos_c + 1] - starts[pos_c], 0)
    over = found & (cnt >= max_occ)
    keep = found & ~over
    occ = torch.where(keep, cnt, 0)

    cum = torch.cumsum(occ, dim=1)                       # int64
    total = cum[:, -1]
    slot = torch.arange(cap, dtype=cum.dtype, device=dev)[None, :] \
        .expand(R, cap).contiguous()
    midx = torch.searchsorted(cum.contiguous(), slot, right=True)
    midx_c = midx.clamp(max=M - 1)
    cum_prev = torch.where(
        midx_c > 0, torch.gather(cum, 1, (midx_c - 1).clamp(min=0)), 0)
    within = slot - cum_prev
    live = slot < total[:, None]
    vidx = torch.gather(starts[pos_c].long(), 1, midx_c) + within
    vidx = vidx.clamp(0, vhi.shape[0] - 1)
    rid = vhi[vidx]
    rlo = vlo[vidx]   # raw low-32 bit pattern (pos<<1|strand)
    rpos = (rlo >> 1) & 0x7FFFFFFF
    rstrand = rlo & 1

    qp = torch.gather(qpos, 1, midx_c).to(i32)
    qsp = torch.gather(qspan, 1, midx_c).to(i32)
    sid = torch.gather(qseg, 1, midx_c).to(i32)
    tnd = torch.gather(qtandem, 1, midx_c)
    fwd = rstrand == (qp & 1)

    # anchor encoding (map.c:216-229); xhi carries rev in the sign bit
    xhi = torch.where(fwd, rid, rid ^ SIGN)
    xlo = rpos
    qpos_out = torch.where(fwd, qp >> 1,
                           qlen_sum - ((qp >> 1) + 1 - qsp) - 1).to(i32)
    yhi = qsp | torch.where(tnd != 0, C.MM_SEED_TANDEM >> 32, 0).to(i32) \
        | (sid << (C.MM_SEED_SEG_SHIFT - 32))
    ylo = qpos_out

    # stable sort by x == (xhi unsigned, xlo): bias xhi for a signed
    # compare, pack (sk_hi, sk_lo) into one int64 key; pads sort last
    sk_hi = torch.where(live, xhi ^ SIGN, PAD_HI)
    key = (sk_hi.long() << 32) | (xlo.long() & 0xFFFFFFFF)
    order = torch.sort(key, dim=1, stable=True).indices
    xhi, xlo, yhi, ylo = (torch.gather(v, 1, order)
                          for v in (xhi, xlo, yhi, ylo))
    return xhi, xlo, yhi, ylo, total.to(i32), cnt.to(i32), over


def _rep_len(mv, over):
    """Repetitive-region length from over-occurring minimizers (map.c:119-141).

    Copied verbatim from minimap2_chaindp_tpu/ops/seeds_device.py:380-395."""
    q_pos = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    q_span = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
    rep_len = 0
    rep_st = rep_en = 0
    for i in np.nonzero(over)[0]:
        en = (q_pos[i] >> 1) + 1
        st = en - q_span[i]
        if st > rep_en:
            rep_len += rep_en - rep_st
            rep_st, rep_en = st, en
        else:
            rep_en = en
    rep_len += rep_en - rep_st
    return int(rep_len)
