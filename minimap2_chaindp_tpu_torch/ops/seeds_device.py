"""Device seed-hit collection in PyTorch: the CSR index tables as device
tensors, the H2D-slim collect of the fused flow and the key path of the
staged units.

Port of minimap2_chaindp_tpu/ops/seeds_device.py (`split_u64` :33,
`DeviceIndex` :72-93, `device_index_cached` :57-69, `_collect_dev` :97-192
without the index-sharded psum, `_collect_dev_pos` :194-253,
`DeviceSeedCollector` :305-378, `_rep_len` :380-395). The collects are
stock torch ops (gathers, cumsum, a lexicographic binary search, a batched
searchsorted and a stable sort): the JAX package left this code to XLA and
wrote no Pallas kernel for it, so the port writes no CUDA kernel either.
Both match ops/seeds.collect_seed_hits anchor for anchor.
"""
from __future__ import annotations

import hashlib
import threading

import numpy as np
import torch

from .. import constants as C

SIGN = -0x80000000            # int32 sign bit
PAD_HI = 0x7FFFFFFF           # sort-key high half of padded slots
BIAS = np.int64(0x80000000)   # maps u32 order onto i32 order


def split_u64(v: np.ndarray):
    """u64 -> (hi, lo) int32 with the *hi/lo bias* applied so that signed
    (hi, lo) lexicographic order equals unsigned u64 order."""
    hi = ((v >> np.uint64(32)).astype(np.int64) - BIAS).astype(np.int32)
    lo = ((v & np.uint64(0xFFFFFFFF)).astype(np.int64) - BIAS).astype(np.int32)
    return hi, lo


class DeviceIndex:
    """The CSR tables the collect reads, as int32 tensors on `device`:
    `starts` (n_keys + 1) and the values split into `vhi`/`vlo`. The flow
    looks up key positions on the host; the split key tables `khi`/`klo`
    that the key path searches are uploaded on its first `key_tables()`
    call, so a run that never collects by key never holds them."""

    def __init__(self, mi, device):
        vhi = (mi.values >> np.uint64(32)).astype(np.int64).astype(np.int32)
        vlo = (mi.values & np.uint64(0xFFFFFFFF)).astype(np.int64) \
            .astype(np.int32)
        self._upload(mi.starts.astype(np.int32), vhi, vlo, device, mi.keys)

    @classmethod
    def from_arrays(cls, starts, vhi, vlo, device,
                    keys=None) -> "DeviceIndex":
        """Tables given as int32 arrays, e.g. the JAX package's
        `DeviceIndex` tables converted with np.asarray; `keys` (the sorted
        u64 key table) only where the key path will run."""
        dx = cls.__new__(cls)
        dx._upload(starts, vhi, vlo, device, keys)
        return dx

    def _upload(self, starts, vhi, vlo, device, keys):
        as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.int32),
                                      device=device)
        self.starts, self.vhi, self.vlo = as_t(starts), as_t(vhi), as_t(vlo)
        self.n_keys = len(starts) - 1
        self._keys, self._device = keys, device
        self.khi = self.klo = None
        self._key_lock = threading.Lock()

    def key_tables(self):
        """(khi, klo): the biased split keys on the device, uploaded once."""
        if self.khi is None:
            with self._key_lock:
                if self.khi is None:
                    khi, klo = split_u64(np.asarray(self._keys,
                                                    dtype=np.uint64))
                    self.klo = torch.from_numpy(klo).to(self._device)
                    self.khi = torch.from_numpy(khi).to(self._device)
        return self.khi, self.klo

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.starts, self.vhi, self.vlo, self.khi,
                             self.klo) if t is not None)


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
    return _expand(starts, vhi, vlo, qposidx >= 0, qposidx.clamp(min=0),
                   qpos, qspan, qseg, qtandem, max_occ, qlen_sum, cap)


def _collect_dev(khi, klo, starts, vhi, vlo, qhi, qlo, qvalid, qpos, qspan,
                 qseg, qtandem, max_occ, qlen_sum, *, cap):
    """The key path: each query key is found by a lexicographic binary
    search (searchsorted-left) over the biased split keys khi/klo (n_keys,)
    int32, with the JAX version's fixed step count; then the expansion of
    _collect_dev_pos. q* inputs are (R, M) tensors (qhi/qlo split keys,
    qvalid bool, the rest int32); returns what _collect_dev_pos returns."""
    K = khi.shape[0]
    R, M = qhi.shape
    if K == 0:
        raise ValueError("the key path needs a non-empty index")
    lo = torch.zeros((R, M), dtype=torch.int64, device=qhi.device)
    hi = torch.full((R, M), K, dtype=torch.int64, device=qhi.device)
    for _ in range(max(int(np.ceil(np.log2(max(K, 2)))) + 1, 1)):
        mid = (lo + hi) >> 1
        mid_c = mid.clamp(max=K - 1)   # the JAX gather clamps at K - 1
        mh, ml = khi[mid_c], klo[mid_c]
        less = (mh < qhi) | ((mh == qhi) & (ml < qlo))
        lo, hi = torch.where(less, mid + 1, lo), torch.where(less, hi, mid)
    pos_c = lo.clamp(max=K - 1)
    found = qvalid & (khi[pos_c] == qhi) & (klo[pos_c] == qlo)
    return _expand(starts, vhi, vlo, found, pos_c, qpos, qspan, qseg,
                   qtandem, max_occ, qlen_sum, cap)


def _expand(starts, vhi, vlo, found, pos_c, qpos, qspan, qseg, qtandem,
            max_occ, qlen_sum, cap):
    """The collect after the key search: counts and over-occurrence
    masking (map.c:119-141), CSR expansion into `cap` slots, the anchor
    encoding (map.c:216-229) and the stable x-sort."""
    R, M = found.shape
    dev = found.device
    i32 = torch.int32
    pos_c = pos_c.long()
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


KEY_QUERY = ("qhi", "qlo", "qvalid", "qpos", "qspan", "qseg", "qtnd")


def key_queries(mvs: list, qlen_sums: list, m: int) -> dict:
    """The key path's inputs for reads of at most `m` minimizers, padded to
    (len(mvs), m): the biased split keys qhi/qlo, qvalid, qpos, qspan,
    qseg, qtnd (a key equal to a neighbour's), and qls (R, 1)."""
    R = len(mvs)
    q = dict(qhi=np.full((R, m), 0x7FFFFFFF, np.int32),
             qlo=np.zeros((R, m), np.int32), qvalid=np.zeros((R, m), bool),
             qpos=np.zeros((R, m), np.int32), qspan=np.zeros((R, m), np.int32),
             qseg=np.zeros((R, m), np.int32), qtnd=np.zeros((R, m), np.int32),
             qls=np.zeros((R, 1), np.int32))
    for r, mv in enumerate(mvs):
        n = len(mv)
        key = mv[:, 0] >> np.uint64(8)
        q["qhi"][r, :n], q["qlo"][r, :n] = split_u64(key)
        q["qvalid"][r, :n] = True
        q["qpos"][r, :n] = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
        q["qspan"][r, :n] = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
        q["qseg"][r, :n] = (mv[:, 1] >> np.uint64(32)).astype(np.int64)
        if n > 1:
            same = key[1:] == key[:-1]
            q["qtnd"][r, :n - 1] |= same
            q["qtnd"][r, 1:n] |= same
        q["qls"][r, 0] = qlen_sums[r]
    return q


class DeviceSeedCollector:
    """Batched seed collection by key on `device` with host assembly of
    SeedHits (the JAX DeviceSeedCollector). Reads are grouped by
    minimizer-count bucket (`m_bucket`); a read with no minimizers, more
    than the last bucket holds or more than `cap` anchors gets None, and
    the caller collects it on the host. Rows are not padded to powers of
    two: that bounded the XLA compiles and changes no row's result."""

    def __init__(self, mi, device, cap: int = 8192,
                 m_bucket: tuple = (256, 1024, 4096)):
        self.mi = mi
        self.dx = device_index_cached(mi, device)
        self.device = torch.device(device)
        self.cap = cap
        self.m_bucket = m_bucket

    def collect_batch(self, mvs: list, max_occ: int, qlen_sums: list):
        """mvs: per-read minimizer arrays ((n, 2) u64). Returns a list of
        SeedHits-or-None (None = collect on the host)."""
        from .seeds import SeedHits, mini_pos_of
        out = [None] * len(mvs)
        if self.dx.n_keys == 0:
            return out
        khi, klo = self.dx.key_tables()
        by_m: dict[int, list[int]] = {}
        for i, mv in enumerate(mvs):
            b = next((b for b in self.m_bucket if len(mv) <= b), None)
            if b is not None and len(mv) > 0:
                by_m.setdefault(b, []).append(i)
        for m, idxs in sorted(by_m.items()):
            q = key_queries([mvs[i] for i in idxs],
                            [qlen_sums[i] for i in idxs], m)
            xhi, xlo, yhi, ylo, total, _cnt, over = _collect_dev(
                khi, klo, self.dx.starts, self.dx.vhi, self.dx.vlo,
                *(torch.from_numpy(q[k]).to(self.device) for k in KEY_QUERY),
                max_occ, torch.from_numpy(q["qls"]).to(self.device),
                cap=self.cap)
            total = total.cpu().numpy()
            # only the live columns come back
            w = int(min(total.max(), self.cap))
            xhi, xlo, yhi, ylo = (v[:, :w].cpu().numpy()
                                  for v in (xhi, xlo, yhi, ylo))
            over = over.cpu().numpy()
            for r, i in enumerate(idxs):
                t = int(total[r])
                if t > self.cap:
                    continue  # overflow -> host collect
                mv = mvs[i]
                x = ((xhi[r, :t].astype(np.int64) & 0xFFFFFFFF)
                     .astype(np.uint64) << np.uint64(32)) \
                    | xlo[r, :t].astype(np.uint64)
                y = ((yhi[r, :t].astype(np.int64) & 0xFFFFFFFF)
                     .astype(np.uint64) << np.uint64(32)) \
                    | ylo[r, :t].astype(np.uint64)
                ov = over[r, :len(mv)]
                out[i] = SeedHits(np.stack([x, y], axis=1),
                                  _rep_len(mv, ov), mini_pos_of(mv, ~ov))
        return out


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
