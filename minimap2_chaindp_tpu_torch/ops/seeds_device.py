"""Device seed-hit collection in PyTorch: the CSR index tables as device
tensors, the H2D-slim collect of the fused flow and the key path of the
staged units.

Port of minimap2_chaindp_tpu/ops/seeds_device.py (`split_u64` :33,
`DeviceIndex` :72-93, `device_index_cached` :57-69, `_collect_dev` :97-192
with the index-sharded combine over a mesh group in place of each psum,
`_collect_dev_pos` :194-253, `shard_index_tables` :256-302,
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
# the device tables address keys and positions with int32
INT32_MAX = 2**31 - 1
# elements a step of the tables' upload: 256 MiB of int64 staging
UPLOAD_CHUNK = 1 << 25


def check_int32_tables(n_keys: int, n_positions: int,
                       what: str = "index") -> None:
    """Raise ValueError unless an index of `n_keys` keys and `n_positions`
    positions fits the device tables, which hold key positions and value
    offsets as int32: neither may pass 2^31 - 1."""
    if n_keys > INT32_MAX or n_positions > INT32_MAX:
        raise ValueError(
            f"{what}: {n_keys} keys and {n_positions} positions; the device "
            f"tables index both as int32, so neither may pass 2^31 - 1 = "
            f"{INT32_MAX} (split the index with -I)")


def _hi32(x):
    return (x >> 32).to(torch.int32)


def _lo32(x):
    lo = x & 0xFFFFFFFF
    return (lo - ((lo >> 31) << 32)).to(torch.int32)


def upload_int32(a: np.ndarray, device, parts) -> list:
    """int32 tensors on `device` made from the 64-bit array `a` chunk by
    chunk: each output is one function of `parts` applied to the chunk as
    int64 on the device. The host stages one chunk at a time (pinned for a
    card) and makes no int64 or int32 copy of the whole array, which may be
    an index's mmap'd table."""
    dev = torch.device(device)
    a = np.asarray(a)
    a64 = (a if a.dtype.itemsize == 8 else a.astype(np.int64)).view(np.int64)
    n = len(a64)
    outs = [torch.empty(n, dtype=torch.int32, device=dev) for _ in parts]
    step = max(1, min(n, UPLOAD_CHUNK))
    stage = torch.empty(step, dtype=torch.int64,
                        pin_memory=dev.type == "cuda")
    stage_np = stage.numpy()
    for lo in range(0, n, step):
        hi = min(n, lo + step)
        stage_np[:hi - lo] = a64[lo:hi]
        x = stage[:hi - lo].to(dev)     # from pinned memory: synchronous
        for out, fn in zip(outs, parts):
            out[lo:hi] = fn(x)
    return outs


def split_u64(v: np.ndarray):
    """u64 -> (hi, lo) int32 with the *hi/lo bias* applied so that signed
    (hi, lo) lexicographic order equals unsigned u64 order."""
    hi = ((v >> np.uint64(32)).astype(np.int64) - BIAS).astype(np.int32)
    lo = ((v & np.uint64(0xFFFFFFFF)).astype(np.int64) - BIAS).astype(np.int32)
    return hi, lo


class DeviceIndex:
    """The CSR tables the collect reads, as int32 tensors on `device`:
    `starts` (n_keys + 1) and the values split into `vhi`/`vlo` (the int32
    bit patterns of each u64's high and low words), split on the device as
    they are uploaded. The flow looks up key positions on the host; the
    split key tables `khi`/`klo` that the key path searches are uploaded on
    its first `key_tables()` call, so a run that never collects by key
    never holds them. An index past the int32 limit raises ValueError."""

    def __init__(self, mi, device):
        check_int32_tables(len(mi.keys), len(mi.values))
        starts, = upload_int32(mi.starts, device,
                               (lambda x: x.to(torch.int32),))
        vhi, vlo = upload_int32(mi.values, device, (_hi32, _lo32))
        self._set(starts, vhi, vlo, device, mi.keys)

    @classmethod
    def from_arrays(cls, starts, vhi, vlo, device,
                    keys=None) -> "DeviceIndex":
        """Tables given as int32 arrays, e.g. the JAX package's
        `DeviceIndex` tables converted with np.asarray; `keys` (the sorted
        u64 key table) only where the key path will run."""
        check_int32_tables(len(starts) - 1, len(vhi))
        as_t = lambda a: torch.tensor(np.asarray(a, dtype=np.int32),
                                      device=device)
        dx = cls.__new__(cls)
        dx._set(as_t(starts), as_t(vhi), as_t(vlo), device, keys)
        return dx

    def _set(self, starts, vhi, vlo, device, keys):
        self.starts, self.vhi, self.vlo = starts, vhi, vlo
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


def release_device_index(mi, device) -> bool:
    """Drop `mi`'s cached tables on `device` (a runtime that still holds
    them keeps them alive); True if there was an entry."""
    key = (index_fingerprint(mi), device_key(device))
    return _DEVICE_INDEX_CACHE.pop(key, None) is not None


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


def _key_search(khi, klo, qhi, qlo, qvalid):
    """Each query key's position in the biased split keys khi/klo
    (n_keys,) int32 by a lexicographic binary search (searchsorted-left)
    with the JAX version's fixed step count, clamped as it clamps. Returns
    (pos_c int64, found bool), both (R, M)."""
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
    return pos_c, found


def _collect_dev(khi, klo, starts, vhi, vlo, qhi, qlo, qvalid, qpos, qspan,
                 qseg, qtandem, max_occ, qlen_sum, *, cap, group=None):
    """The key path: each query key is found by `_key_search`, then the
    expansion of _collect_dev_pos. q* inputs are (R, M) tensors (qhi/qlo
    split keys, qvalid bool, the rest int32); returns what
    _collect_dev_pos returns.

    With `group` (a parallel/mesh.Comm over the index axis) the tables are
    one shard of a key-range-sharded CSR (shard_index_tables): every key's
    occurrence list lives on exactly one shard, so the counts and each
    slot's anchor are summed over the group from the disjoint
    contributions (the JAX psums, seeds_device.py:144-148, 180-187)."""
    pos_c, found = _key_search(khi, klo, qhi, qlo, qvalid)
    return _expand(starts, vhi, vlo, found, pos_c, qpos, qspan, qseg,
                   qtandem, max_occ, qlen_sum, cap, group)


def _expand(starts, vhi, vlo, found, pos_c, qpos, qspan, qseg, qtandem,
            max_occ, qlen_sum, cap, group=None):
    """The collect after the key search: counts and over-occurrence
    masking (map.c:119-141), CSR expansion into `cap` slots, the anchor
    encoding (map.c:216-229) and the stable x-sort; with `group`, the
    sharded combine of _collect_dev."""
    R, M = found.shape
    dev = found.device
    i32 = torch.int32
    pos_c = pos_c.long()
    cnt = torch.where(found, starts[pos_c + 1] - starts[pos_c], 0)
    over = found & (cnt >= max_occ)
    keep = found & ~over
    occ = torch.where(keep, cnt, 0)
    if group is not None:
        # each query key is owned by exactly one shard: the sum gathers
        occ = group.all_reduce(occ)
        cnt_out = group.all_reduce(cnt)
        over_out = group.all_reduce(over.to(i32)) > 0
    else:
        cnt_out, over_out = cnt, over

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
    if group is not None:
        # a slot's values are real only on the shard owning its match:
        # zero elsewhere, then sum the disjoint contributions
        own = torch.gather(keep, 1, midx_c) & live
        xhi, xlo, yhi, ylo = (group.all_reduce(torch.where(own, v, 0))
                              for v in (xhi, xlo, yhi, ylo))

    # stable sort by x == (xhi unsigned, xlo): bias xhi for a signed
    # compare, pack (sk_hi, sk_lo) into one int64 key; pads sort last
    sk_hi = torch.where(live, xhi ^ SIGN, PAD_HI)
    key = (sk_hi.long() << 32) | (xlo.long() & 0xFFFFFFFF)
    order = torch.sort(key, dim=1, stable=True).indices
    xhi, xlo, yhi, ylo = (torch.gather(v, 1, order)
                          for v in (xhi, xlo, yhi, ylo))
    return (xhi, xlo, yhi, ylo, total.to(i32), cnt_out.to(i32), over_out)


def shard_index_tables(mi, n_shards: int):
    """Split the CSR index into `n_shards` equal-padded key-range shards for
    an index-sharded mesh axis (>chip-HBM genomes). Every key's occurrence
    list lives entirely on one shard (the psum-combine disjointness
    invariant); shard cuts balance cumulative VALUE volume, so the per-shard
    padding Vp is ~V/n_shards plus at most one key's list (shard_map needs
    equal block shapes — a single key hotter than V/n_shards sets the
    floor). Returns stacked arrays shaped (n_shards*Kp,) keys /
    (n_shards*(Kp+1),) starts / (n_shards*Vp,) values, ready to device_put
    with PartitionSpec("index").

    Copied from minimap2_chaindp_tpu/ops/seeds_device.py:256-302 (the
    port's Mesh.put sends shard i of each stacked table to the ranks of
    index i; its collectives want equal shapes just as shard_map does),
    with the shard sizes checked against the int32 limit before any table
    is split: a shard past it raises ValueError."""
    K = len(mi.keys)
    # cut by cumulative VALUE volume, not key count: occurrence-skewed
    # genomes would otherwise pad every shard's value table to the hottest
    # shard's size (the structure exists because values exceed one HBM)
    V = len(mi.values)
    targets = [(s * V) // n_shards for s in range(n_shards + 1)]
    cuts = [int(np.searchsorted(mi.starts, t, side="left"))
            for t in targets]
    cuts[0], cuts[-1] = 0, K
    for s in range(1, n_shards):  # keep cuts monotone on tiny indexes
        cuts[s] = min(max(cuts[s], cuts[s - 1]), K)
    Kp = max(max(cuts[s + 1] - cuts[s] for s in range(n_shards)), 1)
    Vp = max(max(int(mi.starts[cuts[s + 1]] - mi.starts[cuts[s]])
                 for s in range(n_shards)), 1)
    # each shard's tables are int32 with shard-local offsets (the port's
    # check: the JAX copy casts without one)
    check_int32_tables(Kp, Vp, f"index shard of {n_shards}")
    khi_g, klo_g = split_u64(mi.keys)
    vhi_g = (mi.values >> np.uint64(32)).astype(np.int64).astype(np.int32)
    vlo_g = (mi.values & np.uint64(0xFFFFFFFF)).astype(np.int64) \
        .astype(np.int32)
    khi = np.full((n_shards, Kp), 0x7FFFFFFF, np.int32)
    klo = np.full((n_shards, Kp), 0x7FFFFFFF, np.int32)
    starts = np.zeros((n_shards, Kp + 1), np.int32)
    vhi = np.zeros((n_shards, Vp), np.int32)
    vlo = np.zeros((n_shards, Vp), np.int32)
    for s in range(n_shards):
        k0, k1 = cuts[s], cuts[s + 1]
        n = k1 - k0
        khi[s, :n] = khi_g[k0:k1]
        klo[s, :n] = klo_g[k0:k1]
        v0, v1 = int(mi.starts[k0]), int(mi.starts[k1])
        # local CSR: rebased starts; sentinel keys repeat the end offset so
        # their counts are 0 (a query colliding with the sentinel is harmless)
        starts[s, :n + 1] = mi.starts[k0:k1 + 1] - v0
        starts[s, n + 1:] = v1 - v0
        vhi[s, :v1 - v0] = vhi_g[v0:v1]
        vlo[s, :v1 - v0] = vlo_g[v0:v1]
    return (khi.reshape(-1), klo.reshape(-1), starts.reshape(-1),
            vhi.reshape(-1), vlo.reshape(-1), Kp, Vp, cuts)


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
