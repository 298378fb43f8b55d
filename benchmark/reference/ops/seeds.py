# Frozen copy of minimap2_chaindp_tpu/ops/seeds.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/ops/seeds.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Seed-hit collection: query minimizers -> sorted anchors (host golden model).

Semantics follow reference map.c:112-236 (collect_matches / skip_seed /
collect_seed_hits) with the STOCK 64-bit index-value encoding
(rid<<32 | pos<<1 | strand) rather than the fork's 21-bit packed form:

  anchor.x = rev<<63 | rid<<32 | rpos
  anchor.y = flags | seg_id<<48 | q_span<<32 | qpos   (qpos flipped on rev strand)

The ava-mode dual/diagonal skipping (map.c:146-185) uses direct name
comparison, equivalent to the fork's rank-id compare (map.c:153-168).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C


@dataclass
class SeedHits:
    anchors: np.ndarray      # (n, 2) uint64, sorted by x
    rep_len: int
    mini_pos: np.ndarray     # (n_mini_pos,) uint64: q_span<<32 | q_pos


def mini_pos_of(mv: np.ndarray, keep) -> np.ndarray:
    """mini_pos encoding (q_span<<32 | q_pos) for the kept minimizers —
    every non-over-occurring minimizer is a "match", even with zero index
    occurrences (map.c:131-138). The single definition shared by the host
    collector, the device collector, and the fused flow, so the encoding
    cannot silently diverge between golden and device paths."""
    return (mv[keep, 1] & np.uint64(0xFFFFFFFF)) >> np.uint64(1) \
        | (mv[keep, 0] & np.uint64(0xFF)) << np.uint64(32)


def collect_minimizers(opt, mi, seqs: list[str]) -> np.ndarray:
    """Sketch all segments of a fragment; offsets q positions by the running sum
    of previous segment lengths (reference map.c:87-99)."""
    from ..index.sketch import sketch
    parts = []
    total = 0
    for seg_id, s in enumerate(seqs):
        if len(s) == 0:
            continue
        mv = sketch(s, mi.w, mi.k, seg_id, mi.is_hpc)
        if len(mv):
            mv = mv.copy()
            mv[:, 1] += np.uint64(total << 1)
        if opt.sdust_thres > 0:
            # NB applied after the segment q-offset, exactly like the
            # reference (map.c:95-96 masks post-offset positions against
            # per-segment LCR coordinates)
            from ..sdust import dust_mask_minimizers
            mv = dust_mask_minimizers(mv, s, opt.sdust_thres)
        parts.append(mv)
        total += len(s)
    if not parts:
        return np.empty((0, 2), dtype=np.uint64)
    return np.concatenate(parts, axis=0)


def collect_seed_hits(mi, flag: int, max_occ: int, mv: np.ndarray,
                      qname: str | None, qlen_sum: int) -> SeedHits:
    n = len(mv)
    if n == 0:
        return SeedHits(np.empty((0, 2), dtype=np.uint64), 0,
                        np.empty(0, dtype=np.uint64))
    if not (flag & C.MM_F_NO_DIAG):
        # non-ava fast path: the whole collect runs natively (the ava
        # name-compare / self-diagonal modes stay in the numpy path below)
        from .. import nonative as native
        skip_mode = ((1 if flag & C.MM_F_FOR_ONLY else 0)
                     | (2 if flag & C.MM_F_REV_ONLY else 0))
        res = native.collect_seeds_native(mi, max_occ, mv, qlen_sum,
                                          skip_mode)
        if res is not None:
            anchors, rep_len, mini_pos = res
            return SeedHits(anchors, rep_len, mini_pos)
    key = mv[:, 0] >> np.uint64(8)
    q_span = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
    q_pos = (mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(np.int64)
    seg_id = (mv[:, 1] >> np.uint64(32)).astype(np.int64)

    ki = np.searchsorted(mi.keys, key)
    ki_c = np.minimum(ki, max(len(mi.keys) - 1, 0))
    found = (len(mi.keys) > 0) & (mi.keys[ki_c] == key)
    cnt = np.where(found, mi.starts[ki_c + 1] - mi.starts[ki_c], 0)

    # repetitive-region length from over-occurring minimizers (map.c:119-141)
    over = cnt >= max_occ
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

    # every non-over-occurring minimizer is a "match" and lands in mini_pos,
    # even with zero occurrences in the index (map.c:131-138)
    keep = ~over
    mini_pos = mini_pos_of(mv, keep)
    m_idx = np.nonzero(keep & found)[0]

    if len(m_idx) == 0:
        return SeedHits(np.empty((0, 2), dtype=np.uint64), int(rep_len), mini_pos)

    # tandem flag: same key as an adjacent minimizer in mv order (map.c:135-136)
    tandem = np.zeros(n, dtype=bool)
    if n > 1:
        same = key[1:] == key[:-1]
        tandem[1:] |= same
        tandem[:-1] |= same

    # CSR expansion: one row per (match, occurrence)
    occ_cnt = cnt[m_idx]
    match_of = np.repeat(np.arange(len(m_idx)), occ_cnt)
    within = np.arange(len(match_of)) - np.repeat(
        np.concatenate([[0], np.cumsum(occ_cnt)[:-1]]), occ_cnt)
    r = mi.values[np.repeat(mi.starts[ki_c[m_idx]], occ_cnt) + within]

    mi_row = m_idx[match_of]
    qp = q_pos[mi_row]          # q_pos<<1|strand of the match
    qsp = q_span[mi_row]
    sid = seg_id[mi_row]
    rid = (r >> np.uint64(32)).astype(np.int64)
    rpos = ((r & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
    rstrand = (r & np.uint64(1)).astype(np.int64)
    fwd = rstrand == (qp & 1)

    skip = np.zeros(len(r), dtype=bool)
    is_self = np.zeros(len(r), dtype=bool)
    if flag & C.MM_F_NO_DIAG:  # NB: "1 & flag & (NO_DIAG|NO_DUAL)" gates on bit 0 only
        # cmp sign of strcmp(qname, target_name) via precomputed ranks
        cmp = np.array([_strcmp_sign(qname or "", mi.seqs[t].name) for t in
                        range(mi.n_seq)], dtype=np.int64)[rid]
        diag = (cmp == 0) & (rpos == (qp >> 1))
        skip |= diag
        is_self = (cmp == 0) & fwd
        if flag & C.MM_F_NO_DUAL:
            skip |= cmp > 0
    if flag & (C.MM_F_FOR_ONLY | C.MM_F_REV_ONLY):
        if flag & C.MM_F_REV_ONLY:
            skip |= fwd
        if flag & C.MM_F_FOR_ONLY:
            skip |= ~fwd

    keep2 = ~skip
    qp, qsp, sid, rid, rpos, fwd = (v[keep2] for v in (qp, qsp, sid, rid, rpos, fwd))
    is_self = is_self[keep2]
    tnd = tandem[mi_row][keep2]

    x = (np.where(fwd, 0, 1).astype(np.uint64) << np.uint64(63)) \
        | rid.astype(np.uint64) << np.uint64(32) | rpos.astype(np.uint64)
    qpos_out = np.where(fwd, qp >> 1, qlen_sum - ((qp >> 1) + 1 - qsp) - 1)
    y = qsp.astype(np.uint64) << np.uint64(32) | qpos_out.astype(np.uint64)
    y |= sid.astype(np.uint64) << np.uint64(C.MM_SEED_SEG_SHIFT)
    y |= np.where(tnd, np.uint64(C.MM_SEED_TANDEM), np.uint64(0))
    y |= np.where(is_self, np.uint64(C.MM_SEED_SELF), np.uint64(0))

    order = np.argsort(x, kind="stable")  # radix_sort_128x by x (map.c:233)
    anchors = np.stack([x[order], y[order]], axis=1)
    return SeedHits(anchors, int(rep_len), mini_pos)


def _strcmp_sign(a: str, b: str) -> int:
    ab, bb = a.encode(), b.encode()
    return (ab > bb) - (ab < bb)
