# Frozen copy of minimap2_chaindp_tpu/hits.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/hits.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Hit post-processing: chains -> regions, primary/secondary selection, mapQ.

Host epilogue, exact semantics of reference hit.c (per-read, tiny, sequential —
kept on host per SURVEY.md §7.7). Citations inline.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from . import constants as C


@dataclass
class Extra:
    """Base-level alignment details (reference mm_extra_t, minimap.h:92-98)."""
    dp_score: int = 0
    dp_max: int = 0
    dp_max2: int = 0
    n_ambi: int = 0
    trans_strand: int = 0
    cigar: list[int] = field(default_factory=list)  # op | len<<4


@dataclass
class Region:
    """One mapping region (reference mm_reg1_t, minimap.h:100-115)."""
    id: int = 0
    cnt: int = 0
    rid: int = 0
    score: int = 0
    qs: int = 0
    qe: int = 0
    rs: int = 0
    re: int = 0
    parent: int = C.MM_PARENT_UNSET
    subsc: int = 0
    as_: int = 0
    mlen: int = 0
    blen: int = 0
    n_sub: int = 0
    score0: int = 0
    mapq: int = 0
    split: int = 0
    rev: int = 0
    inv: int = 0
    sam_pri: int = 0
    proper_frag: int = 0
    pe_thru: int = 0
    seg_split: int = 0
    seg_id: int = 0
    split_inv: int = 0
    hash: int = 0
    div: float = -1.0
    p: Extra | None = None


def _hash64(key: int) -> int:
    """hash64 without mask (reference hit.c:40-50), mod 2^64."""
    M = 0xFFFFFFFFFFFFFFFF
    key = (~key + (key << 21)) & M
    key ^= key >> 24
    key = ((key + (key << 3)) + (key << 8)) & M
    key ^= key >> 14
    key = ((key + (key << 2)) + (key << 4)) & M
    key ^= key >> 28
    key = (key + (key << 31)) & M
    return key


def cal_fuzzy_len(r: Region, a: np.ndarray) -> None:
    """mlen/blen from anchor gaps (reference hit.c:8-21)."""
    r.mlen = r.blen = 0
    if r.cnt <= 0:
        return
    from .nonative import cal_fuzzy_len_native
    nat = cal_fuzzy_len_native(a, r.as_, r.cnt)
    if nat is not None:
        r.mlen, r.blen = nat
        return
    r.mlen = r.blen = int(a[r.as_, 1] >> np.uint64(32) & np.uint64(0xFF))
    for i in range(r.as_ + 1, r.as_ + r.cnt):
        span = int(a[i, 1] >> np.uint64(32) & np.uint64(0xFF))
        tl = int(np.uint32(a[i, 0])) - int(np.uint32(a[i - 1, 0]))
        ql = int(np.uint32(a[i, 1])) - int(np.uint32(a[i - 1, 1]))
        r.blen += tl if tl > ql else ql
        r.mlen += span if (tl > span and ql > span) else (tl if tl < ql else ql)


def reg_set_coor(r: Region, qlen: int, a: np.ndarray) -> None:
    """Region coordinates from its anchors (reference hit.c:23-38)."""
    k = r.as_
    q_span = int(a[k, 1] >> np.uint64(32) & np.uint64(0xFF))
    r.rev = int(a[k, 0] >> np.uint64(63))
    r.rid = int((a[k, 0] << np.uint64(1)) >> np.uint64(33))
    rs = int(np.int32(np.uint32(a[k, 0]))) + 1 - q_span
    r.rs = rs if rs > 0 else 0
    r.re = int(np.int32(np.uint32(a[k + r.cnt - 1, 0]))) + 1
    y0 = int(np.int32(np.uint32(a[k, 1])))
    y1 = int(np.int32(np.uint32(a[k + r.cnt - 1, 1])))
    if not r.rev:
        r.qs = y0 + 1 - q_span
        r.qe = y1 + 1
    else:
        r.qs = qlen - (y1 + 1)
        r.qe = qlen - (y0 + 1 - q_span)
    cal_fuzzy_len(r, a)


def gen_regs(hash_: int, qlen: int, u: np.ndarray, a: np.ndarray) -> list[Region]:
    """Chains -> regions, sorted by score with hash tie-break (reference hit.c:52-88)."""
    n_u = len(u)
    if n_u == 0:
        return []
    zx = np.empty(n_u, dtype=np.uint64)
    zy = np.empty(n_u, dtype=np.uint64)
    k = 0
    for i in range(n_u):
        h = _hash64((_hash64(int(a[k, 0])) + _hash64(int(a[k, 1]))) & 0xFFFFFFFFFFFFFFFF
                    ^ hash_) & 0xFFFFFFFF
        zx[i] = np.uint64(int(u[i]) ^ h)
        zy[i] = np.uint64(k << 32 | (int(u[i]) & 0xFFFFFFFF))
        k += int(u[i]) & 0xFFFFFFFF
    order = np.argsort(zx, kind="stable")[::-1]
    regs = []
    for i, j in enumerate(order):
        r = Region()
        r.id = i
        r.parent = C.MM_PARENT_UNSET
        r.score = r.score0 = int(zx[j] >> np.uint64(32))
        r.hash = int(zx[j] & np.uint64(0xFFFFFFFF))
        r.cnt = int(zy[j] & np.uint64(0xFFFFFFFF))
        r.as_ = int(zy[j] >> np.uint64(32))
        r.div = -1.0
        reg_set_coor(r, qlen, a)
        regs.append(r)
    return regs


def split_reg(r: Region, n: int, qlen: int, a: np.ndarray) -> Region | None:
    """Split region at anchor n (reference mm_split_reg, hit.c:90-107)."""
    if n <= 0 or n >= r.cnt:
        return None
    import copy
    r2 = copy.copy(r)
    r2.id = -1
    r2.sam_pri = 0
    r2.p = None
    r2.split_inv = 0
    r2.cnt = r.cnt - n
    # f32 ratio and f32 product, then the DOUBLE .499 literal (hit.c:99:
    # `r->score * ((float)r2->cnt / r->cnt) + .499`)
    ratio = np.float32(np.float32(r2.cnt) / np.float32(r.cnt))
    r2.score = int(float(np.float32(np.float32(r.score) * ratio)) + .499)
    r2.as_ = r.as_ + n
    if r.parent == r.id:
        r2.parent = C.MM_PARENT_TMP_PRI
    reg_set_coor(r2, qlen, a)
    r.cnt -= r2.cnt
    r.score -= r2.score
    reg_set_coor(r, qlen, a)
    r.split |= 1
    r2.split |= 2
    return r2


def set_parent(regs: list[Region], mask_level: float, sub_diff: int) -> None:
    """Primary/secondary assignment by query overlap (reference hit.c:109-165)."""
    n = len(regs)
    if n <= 0:
        return
    for i, r in enumerate(regs):
        r.id = i
    w = [0]
    regs[0].parent = 0
    for i in range(1, n):
        ri = regs[i]
        si, ei = ri.qs, ri.qe
        cov = []
        for wj in w:
            rp = regs[wj]
            sj, ej = rp.qs, rp.qe
            if ej <= si or sj >= ei:
                continue
            cov.append((max(sj, si) << 32) | min(ej, ei))
        uncov_len = 0
        if cov:
            cov.sort()
            x = si
            for cc in cov:
                s_, e_ = cc >> 32, cc & 0xFFFFFFFF
                if s_ > x:
                    uncov_len += s_ - x
                x = max(e_, x)
            if ei > x:
                uncov_len += ei - x
            placed = False
            for wj in w:
                rp = regs[wj]
                sj, ej = rp.qs, rp.qe
                if ej <= si or sj >= ei:
                    continue
                min_l = min(ej - sj, ei - si)
                max_l = max(ej - sj, ei - si)
                if si < sj:
                    ol = 0 if ei < sj else (ei - sj if ei < ej else ej - sj)
                else:
                    ol = 0 if ej < si else (ej - si if ej < ei else ei - si)
                if np.float32(np.float32(np.float32(ol) / np.float32(min_l))
                              - np.float32(np.float32(uncov_len)
                                           / np.float32(max_l))) \
                        > np.float32(mask_level):  # f32, hit.c:147
                    cnt_sub = 0
                    ri.parent = rp.parent
                    rp.subsc = max(rp.subsc, ri.score)
                    if ri.cnt >= rp.cnt:
                        cnt_sub = 1
                    if rp.p and ri.p and (rp.rid != ri.rid or rp.rs != ri.rs
                                          or rp.re != ri.re or ol != min_l):
                        rp.p.dp_max2 = max(rp.p.dp_max2, ri.p.dp_max)
                        if rp.p.dp_max - ri.p.dp_max <= sub_diff:
                            cnt_sub = 1
                    if cnt_sub:
                        rp.n_sub += 1
                    placed = True
                    break
            if placed:
                continue
        w.append(i)
        ri.parent = i
        ri.n_sub = 0


def set_sam_pri(regs: list[Region]) -> int:
    n_pri = 0
    for r in regs:
        if r.id == r.parent:
            n_pri += 1
            r.sam_pri = 1 if n_pri == 1 else 0
        else:
            r.sam_pri = 0
    return n_pri


def sync_regs(regs: list[Region]) -> None:
    """Resync id/parent after deletions (reference hit.c:206-228)."""
    if not regs:
        return
    max_id = max(r.id for r in regs)
    tmp = [-1] * (max_id + 1)
    for i, r in enumerate(regs):
        if r.id >= 0:
            tmp[r.id] = i
    for i, r in enumerate(regs):
        r.id = i
        if r.parent == C.MM_PARENT_TMP_PRI:
            r.parent = i
        elif r.parent >= 0 and tmp[r.parent] >= 0:
            r.parent = tmp[r.parent]
        else:
            r.parent = C.MM_PARENT_UNSET
    set_sam_pri(regs)


def select_sub(regs: list[Region], pri_ratio: float, min_diff: int,
               best_n: int) -> list[Region]:
    """Filter weak secondary hits (reference hit.c:230-247).

    The reference compacts IN PLACE with `r[k++] = r[i]` and reads the
    parent via `r[p]` from the same array, so after any drop the parent
    slot may hold a different (already-compacted) region — replicated
    with a working copy mutated the same way. The score-ratio test is a
    float32 multiply-compare (`pri_ratio` is a C float)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    work = list(regs)
    ratio32 = np.float32(pri_ratio)
    k = 0
    n_2nd = 0
    for i in range(len(work)):
        r = work[i]
        p = r.parent
        pr = work[p]  # C aliasing: the CURRENT occupant of slot p
        if p == i or r.inv:
            work[k] = r
            k += 1
        elif ((np.float32(r.score) >= np.float32(pr.score) * ratio32
               or r.score + min_diff >= pr.score) and n_2nd < best_n):
            if not (r.qs == pr.qs and r.qe == pr.qe
                    and r.rid == pr.rid and r.rs == pr.rs
                    and r.re == pr.re):
                work[k] = r
                k += 1
                n_2nd += 1
    out = work[:k]
    if len(out) != len(regs):
        sync_regs(out)
    return out


def filter_regs(regs: list[Region], opt, qlen: int) -> list[Region]:
    """Drop weak regions (reference hit.c:249-268)."""
    out = []
    for r in regs:
        flt = False
        if not r.inv and not r.seg_split and r.cnt < opt.min_cnt:
            flt = True
        if r.p is not None:
            if r.mlen < opt.min_chain_score:
                flt = True
            elif r.p.dp_max < opt.min_dp_max:
                flt = True
            else:
                # f32 product-compare: max_clip_ratio is a C float
                clip = np.float32(qlen) * np.float32(opt.max_clip_ratio)
                if np.float32(r.qs) > clip and np.float32(qlen - r.qe) > clip:
                    flt = True
        if not flt:
            out.append(r)
    return out


def squeeze_a(regs: list[Region], a: np.ndarray) -> int:
    """Compact a[] to only referenced ranges (reference hit.c:270-288)."""
    aux = sorted(range(len(regs)), key=lambda i: (regs[i].as_, i))
    as_ = 0
    for i in aux:
        r = regs[i]
        if r.as_ != as_:
            a[as_:as_ + r.cnt] = a[r.as_:r.as_ + r.cnt]
            r.as_ = as_
        as_ += r.cnt
    return as_


def join_long(regs: list[Region], opt, qlen: int, a: np.ndarray) -> list[Region]:
    """Join adjacent colinear chains across long gaps (reference hit.c:290-345)."""
    if len(regs) < 2:
        return regs
    squeeze_a(regs, a)
    aux = sorted((i for i, r in enumerate(regs) if r.parent == i or r.parent < 0),
                 key=lambda i: (regs[i].as_, i))
    n_drop = 0
    for ii in range(len(aux) - 1, 0, -1):
        r0, r1 = regs[aux[ii - 1]], regs[aux[ii]]
        if r0.as_ + r0.cnt != r1.as_:
            continue
        if r0.rid != r1.rid or r0.rev != r1.rev:
            continue
        a0e = a[r0.as_ + r0.cnt - 1]
        a1s = a[r1.as_]
        if int(a1s[0]) <= int(a0e[0]) or int(np.int32(np.uint32(a1s[1]))) <= int(np.int32(np.uint32(a0e[1]))):
            continue
        gq = int(np.int32(np.uint32(a1s[1]))) - int(np.int32(np.uint32(a0e[1])))
        gr = int(a1s[0]) - int(a0e[0])
        max_gap, min_gap = max(gq, gr), min(gq, gr)
        if max_gap > opt.max_join_long or min_gap > opt.max_join_short:
            continue
        # f32 div and mul + the double .499 literal (hit.c:319)
        sc_thres = int(float(np.float32(
            np.float32(np.float32(opt.min_join_flank_sc)
                       / np.float32(opt.max_join_long))
            * np.float32(max_gap))) + .499)
        if r0.score < sc_thres or r1.score < sc_thres:
            continue
        if r0.re - r0.rs < max_gap >> 1 or r0.qe - r0.qs < max_gap >> 1:
            continue
        if r1.re - r1.rs < max_gap >> 1 or r1.qe - r1.qs < max_gap >> 1:
            continue
        a[r1.as_, 1] |= np.uint64(C.MM_SEED_LONG_JOIN)
        r0.cnt += r1.cnt
        r0.score += r1.score
        reg_set_coor(r0, qlen, a)
        r1.cnt = 0
        r1.parent = r0.id
        n_drop += 1
    if n_drop > 0:
        for r in regs:
            # regs[r.parent] directly: ids equal indices here (assigned by
            # set_parent/sync_regs; join_long does not reorder), hit.c:338
            if r.parent >= 0 and r.id != r.parent:
                pr = regs[r.parent]
                if pr.parent >= 0 and pr.parent != r.parent:
                    r.parent = pr.parent
        regs = filter_regs(regs, opt, qlen)
        sync_regs(regs)
    return regs


def hit_sort_by_dp(regs: list[Region]) -> list[Region]:
    """Sort by DP score desc with hash tie-break (reference hit.c:167-193)."""
    if len(regs) <= 1:
        return regs
    keep = [(i, r) for i, r in enumerate(regs) if r.inv or r.cnt > 0]
    keep.sort(key=lambda ir: ((ir[1].p.dp_max << 32) | ir[1].hash, ir[0]), reverse=True)
    return [r for _, r in keep]


def set_mapq(regs: list[Region], min_chain_sc: int, match_sc: int,
             rep_len: int, is_sr: bool) -> None:
    """MAPQ model (reference hit.c:437-481). The entire expression chain is
    float32 in the reference (all operands are C floats, so every
    intermediate multiply/subtract rounds to f32) — replicated stepwise
    with np.float32."""
    f = np.float32
    q_coef = f(40.0)
    sum_sc = sum(r.score for r in regs if r.parent == r.id)
    uniq_ratio = f(f(sum_sc) / f(sum_sc + rep_len)) \
        if (sum_sc + rep_len) else f(0.0)
    for r in regs:
        if r.inv:
            r.mapq = 0
        elif r.parent == r.id:
            pen_s1 = f((f(1.0) if r.score > 100 else f(f(0.01) * f(r.score)))
                       * uniq_ratio)
            pen_cm = f(1.0) if r.cnt > 10 else f(f(0.1) * f(r.cnt))
            pen_cm = pen_s1 if pen_s1 < pen_cm else pen_cm
            subsc = r.subsc if r.subsc > min_chain_sc else min_chain_sc
            if r.p is not None and r.p.dp_max2 > 0 and r.p.dp_max > 0:
                identity = f(f(r.mlen) / f(r.blen))
                x = f(f(f(f(r.p.dp_max2) * f(subsc)) / f(r.p.dp_max))
                      / f(r.score0))
                mapq = int(f(f(f(f(identity * pen_cm) * q_coef)
                              * f(f(1.0) - f(x * x)))
                            * f(_logf(f(f(r.p.dp_max) / f(match_sc))))))
                if not is_sr:
                    mapq_alt = int(f(f(f(f(f(f(6.02) * identity) * identity)
                                        * f(r.p.dp_max - r.p.dp_max2))
                                      / f(match_sc)) + f(.499)))
                    mapq = min(mapq, mapq_alt)
            else:
                x = f(f(subsc) / f(r.score0)) if r.score0 else f(0.0)
                if r.p is not None:
                    identity = f(f(r.mlen) / f(r.blen))
                    mapq = int(f(f(f(f(identity * pen_cm) * q_coef)
                                  * f(f(1.0) - x))
                                * f(_logf(f(f(r.p.dp_max) / f(match_sc))))))
                else:
                    mapq = int(f(f(f(pen_cm * q_coef) * f(f(1.0) - x))
                                * f(_logf(f(r.score)))))
            mapq -= int(f(f(f(4.343) * f(_logf(f(r.n_sub + 1)))) + f(.499)))
            mapq = max(mapq, 0)
            r.mapq = min(mapq, 60)
            if r.p is not None and r.p.dp_max > r.p.dp_max2 and r.mapq == 0:
                r.mapq = 1
        else:
            r.mapq = 0
    set_inv_mapq(regs)


def set_inv_mapq(regs: list[Region]) -> None:
    """Inversion hits inherit min flanking mapq (reference hit.c:411-435)."""
    if len(regs) < 3 or not any(r.inv for r in regs):
        return
    aux = sorted((i for i, r in enumerate(regs) if r.parent == i or r.parent < 0),
                 key=lambda i: (regs[i].as_, i))
    for ii in range(1, len(aux) - 1):
        inv = regs[aux[ii]]
        if inv.inv:
            inv.mapq = min(regs[aux[ii - 1]].mapq, regs[aux[ii + 1]].mapq)


def _logf(x: float) -> float:
    # glibc logf (as the reference and the native fast path compute it);
    # numpy's float32 log can differ by 1 ulp, enough to flip an int
    # truncation at a mapq boundary
    from .nonative import logf_native
    v = logf_native(x)
    if v is not None:
        return v
    return float(np.log(np.float32(x)))
