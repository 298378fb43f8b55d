# Frozen copy of minimap2_chaindp_tpu/pe.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/pe.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Multi-segment (paired-end) handling: per-segment chain splitting, PE-aware
secondary selection, proper-pair search, PE mapQ blending.

Exact semantics of reference pe.c and mm_seg_gen (hit.c:347-401)."""
from __future__ import annotations

import numpy as np

from . import constants as C
from .hits import Region, gen_regs, sync_regs


def select_sub_multi(regs: list[Region], pri_ratio: float, pri1: float,
                     pri2: float, max_gap_ref: int, min_diff: int, best_n: int,
                     n_segs: int, qlens: list[int]) -> list[Region]:
    """PE-aware secondary filtering (reference mm_select_sub_multi, pe.c:6-43)."""
    if pri_ratio <= 0.0 or not regs:
        return regs
    f = np.float32
    r_ratio, r1, r2 = f(pri_ratio), f(pri1), f(pri2)
    max_dist = qlens[0] + qlens[1] + max_gap_ref if n_segs == 2 else 0
    # the reference compacts IN PLACE and reads r[r[i].parent] from the
    # array being compacted (pe.c:11-39) — replicate with a working copy;
    # the score-ratio tests are float32 multiply-compares
    work = list(regs)
    k = 0
    n_2nd = 0
    for i in range(len(work)):
        q = work[i]
        to_keep = 0
        p = work[q.parent]  # C aliasing: current occupant of the slot
        if q.parent == i:
            to_keep = 1
        elif q.score + min_diff >= p.score:
            to_keep = 1
        else:
            if p.rev == q.rev and p.rid == q.rid and q.re - p.rs < max_dist \
                    and p.re - q.rs < max_dist:
                if f(q.score) >= f(p.score) * r1:
                    to_keep = 1
            else:
                is_par_both = int(n_segs == 2 and p.qs < qlens[0] and p.qe > qlens[0])
                is_chi_both = int(n_segs == 2 and q.qs < qlens[0] and q.qe > qlens[0])
                if is_chi_both or is_chi_both == is_par_both:
                    if f(q.score) >= f(p.score) * r_ratio:
                        to_keep = 1
                else:
                    if f(q.score) >= f(p.score) * r2:
                        to_keep = 1
        if to_keep and q.parent != i:
            n_2nd += 1
            if n_2nd > best_n:
                to_keep = 0
        if to_keep:
            work[k] = q
            k += 1
    out = work[:k]
    if len(out) != len(regs):
        sync_regs(out)
    return out


def seg_gen(hash_: int, n_segs: int, qlens: list[int], regs0: list[Region],
            a: np.ndarray) -> list[tuple[list[Region], np.ndarray]]:
    """Split fragment chains into per-segment chains (reference mm_seg_gen,
    hit.c:347-401). Returns [(regs, a)] per segment."""
    acc_qlen = [0] * n_segs
    for s in range(1, n_segs):
        acc_qlen[s] = acc_qlen[s - 1] + qlens[s - 1]
    qlen_sum = acc_qlen[n_segs - 1] + qlens[n_segs - 1]

    seg_u = [[int(r.score) << 32 for r in regs0] for _ in range(n_segs)]
    seg_a: list[list[tuple[int, int]]] = [[] for _ in range(n_segs)]
    for i, r in enumerate(regs0):
        for j in range(r.cnt):
            ax, ay = int(a[r.as_ + j, 0]), int(a[r.as_ + j, 1])
            sid = (ay & C.MM_SEED_SEG_MASK) >> C.MM_SEED_SEG_SHIFT
            seg_u[sid][i] += 1
    for i, r in enumerate(regs0):
        for j in range(r.cnt):
            ax, ay = int(a[r.as_ + j, 0]), int(a[r.as_ + j, 1])
            sid = (ay & C.MM_SEED_SEG_MASK) >> C.MM_SEED_SEG_SHIFT
            # shift query positions back to segment-local coordinates (hit.c:385-389)
            if ax >> 63:
                ay = (ay - (qlen_sum - (qlens[sid] + acc_qlen[sid]))) & 0xFFFFFFFFFFFFFFFF
            else:
                ay = (ay - acc_qlen[sid]) & 0xFFFFFFFFFFFFFFFF
            seg_a[sid].append((ax, ay))

    result = []
    for s in range(n_segs):
        u = np.array([x for x in seg_u[s] if (x & 0xFFFFFFFF) != 0], dtype=np.uint64)
        a_s = np.array(seg_a[s], dtype=np.uint64).reshape(-1, 2)
        regs = gen_regs(hash_, qlens[s], u, a_s)
        for r in regs:
            r.seg_split = 1
            r.seg_id = s
        result.append((regs, a_s))
    return result


def set_pe_thru(qlens: list[int], regss: list[list[Region]]) -> None:
    """reference mm_set_pe_thru (pe.c:45-63), incl. its re-pe typo `p->re - p->re`."""
    n_pri = [0, 0]
    pri = [-1, -1]
    for s in range(2):
        for i, r in enumerate(regss[s]):
            if r.id == r.parent:
                n_pri[s] += 1
                pri[s] = i
    if n_pri[0] == 1 and n_pri[1] == 1:
        p = regss[0][pri[0]]
        q = regss[1][pri[1]]
        if p.rid == q.rid and p.rev == q.rev and abs(p.rs - q.rs) < 3 \
                and abs(p.re - p.re) < 3 \
                and ((p.qs == 0 and qlens[1] - q.qe == 0)
                     or (q.qs == 0 and qlens[0] - p.qe == 0)):
            p.pe_thru = q.pe_thru = 1


def pair(max_gap_ref: int, pe_bonus: int, sub_diff: int, match_sc: int,
         qlens: list[int], regss: list[list[Region]]) -> None:
    """Proper-pair search + PE mapQ blending (reference mm_pair, pe.c:76-177).
    Precondition: every region has p set (pair only runs with MM_F_CIGAR,
    and the reference dereferences r->p unconditionally, pe.c:91)."""
    f = np.float32
    entries = []  # (key, s, rev, reg)
    dp_thres = 0
    segs = 0
    for s in range(2):
        maxv = 0
        for r in regss[s]:
            key = (r.rid << 32) | (r.rs << 1) | (s ^ r.rev)
            entries.append([key, s, r.rev, r])
            maxv = max(maxv, r.p.dp_max)
            segs |= 1 << s
        dp_thres += maxv
    if segs != 3:
        return
    dp_thres = max(dp_thres - pe_bonus, 0)
    entries.sort(key=lambda e: e[0])

    maxsc = -1
    max_idx = [-1, -1]
    last = [-1, -1]
    sc: list[int] = []
    for i, ei in enumerate(entries):
        if ei[0] & 1:  # reverse first read or forward second read
            if last[ei[2]] < 0:
                continue
            r = ei[3]
            q = entries[last[ei[2]]][3]
            if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                continue
            for j in range(last[ei[2]], -1, -1):
                ej = entries[j]
                if ej[2] != ei[2] or ej[1] == ei[1]:
                    continue
                q = ej[3]
                if r.rid != q.rid or r.rs - q.re > max_gap_ref:
                    break
                if r.p.dp_max + q.p.dp_max < dp_thres:
                    continue
                score = ((r.p.dp_max + q.p.dp_max) << 32) | ((r.hash + q.hash) & 0xFFFFFFFF)
                if score > maxsc:
                    maxsc = score
                    max_idx[ej[1]] = j
                    max_idx[ei[1]] = i
                sc.append(score)
        else:
            last[ei[2]] = i
    sc.sort()

    if sc and maxsc > 0:
        r = [entries[max_idx[0]][3], entries[max_idx[1]][3]]
        r[0].proper_frag = r[1].proper_frag = 1
        for s in range(2):
            if r[s].id != r[s].parent:  # lift to primary
                p = regss[s][r[s].parent]
                for x in regss[s]:
                    if x.parent == p.id:
                        x.parent = r[s].id
                p.mapq = 0
            if not r[s].sam_pri:
                for x in regss[s]:
                    x.sam_pri = 0
                r[s].sam_pri = 1
        mapq_pe = max(r[0].mapq, r[1].mapq)
        n_sub = sum(1 for x in sc if (x >> 32) + sub_diff >= maxsc >> 32)
        if len(sc) > 1:
            # all-float32 chain with glibc logf (pe.c:159)
            from .hits import _logf
            mapq_pe_alt = int(f(f(f(f(6.02)
                                   * f((maxsc >> 32) - (sc[-2] >> 32)))
                                 / f(match_sc))
                               - f(f(4.343) * f(_logf(f(n_sub))))))
            mapq_pe = min(mapq_pe, mapq_pe_alt)
        if r[0].mapq < mapq_pe:
            r[0].mapq = int(f(f(f(f(.2) * f(r[0].mapq))
                               + f(f(.8) * f(mapq_pe))) + f(.499)))
        if r[1].mapq < mapq_pe:
            r[1].mapq = int(f(f(f(f(.2) * f(r[1].mapq))
                               + f(f(.8) * f(mapq_pe))) + f(.499)))
        if len(sc) == 1:
            r[0].mapq = max(r[0].mapq, 2)
            r[1].mapq = max(r[1].mapq, 2)
        elif (maxsc >> 32) > (sc[-2] >> 32):
            r[0].mapq = max(r[0].mapq, 1)
            r[1].mapq = max(r[1].mapq, 1)

    set_pe_thru(qlens, regss)
