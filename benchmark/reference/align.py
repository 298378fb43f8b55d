# Frozen copy of minimap2_chaindp_tpu/align.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/align.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Base-level alignment orchestration (reference align.c, exact host semantics).

Per-region: end fixing, bad-seed filtering, HPC-aware anchor adjustment, left
extension, anchor-gap filling with two-pass Z-drop, right extension, CIGAR
fixups (indel left-shift, zero-op squeeze, leading I/D strip), NM/blen/mlen
recompute, Z-drop chain splitting and inversion rescue.  Extension DP calls go
through a pluggable kernel (ops.ksw2 host model now; Pallas batch later).
"""
from __future__ import annotations

import math

import numpy as np

from . import constants as C
from .hits import (Extra, Region, filter_regs, hit_sort_by_dp, reg_set_coor,
                   split_reg, squeeze_a)
from .ops import ksw2 as K


def _i32(v) -> int:
    # low 32 bits as signed, in plain python ints (hot in the per-anchor
    # chain-end heuristics; numpy scalar chains here cost ~5x more)
    v = int(v) & 0xFFFFFFFF
    return v - 0x100000000 if v >= 0x80000000 else v


def _span(y) -> int:
    return int((int(y) >> 32) & 0xFF)


def mm_update_max_zdrop(score, i, j, state, e, pos):
    maxv, max_i, max_j, max_zdrop = state
    if score < maxv:
        li, lj = i - max_i, j - max_j
        diff = abs(li - lj)
        z = maxv - score - diff * e
        if z > max_zdrop:
            max_zdrop = z
            pos[0][0], pos[0][1] = max_i, i + 1
            pos[1][0], pos[1][1] = max_j, j + 1
    else:
        maxv, max_i, max_j = score, i, j
    return (maxv, max_i, max_j, max_zdrop)


def test_zdrop(opt, qseq, tseq, cigar, mat, ez=None) -> int:
    """Z-drop + inversion test on a CIGAR (reference mm_test_zdrop, align.c:46-88).

    When the extension ran through the native batch with want_zdrop, the
    scan result rides on the Ez (computed in C right after the job) and no
    further native call is needed."""
    nat = getattr(ez, "zscan", None) if ez is not None else None
    if nat is None:
        from .nonative import zdrop_scan
        nat = zdrop_scan(qseq, tseq, cigar, mat, opt.q, opt.e)
    if nat is not None:
        max_zdrop, pos = nat
    else:
        state = (-(1 << 31), -1, -1, 0)
        pos = [[-1, -1], [-1, -1]]
        i = j = score = 0
        matq = mat.reshape(5, 5)
        for c in cigar:
            op, length = c & 0xF, c >> 4
            if op == 0:
                # vectorized running-score scan with per-step zdrop update
                sub = matq[tseq[i:i + length],
                           qseq[j:j + length]].astype(np.int64)
                for l in range(length):
                    score += int(sub[l])
                    state = mm_update_max_zdrop(score, i + l, j + l, state,
                                                opt.e, pos)
                i += length
                j += length
            elif op in (1, 2, 3):
                score -= opt.q + opt.e * length
                if op == 1:
                    j += length
                else:
                    i += length
                state = mm_update_max_zdrop(score, i, j, state, opt.e, pos)
        _, _, _, max_zdrop = state
    q_len = pos[1][1] - pos[1][0]
    t_len = pos[0][1] - pos[0][0]
    if (not (opt.flag & (C.MM_F_SPLICE | C.MM_F_SR | C.MM_F_FOR_ONLY | C.MM_F_REV_ONLY))
            and max_zdrop > opt.zdrop_inv and q_len < opt.max_gap and t_len < opt.max_gap):
        qseq2 = qseq[pos[1][1] - q_len:pos[1][1]][::-1]
        qseq2 = np.where(qseq2 >= 4, np.uint8(4), (3 - qseq2).astype(np.uint8))
        score, _, _ = K.ksw_ll(qseq2, tseq[pos[0][0]:pos[0][0] + t_len], mat, opt.q, opt.e)
        if score >= opt.min_chain_score * opt.a and score >= opt.min_dp_max:
            return 2
    return 1 if max_zdrop > opt.zdrop else 0


def fix_cigar(r: Region, qseq, tseq) -> tuple[int, int]:
    """Indel left-shift + zero-op squeeze + leading I/D strip (align.c:90-146)."""
    p = r.p
    qshift = tshift = 0
    if len(p.cigar) <= 1:
        return 0, 0
    toff = qoff = 0
    to_shrink = False
    cig = p.cigar
    for k in range(len(cig)):
        op, length = cig[k] & 0xF, cig[k] >> 4
        if length == 0:
            to_shrink = True
        if op == 0:
            toff += length
            qoff += length
        elif op in (1, 2):
            if 0 < k < len(cig) - 1 and (cig[k - 1] & 0xF) == 0 and (cig[k + 1] & 0xF) == 0:
                prev_len = cig[k - 1] >> 4
                l = 0
                if op == 1:
                    while l < prev_len and qseq[qoff - 1 - l] == qseq[qoff + length - 1 - l]:
                        l += 1
                else:
                    while l < prev_len and tseq[toff - 1 - l] == tseq[toff + length - 1 - l]:
                        l += 1
                if l > 0:
                    cig[k - 1] -= l << 4
                    cig[k + 1] += l << 4
                    qoff -= l
                    toff -= l
                if l == prev_len:
                    to_shrink = True
            if op == 1:
                qoff += length
            else:
                toff += length
        elif op == 3:
            toff += length
    assert qoff == r.qe - r.qs and toff == r.re - r.rs
    if to_shrink:
        cig2 = [c for c in cig if c >> 4 != 0]
        merged: list[int] = []
        for c in cig2:
            if merged and (merged[-1] & 0xF) == (c & 0xF):
                merged[-1] += c >> 4 << 4
            else:
                merged.append(c)
        p.cigar = cig = merged
    if cig and (cig[0] & 0xF) in (1, 2):
        l = cig[0] >> 4
        if (cig[0] & 0xF) == 1:
            if r.rev:
                r.qe -= l
            else:
                r.qs += l
            qshift = l
        else:
            r.rs += l
            tshift = l
        p.cigar = cig[1:]
    return qshift, tshift


def update_extra(r: Region, qseq, tseq, mat, q, e) -> None:
    """Recompute blen/mlen/n_ambi/dp_max from the final CIGAR (align.c:148-193)."""
    p = r.p
    if p is None:
        return
    from .nonative import fix_update_extra
    fused = fix_update_extra(qseq, tseq, p.cigar, mat, q, e, r.rev,
                             r.qs, r.qe, r.rs, r.re)
    if fused is not None:
        p.cigar, (r.qs, r.qe, r.rs, r.re), r.blen, r.mlen, n_ambi, \
            p.dp_max = fused
        p.n_ambi += n_ambi
        return
    qshift, tshift = fix_cigar(r, qseq, tseq)
    qseq = qseq[qshift:]
    tseq = tseq[tshift:]
    from .nonative import update_extra_scan
    nat = update_extra_scan(qseq, tseq, p.cigar, mat, q, e,
                            r.qe - r.qs, r.re - r.rs)
    if nat is not None:
        blen, mlen, n_ambi, dp_max, ok = nat
        r.blen, r.mlen = blen, mlen
        p.n_ambi += n_ambi
        p.dp_max = dp_max
        assert ok
        return
    r.blen = r.mlen = 0
    toff = qoff = 0
    s = 0
    maxv = 0
    matq = mat.reshape(5, 5).astype(np.int64)
    for c in p.cigar:
        op, length = c & 0xF, c >> 4
        if op == 0:
            cq = qseq[qoff:qoff + length]
            ct = tseq[toff:toff + length]
            ambi = (ct > 3) | (cq > 3)
            n_ambi = int(ambi.sum())
            n_diff = int(((ct != cq) & ~ambi).sum())
            sub = matq[ct, cq]
            # running score with clamp-at-0 and max tracking
            for v in sub:
                s += int(v)
                if s < 0:
                    s = 0
                elif s > maxv:
                    maxv = s
            r.blen += length - n_ambi
            r.mlen += length - (n_ambi + n_diff)
            p.n_ambi += n_ambi
            toff += length
            qoff += length
        elif op == 1:
            n_ambi = int((qseq[qoff:qoff + length] > 3).sum())
            r.blen += length - n_ambi
            p.n_ambi += n_ambi
            s -= q + e * length
            if s < 0:
                s = 0
            qoff += length
        elif op == 2:
            n_ambi = int((tseq[toff:toff + length] > 3).sum())
            r.blen += length - n_ambi
            p.n_ambi += n_ambi
            s -= q + e * length
            if s < 0:
                s = 0
            toff += length
        elif op == 3:
            toff += length
    p.dp_max = maxv
    assert qoff == r.qe - r.qs and toff == r.re - r.rs


def append_cigar(r: Region, cigar: list[int]) -> None:
    """reference mm_append_cigar (align.c:195-218)."""
    if not cigar:
        return
    if r.p is None:
        r.p = Extra()
    p = r.p
    if p.cigar and (p.cigar[-1] & 0xF) == (cigar[0] & 0xF):
        p.cigar[-1] += cigar[0] >> 4 << 4
        p.cigar.extend(cigar[1:])
    else:
        p.cigar.extend(cigar)


def align_pair(opt, qseq, tseq, mat, w, end_bonus, zdrop, flag) -> K.Ez:
    """Kernel dispatch (reference mm_align_pair, align.c:220-243)."""
    from .utils import mlog
    if mlog.dbg_flag & C.MM_DBG_PRINT_ALN_SEQ:
        import sys
        print(f"===> q=({opt.q},{opt.q2}), e=({opt.e},{opt.e2}), bw={w}, "
              f"flag={flag}, zdrop={opt.zdrop} <===", file=sys.stderr)
        bases = "ACGTN"
        print("".join(bases[b] for b in tseq), file=sys.stderr)
        print("".join(bases[b] for b in qseq), file=sys.stderr)
        ez = _align_pair_dispatch(opt, qseq, tseq, mat, w, end_bonus, zdrop,
                                  flag)
        # post-alignment result line (align.c:236-241)
        cig = "".join(f"{c >> 4}{'MIDN'[c & 0xF]}" for c in ez.cigar)
        print(f"score={ez.score}, cigar={cig}", file=sys.stderr)
        return ez
    return _align_pair_dispatch(opt, qseq, tseq, mat, w, end_bonus, zdrop,
                                flag)


def _align_pair_dispatch(opt, qseq, tseq, mat, w, end_bonus, zdrop,
                         flag) -> K.Ez:
    if opt.flag & C.MM_F_SPLICE:
        from .nonative import exts2_batch_native
        res = exts2_batch_native(
            [dict(qseq=qseq, tseq=tseq, zdrop=zdrop, flag=flag)],
            mat, opt.q, opt.e, opt.q2, opt.noncan)
        if res is not None:
            return res[0]
        from .ops.ksw2_splice import exts2
        return exts2(qseq, tseq, mat, opt.q, opt.e, opt.q2, opt.noncan, zdrop, flag)
    elif opt.q == opt.q2 and opt.e == opt.e2:
        from .ops.ksw2 import extz2
        return extz2(qseq, tseq, mat, opt.q, opt.e, w, zdrop, end_bonus, flag)
    else:
        from .nonative import extd2_batch_native
        res = extd2_batch_native(
            [dict(qseq=qseq, tseq=tseq, w=w, zdrop=zdrop,
                  end_bonus=end_bonus, flag=flag)],
            mat, opt.q, opt.e, opt.q2, opt.e2)
        if res is not None:
            return res[0]
        return K.extd2(qseq, tseq, mat, opt.q, opt.e, opt.q2, opt.e2, w, zdrop,
                       end_bonus, flag)


def get_hplen_back(mi, rid: int, x: int) -> int:
    seq = mi.seqs[rid]
    c = mi.S[seq.offset + x]
    i = x - 1
    while i >= 0 and mi.S[seq.offset + i] == c:
        i -= 1
    return x - i


def adjust_minier(mi, qseq0, ax: int, ay: int) -> tuple[int, int]:
    """HPC-aware anchor coordinate adjust (reference align.c:254-269)."""
    if mi.flag & C.MM_I_HPC:
        qseq = qseq0[ax >> 63]
        q = _i32(ay)
        c = qseq[q]
        i = q - 1
        while i > 0 and qseq[i] == c:
            i -= 1
        q = i + 1
        c = get_hplen_back(mi, (ax << 1 & 0xFFFFFFFFFFFFFFFF) >> 33, _i32(ax))
        r = _i32(ax) + 1 - c
    else:
        r = _i32(ax) - (mi.k >> 1)
        q = _i32(ay) - (mi.k >> 1)
    return r, q


def filter_bad_seeds(as1, cnt1, a, min_gap, diff_thres, max_ext_len, max_ext_cnt):
    """Mark unbalanced-gap seeds MM_SEED_IGNORE (reference align.c:271-315).
    The per-anchor gap scan is vectorized (low-32 signed coordinate
    differences equal the reference's within a chain, where the high words
    are constant and per-sequence positions stay below 2^31)."""
    xs = a[as1:as1 + cnt1, 0].astype(np.uint32).astype(np.int64)
    ys = a[as1:as1 + cnt1, 1].astype(np.uint32).astype(np.int64)
    gap_arr = np.diff(ys) - np.diff(xs)
    gaps = (np.nonzero((gap_arr < -min_gap) | (gap_arr > min_gap))[0]
            + 1).tolist()
    n = len(gaps)
    if n <= 1:
        return
    Karr = gaps
    maxv, max_st, max_en = 0, -1, -1
    k = 0
    while True:
        if k == n or k >= max_en:
            if max_en > 0:
                for i in range(Karr[max_st], Karr[max_en]):
                    a[as1 + i, 1] |= np.uint64(C.MM_SEED_IGNORE)
            maxv, max_st, max_en = 0, -1, -1
            if k == n:
                break
        i = Karr[k]
        gap = int(gap_arr[i - 1])
        n_ins = gap if gap > 0 else 0
        n_del = -gap if gap <= 0 else 0
        qs = int(np.int32(ys[i - 1]))
        rs = int(np.int32(xs[i - 1]))
        max_diff, max_diff_l = 0, -1
        l = k + 1
        while l < n and l <= k + max_ext_cnt:
            j = Karr[l]
            if int(np.int32(ys[j])) - qs > max_ext_len \
                    or int(np.int32(xs[j])) - rs > max_ext_len:
                break
            gap = int(gap_arr[j - 1])
            if gap > 0:
                n_ins += gap
            else:
                n_del += -gap
            diff = n_ins + n_del - abs(n_ins - n_del)
            if max_diff < diff:
                max_diff, max_diff_l = diff, l
            l += 1
        if max_diff > diff_thres and max_diff > maxv:
            maxv, max_st, max_en = max_diff, k, max_diff_l
        k += 1


def fix_bad_ends(r: Region, a, bw, min_match) -> tuple[int, int]:
    """Trim sloppy chain ends (reference mm_fix_bad_ends, align.c:317-351)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 3:
        return as_, cnt
    from .nonative import fix_bad_ends_native
    res = fix_bad_ends_native(a, r.as_, r.cnt, r.mlen, bw, min_match)
    if res is not None:
        return res
    m = l = _span(a[r.as_, 1])
    for i in range(r.as_ + 1, r.as_ + r.cnt - 1):
        q_span = _span(a[i, 1])
        if int(a[i, 1]) & C.MM_SEED_LONG_JOIN:
            break
        lr = _i32(a[i, 0]) - _i32(a[i - 1, 0])
        lq = _i32(a[i, 1]) - _i32(a[i - 1, 1])
        minv, maxv = min(lr, lq), max(lr, lq)
        if maxv - minv > l >> 1:
            as_ = i
        l += minv
        m += min(minv, q_span)
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    cnt = r.as_ + r.cnt - as_
    m = l = _span(a[r.as_ + r.cnt - 1, 1])
    for i in range(r.as_ + r.cnt - 2, as_, -1):
        q_span = _span(a[i + 1, 1])
        if int(a[i + 1, 1]) & C.MM_SEED_LONG_JOIN:
            break
        lr = _i32(a[i + 1, 0]) - _i32(a[i, 0])
        lq = _i32(a[i + 1, 1]) - _i32(a[i, 1])
        minv, maxv = min(lr, lq), max(lr, lq)
        if maxv - minv > l >> 1:
            cnt = i + 1 - as_
        l += minv
        m += min(minv, q_span)
        if l >= bw << 1 or (m >= min_match and m >= bw) or m >= r.mlen >> 1:
            break
    return as_, cnt


def max_stretch(r: Region, a) -> tuple[int, int]:
    """Longest exact colinear stretch for sr mode (reference align.c:353-379)."""
    as_, cnt = r.as_, r.cnt
    if r.cnt < 2:
        return as_, cnt
    max_score, max_i, max_len = -1, -1, 0
    score, length = _span(a[r.as_, 1]), 1
    i = r.as_ + 1
    for i in range(r.as_ + 1, r.as_ + r.cnt):
        q_span = _span(a[i, 1])
        lr = _i32(a[i, 0]) - _i32(a[i - 1, 0])
        lq = _i32(a[i, 1]) - _i32(a[i - 1, 1])
        if lq == lr:
            score += min(lq, q_span)
            length += 1
        else:
            if score > max_score:
                max_score, max_len, max_i = score, length, i - length
            score, length = q_span, 1
    i = r.as_ + r.cnt
    if score > max_score:
        max_score, max_len, max_i = score, length, i - length
    return max_i, max_len


def seed_ext_score(opt, mi, mat, qlen, qseq0, ax, ay) -> int:
    """Seed rescoring for splice end fixing (reference align.c:381-401)."""
    q_span = _span(ay)
    ext_len = opt.anchor_ext_len
    rid = (ax << 1 & 0xFFFFFFFFFFFFFFFF) >> 33
    re = (_i32(ax)) + 1
    rs = re - q_span
    qe = (_i32(ay)) + 1
    qs = qe - q_span
    rs = max(rs - ext_len, 0)
    qs = max(qs - ext_len, 0)
    re = min(re + ext_len, mi.seqs[rid].length)
    qe = min(qe + ext_len, qlen)
    tseq = mi.getseq(rid, rs, re)
    qseq = qseq0[ax >> 63][qs:qe]
    score, _, _ = K.ksw_ll(qseq, tseq, mat, opt.q, opt.e)
    return score


def fix_bad_ends_splice(opt, mi, r, mat, qlen, qseq0, a) -> tuple[int, int]:
    """reference align.c:403-421."""
    as1, cnt1 = r.as_, r.cnt
    if r.cnt < 3:
        return as1, cnt1
    log_gap = math.log(_i32(a[r.as_ + 1, 0]) - _i32(a[r.as_, 0]))
    if _span(a[r.as_, 1]) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0, int(a[r.as_, 0]), int(a[r.as_, 1]))
        if score / int(mat[0]) < log_gap + opt.anchor_ext_shift:
            as1 += 1
            cnt1 -= 1
    log_gap = math.log(_i32(a[r.as_ + r.cnt - 1, 0]) - _i32(a[r.as_ + r.cnt - 2, 0]))
    if _span(a[r.as_ + r.cnt - 1, 1]) < log_gap + opt.anchor_ext_shift:
        score = seed_ext_score(opt, mi, mat, qlen, qseq0,
                               int(a[r.as_ + r.cnt - 1, 0]), int(a[r.as_ + r.cnt - 1, 1]))
        if score / int(mat[0]) < log_gap + opt.anchor_ext_shift:
            cnt1 -= 1
    return as1, cnt1


def _host_thunk(opt, mat, job):
    """Lazy host executor for one extension job (discarded speculative jobs
    are never computed, so the call sequence matches the reference)."""
    cache = []

    def run():
        if not cache:
            cache.append(align_pair(opt, job["qseq"], job["tseq"], mat,
                                    job["w"], job["end_bonus"],
                                    job["zdrop"], job["flag"]))
        return cache[0]
    return run


def align1(opt, mi, qlen, qseq0, r: Region, n_a: int, a, splice_flag: int):
    """Align one region (reference mm_align1, align.c:423-636); synchronous
    driver of align1_gen with lazy host execution of each wave.

    Returns r2 (split region or None)."""
    mat = K.gen_simple_mat(5, opt.a, opt.b)
    gen = align1_gen(opt, mi, qlen, qseq0, r, n_a, a, splice_flag)
    try:
        wave = next(gen)
        while True:
            wave = gen.send([_host_thunk(opt, mat, job) for job in wave])
    except StopIteration as e:
        return e.value


def align1_gen(opt, mi, qlen, qseq0, r: Region, n_a: int, a,
               splice_flag: int):
    """Generator form of mm_align1: yields waves of extension-job dicts
    (qseq, tseq, w, end_bonus, zdrop, flag) and receives matching lists of
    result thunks.  The first wave speculatively carries the left extension,
    every first-pass gap fill, and the right extension — their inputs depend
    only on the anchors, so a batch scheduler can run one device call for
    many regions; Z-drop re-runs are yielded as follow-up single-job waves.
    Consumption order is exactly the reference's sequential order, and
    results past a Z-drop break are simply never consumed."""
    is_sr = bool(opt.flag & C.MM_F_SR)
    is_splice = bool(opt.flag & C.MM_F_SPLICE)
    rid = int((a[r.as_, 0] << np.uint64(1)) >> np.uint64(33))
    rev = int(a[r.as_, 0] >> np.uint64(63))
    r2 = None
    if r.cnt == 0:
        return None
    mat = K.gen_simple_mat(5, opt.a, opt.b)
    bw = int(opt.bw * 1.5 + 1.0)
    dropped = 0
    extra_flag = 0

    # precomputed anchor fields (the per-anchor _i32 scans dominate the
    # host generator at large batch sizes)
    ax_lo = a[:, 0].astype(np.uint32).astype(np.int32)
    ay_lo = a[:, 1].astype(np.uint32).astype(np.int32)
    span_a = ((a[:, 1] >> np.uint64(32)) & np.uint64(0xFF)).astype(np.int64)
    if mi.flag & C.MM_I_HPC:
        def adj(i_):
            return adjust_minier(mi, qseq0, int(a[i_, 0]), int(a[i_, 1]))
    else:
        _kh = mi.k >> 1

        def adj(i_):
            return int(ax_lo[i_]) - _kh, int(ay_lo[i_]) - _kh

    if is_sr and not (mi.flag & C.MM_I_HPC):
        as1, cnt1 = max_stretch(r, a)
        rs = _i32(a[as1, 0]) + 1 - _span(a[as1, 1])
        qs = _i32(a[as1, 1]) + 1 - _span(a[as1, 1])
        re = _i32(a[as1 + cnt1 - 1, 0]) + 1
        qe = _i32(a[as1 + cnt1 - 1, 1]) + 1
    else:
        if is_splice:
            as1, cnt1 = fix_bad_ends_splice(opt, mi, r, mat, qlen, qseq0, a)
        else:
            as1, cnt1 = fix_bad_ends(r, a, opt.bw, opt.min_chain_score * 2)
        filter_bad_seeds(as1, cnt1, a, 10, 40, opt.max_gap >> 1, 10)
        rs, qs = adj(as1)
        re, qe = adj(as1 + cnt1 - 1)
    assert cnt1 > 0

    if is_splice:
        if splice_flag & C.MM_F_SPLICE_FOR:
            extra_flag |= K.KSW_EZ_SPLICE_REV if rev else K.KSW_EZ_SPLICE_FOR
        if splice_flag & C.MM_F_SPLICE_REV:
            extra_flag |= K.KSW_EZ_SPLICE_FOR if rev else K.KSW_EZ_SPLICE_REV
        if opt.flag & C.MM_F_SPLICE_FLANK:
            extra_flag |= K.KSW_EZ_SPLICE_FLANK

    tlen_rid = mi.seqs[rid].length
    if is_sr:
        qs0, qe0 = 0, qlen
        l = qs
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e if l * opt.a + opt.end_bonus > opt.q else 0
        rs0 = rs - l if rs - l > 0 else 0
        l = qlen - qe
        l += (l * opt.a + opt.end_bonus - opt.q) // opt.e if l * opt.a + opt.end_bonus > opt.q else 0
        re0 = re + l if re + l < tlen_rid else tlen_rid
    else:
        rs0 = _i32(a[r.as_, 0]) + 1 - _span(a[r.as_, 1])
        qs0 = _i32(a[r.as_, 1]) + 1 - _span(a[r.as_, 1])
        if rs0 < 0:
            rs0 = 0
        assert qs0 >= 0
        rs1 = qs1 = 0
        hi32 = int(a[r.as_, 0]) >> 32
        # backward scan for the (min_cnt+1)-th colinear predecessor in the
        # same target block — vectorized over the contiguous hi32 run
        hi_a = a[:, 0] >> np.uint64(32)
        blk_lo = int(np.searchsorted(hi_a, np.uint64(hi32), side="left"))
        if blk_lo < r.as_:
            seg = slice(blk_lo, r.as_)
            xs_s = ax_lo[seg].astype(np.int64) + 1 - span_a[seg]
            ys_s = ay_lo[seg].astype(np.int64) + 1 - span_a[seg]
            hits = np.nonzero((xs_s < rs0) & (ys_s < qs0))[0]
            if len(hits) > opt.min_cnt:
                h = hits[-(opt.min_cnt + 1)]
                l = max(rs0 - int(xs_s[h]), qs0 - int(ys_s[h]))
                rs1, qs1 = rs0 - l, qs0 - l
        if qs > 0 and rs > 0:
            l = min(qs, opt.max_gap)
            qs1 = max(qs1, qs - l)
            qs0 = min(qs0, qs1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, rs)
            rs1 = max(rs1, rs - l)
            rs0 = min(rs0, rs1)
        else:
            rs0, qs0 = rs, qs
        re0 = _i32(a[r.as_ + r.cnt - 1, 0]) + 1
        qe0 = _i32(a[r.as_ + r.cnt - 1, 1]) + 1
        re1, qe1 = tlen_rid, qlen
        blk_hi = int(np.searchsorted(hi_a, np.uint64(hi32), side="right"))
        blk_hi = min(blk_hi, n_a)
        i0_f = r.as_ + r.cnt
        if i0_f < blk_hi:
            seg = slice(i0_f, blk_hi)
            xs_s = ax_lo[seg].astype(np.int64) + 1
            ys_s = ay_lo[seg].astype(np.int64) + 1
            hits = np.nonzero((xs_s > re0) & (ys_s > qe0))[0]
            if len(hits) > opt.min_cnt:
                h = hits[opt.min_cnt]
                l = max(int(xs_s[h]) - re0, int(ys_s[h]) - qe0)
                re1, qe1 = re0 + l, qe0 + l
        if qe < qlen and re < tlen_rid:
            l = min(qlen - qe, opt.max_gap)
            qe1 = min(qe1, qe + l)
            qe0 = max(qe0, qe1)
            l += (l * opt.a - opt.q) // opt.e if l * opt.a > opt.q else 0
            l = min(l, opt.max_gap)
            l = min(l, tlen_rid - re)
            re1 = min(re1, re + l)
            re0 = max(re0, re1)
        else:
            re0, qe0 = re, qe
    if int(a[r.as_, 1]) & C.MM_SEED_SELF:
        max_ext = abs(r.qs - r.rs)
        if r.rs - rs0 > max_ext:
            rs0 = r.rs - max_ext
        if r.qs - qs0 > max_ext:
            qs0 = r.qs - max_ext
        max_ext = abs(r.qe - r.re)
        if re0 - r.re > max_ext:
            re0 = r.re + max_ext
        if qe0 - r.qe > max_ext:
            qe0 = r.qe + max_ext

    assert re0 > rs0

    # ---- enumerate this region's extension jobs as one speculative wave;
    # inputs depend only on the anchors, so the whole wave can be computed
    # before any result is consumed (two-phase batching, SURVEY.md §7)
    wave = []
    has_left = qs > 0 and rs > 0
    if has_left:
        wave.append(dict(
            qseq=qseq0[rev][qs0:qs][::-1].copy(),
            tseq=mi.getseq(rid, rs0, rs)[::-1].copy(), w=bw,
            end_bonus=opt.end_bonus,
            zdrop=opt.zdrop_inv if r.split_inv else opt.zdrop,
            flag=extra_flag | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT
            | K.KSW_EZ_REV_CIGAR))
    # cut-point enumeration, once: the reference's fill loop (align.c:560-608)
    # only does work at anchors where it cuts a ksw job, so both the
    # speculative wave below and the consumption loop iterate the cut list
    # (~n_fill entries) instead of every anchor (native scan for the common
    # non-HPC non-sr case; exact Python replay otherwise)
    cuts = None
    if not is_sr and not (mi.flag & C.MM_I_HPC):
        from .nonative import enum_fill_cuts_native
        cuts = enum_fill_cuts_native(a, as1, cnt1, mi.k >> 1,
                                     opt.min_ksw_len, rs, qs)
    elif not is_sr and len(mi.S) and mi.S.flags.c_contiguous:
        from .nonative import _np_ptr, enum_fill_cuts_hpc_native
        cuts = enum_fill_cuts_hpc_native(
            a, as1, cnt1, np.ascontiguousarray(qseq0[rev]),
            _np_ptr(mi.S) + mi.seqs[rid].offset, opt.min_ksw_len, rs, qs)
    if cuts is None:
        cuts = []
        rs_c, qs_c = rs, qs
        i = cnt1 - 1 if is_sr else 1
        while i < cnt1:
            ay_i = int(a[as1 + i, 1])
            if (ay_i & (C.MM_SEED_IGNORE | C.MM_SEED_TANDEM)) \
                    and i != cnt1 - 1:
                i += 1
                continue
            if is_sr and not (mi.flag & C.MM_I_HPC):
                re_c = int(ax_lo[as1 + i]) + 1
                qe_c = int(ay_lo[as1 + i]) + 1
            else:
                re_c, qe_c = adj(as1 + i)
            if i == cnt1 - 1 or (ay_i & C.MM_SEED_LONG_JOIN) or \
               (qe_c - qs_c >= opt.min_ksw_len
                    and re_c - rs_c >= opt.min_ksw_len):
                cuts.append((i, re_c, qe_c,
                             bool(ay_i & C.MM_SEED_LONG_JOIN)))
                rs_c, qs_c = re_c, qe_c
            i += 1

    n_fill = 0
    rs_c, qs_c = rs, qs
    for _, re_c, qe_c, lj in cuts:
        if not is_sr:
            bw1 = max(qe_c - qs_c, re_c - rs_c) if lj else bw
            wave.append(dict(qseq=qseq0[rev][qs_c:qe_c],
                             tseq=mi.getseq(rid, rs_c, re_c), w=bw1,
                             end_bonus=-1, zdrop=opt.zdrop,
                             flag=extra_flag | K.KSW_EZ_APPROX_MAX,
                             want_zdrop=True))
            n_fill += 1
        rs_c, qs_c = re_c, qe_c
    has_right = qs_c < qe0 and rs_c < re0
    if has_right:
        wave.append(dict(qseq=qseq0[rev][qs_c:qe0],
                         tseq=mi.getseq(rid, rs_c, re0), w=bw,
                         end_bonus=opt.end_bonus, zdrop=opt.zdrop,
                         flag=extra_flag | K.KSW_EZ_EXTZ_ONLY))
    thunks = list((yield wave))
    fill0 = 1 if has_left else 0          # thunk index of the first fill

    if has_left:  # left extension (reversed)
        ez = thunks[0]()
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        rs1 = rs - (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qs1 = qs - (qs - qs0 if ez.reach_end else ez.max_q + 1)
    else:
        rs1, qs1 = rs, qs
    re1, qe1 = rs, qs
    assert qs1 >= 0 and rs1 >= 0

    k_fill = 0
    for i, re, qe, lj in cuts:  # gap filling, per cut
        re1, qe1 = re, qe
        bw1 = max(qe - qs, re - rs) if lj else bw
        qseq = qseq0[rev][qs:qe]
        tseq = mi.getseq(rid, rs, re)
        if is_sr:  # ungapped
            assert qe - qs == re - rs
            ez = K.Ez()
            sc = np.where((qseq >= 4) | (tseq >= 4), opt.e2,
                          np.where(qseq == tseq, opt.a, -opt.b))
            ez.score = int(sc.sum())
            ez.cigar = [(qe - qs) << 4 | 0]
        else:
            ez = thunks[fill0 + k_fill]()
            k_fill += 1
        zdrop_code = test_zdrop(opt, qseq, tseq, ez.cigar, mat, ez)
        if zdrop_code != 0:
            t2 = yield [dict(
                qseq=qseq, tseq=tseq, w=bw1, end_bonus=-1,
                zdrop=opt.zdrop_inv if zdrop_code == 2 else opt.zdrop,
                flag=extra_flag)]
            ez = t2[0]()
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
        if ez.zdropped:
            j = i - 1
            while j >= 0:
                if _i32(a[as1 + j, 0]) <= rs + ez.max_t:
                    break
                j -= 1
            dropped = 1
            if j < 0:
                j = 0
            if r.p is None:
                r.p = Extra()
            r.p.dp_score += ez.max
            re1 = rs + (ez.max_t + 1)
            qe1 = qs + (ez.max_q + 1)
            if cnt1 - (j + 1) >= opt.min_cnt:
                r2 = split_reg(r, as1 + j + 1 - r.as_, qlen, a)
                if r2 is not None and zdrop_code == 2:
                    r2.split_inv = 1
            break
        else:
            if r.p is None:
                r.p = Extra()
            r.p.dp_score += ez.score
        rs, qs = re, qe

    if not dropped and qe < qe0 and re < re0:  # right extension
        qseq = qseq0[rev][qe:qe0]
        tseq = mi.getseq(rid, re, re0)
        assert has_right
        ez = thunks[-1]()
        if ez.n_cigar > 0:
            append_cigar(r, ez.cigar)
            r.p.dp_score += ez.max
        re1 = re + (ez.mqe_t + 1 if ez.reach_end else ez.max_t + 1)
        qe1 = qe + (qe0 - qe if ez.reach_end else ez.max_q + 1)
    assert qe1 <= qlen

    r.rs, r.re = rs1, re1
    if rev:
        r.qs, r.qe = qlen - qe1, qlen - qs1
    else:
        r.qs, r.qe = qs1, qe1

    assert re1 - rs1 <= re0 - rs0
    if r.p is not None:
        tseq = mi.getseq(rid, rs1, re1)
        update_extra(r, qseq0[r.rev][qs1:], tseq, mat, opt.q, opt.e)
        if rev and r.p.trans_strand:
            r.p.trans_strand ^= 3
    return r2


def align1_inv(opt, mi, qlen, qseq0, r1: Region, r2: Region) -> Region | None:
    """Inversion rescue between split chains (reference mm_align1_inv, align.c:638-693)."""
    if not (r1.split & 1) or not (r2.split & 2):
        return None
    if r1.id != r1.parent and r1.parent != C.MM_PARENT_TMP_PRI:
        return None
    if r2.id != r2.parent and r2.parent != C.MM_PARENT_TMP_PRI:
        return None
    if r1.rid != r2.rid or r1.rev != r2.rev:
        return None
    ql = r1.qs - r2.qe if r1.rev else r2.qs - r1.qe
    tl = r2.rs - r1.re
    if ql < opt.min_chain_score or ql > opt.max_gap:
        return None
    if tl < opt.min_chain_score or tl > opt.max_gap:
        return None
    mat = K.gen_simple_mat(5, opt.a, opt.b)
    tseq = mi.getseq(r1.rid, r1.re, r2.rs)
    if r1.rev:
        qseq = qseq0[0][r2.qe:r2.qe + ql]
    else:
        qseq = qseq0[1][qlen - r2.qs:qlen - r2.qs + ql]
    score, q_off, t_off = K.ksw_ll(qseq[::-1], tseq[::-1], mat, opt.q, opt.e)
    if score < opt.min_dp_max:
        return None
    q_off = ql - (q_off + 1)
    t_off = tl - (t_off + 1)
    ez = align_pair(opt, qseq[q_off:], tseq[t_off:], mat, int(opt.bw * 1.5), -1,
                    opt.zdrop, K.KSW_EZ_EXTZ_ONLY)
    if ez.n_cigar == 0:
        return None
    r_inv = Region()
    append_cigar(r_inv, ez.cigar)
    r_inv.p.dp_score = ez.max
    r_inv.id = -1
    r_inv.parent = C.MM_PARENT_UNSET
    r_inv.inv = 1
    r_inv.rev = 0 if r1.rev else 1
    r_inv.rid = r1.rid
    r_inv.div = -1.0
    if r_inv.rev == 0:
        r_inv.qs = r2.qe + q_off
        r_inv.qe = r_inv.qs + ez.max_q + 1
    else:
        r_inv.qe = r2.qs - q_off
        r_inv.qs = r_inv.qe - (ez.max_q + 1)
    r_inv.rs = r1.re + t_off
    r_inv.re = r_inv.rs + ez.max_t + 1
    update_extra(r_inv, qseq[q_off:], tseq[t_off:], mat, opt.q, opt.e)
    return r_inv


def align_skeleton(opt, mi, qlen: int, qstr: str, regs: list[Region],
                   a: np.ndarray) -> list[Region]:
    """Align all regions of one read (reference mm_align_skeleton,
    align.c:705-761); synchronous lazy-host driver of align_skeleton_gen."""
    mat = K.gen_simple_mat(5, opt.a, opt.b)
    gen = align_skeleton_gen(opt, mi, qlen, qstr, regs, a)
    try:
        wave = next(gen)
        while True:
            wave = gen.send([_host_thunk(opt, mat, job) for job in wave])
    except StopIteration as e:
        return e.value


def _native_skeleton_ok(opt, mi) -> bool:
    """Native per-read align driver eligibility: the dual-affine non-splice
    path with reference sequences available (splice and the single-affine
    extz path stay on the Python golden model)."""
    import os
    if os.environ.get("MM2TPU_NATIVE_SKELETON", "1") == "0":
        return False
    if not getattr(opt, "native_skeleton", True):
        return False  # executor routes extension jobs to the device kernel
    if opt.flag & C.MM_F_SPLICE:
        return False
    if opt.q == opt.q2 and opt.e == opt.e2:
        return False
    return len(mi.S) > 0 and mi.S.flags.c_contiguous


def align_skeleton_gen(opt, mi, qlen: int, qstr: str, regs: list[Region],
                       a: np.ndarray):
    """Generator form of mm_align_skeleton: forwards the per-region job
    waves of align1_gen, so a batch scheduler can interleave many reads'
    extension work into shared device calls.  When the whole read is
    eligible for the native per-read driver (align_driver.cc), it runs
    there in one call and no waves are yielded."""
    fwd = C.seq_to_nt4(qstr)
    if regs and _native_skeleton_ok(opt, mi):
        from .nonative import align_skeleton_native
        n_a = squeeze_a(regs, a)
        res = align_skeleton_native(opt, mi, qlen, fwd, regs, a, n_a,
                                    K.gen_simple_mat(5, opt.a, opt.b))
        if res is not None:
            res = filter_regs(res, opt, qlen)
            return hit_sort_by_dp(res)
        # native driver unavailable; fall through (squeeze_a is idempotent)
    qseq0 = [None, None]
    qseq0[0] = fwd
    qseq0[1] = np.where(fwd < 4, (3 - fwd).astype(np.uint8), np.uint8(4))[::-1].copy()

    n_a = squeeze_a(regs, a)
    i = 0
    while i < len(regs):
        if (opt.flag & C.MM_F_SPLICE) and (opt.flag & C.MM_F_SPLICE_FOR) \
                and (opt.flag & C.MM_F_SPLICE_REV):
            import copy
            s0, s1 = copy.deepcopy(regs[i]), copy.deepcopy(regs[i])
            s20 = yield from align1_gen(opt, mi, qlen, qseq0, s0, n_a, a,
                                        C.MM_F_SPLICE_FOR)
            s21 = yield from align1_gen(opt, mi, qlen, qseq0, s1, n_a, a,
                                        C.MM_F_SPLICE_REV)
            if s0.p.dp_score > s1.p.dp_score:
                which, trans_strand = 0, 1
            elif s0.p.dp_score < s1.p.dp_score:
                which, trans_strand = 1, 2
            else:
                trans_strand = 3
                which = (qlen + s0.p.dp_score) & 1
            if which == 0:
                regs[i], r2 = s0, s20
            else:
                regs[i], r2 = s1, s21
            regs[i].p.trans_strand = trans_strand
        else:
            r2 = yield from align1_gen(opt, mi, qlen, qseq0, regs[i], n_a, a,
                                       opt.flag)
            if opt.flag & C.MM_F_SPLICE and regs[i].p is not None:
                regs[i].p.trans_strand = 1 if opt.flag & C.MM_F_SPLICE_FOR else 2
        if r2 is not None and r2.cnt > 0:
            regs.insert(i + 1, r2)
        if i > 0 and regs[i].split_inv:
            r_inv = align1_inv(opt, mi, qlen, qseq0, regs[i - 1], regs[i])
            if r_inv is not None:
                regs.insert(i + 1, r_inv)  # inserted AFTER regs[i] (align.c:749-751)
                i += 1  # skip the inserted INV alignment
        i += 1
    regs = filter_regs(regs, opt, qlen)
    regs = hit_sort_by_dp(regs)
    return regs
