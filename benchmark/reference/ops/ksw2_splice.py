# Frozen copy of minimap2_chaindp_tpu/ops/ksw2_splice.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/ops/ksw2_splice.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Splice-aware extension DP — exact host golden model of ksw_exts2_sse.

Same anti-diagonal difference formulation as ops/ksw2.extd2, with the second
gap state replaced by an intron state driven by per-position donor/acceptor
splice-signal arrays (reference ksw2_exts2_sse.c:112-131): GT..AG (forward) /
CT..AC (reverse-complement) sites cost 0 (canonical + flank), -noncan/2
(canonical), or -noncan. The intron state has no length penalty beyond q2 and
emits CIGAR op N for runs >= long_thres (ksw2.h:141-142).
"""
from __future__ import annotations

import numpy as np

from .ksw2 import (Ez, narrow, row_scores, KSW_EZ_APPROX_DROP,
                   KSW_EZ_APPROX_MAX, KSW_EZ_EXTZ_ONLY, KSW_EZ_GENERIC_SC,
                   KSW_EZ_REV_CIGAR, KSW_EZ_RIGHT,
                   KSW_EZ_SCORE_ONLY, KSW_EZ_SPLICE_FLANK, KSW_EZ_SPLICE_FOR,
                   KSW_EZ_SPLICE_REV, KSW_NEG_INF, _apply_zdrop,
                   _backtrack_rot)


def make_donor_acceptor(target: np.ndarray, noncan: int, flag: int):
    """Donor/acceptor splice-signal arrays (reference ksw2_exts2_sse.c:112-131)."""
    tlen = len(target)
    tlen16 = (tlen + 15) // 16 * 16
    donor = np.zeros(tlen16, dtype=np.int8)
    acceptor = np.zeros(tlen16, dtype=np.int8)
    if flag & (KSW_EZ_SPLICE_FOR | KSW_EZ_SPLICE_REV):
        semi_cost = int(-noncan / 2) if flag & KSW_EZ_SPLICE_FLANK else 0
        donor[:] = -noncan
        for t in range(tlen - 4):
            can_type = 0
            if (flag & KSW_EZ_SPLICE_FOR) and target[t + 1] == 2 and target[t + 2] == 3:
                can_type = 1  # GT...
            if (flag & KSW_EZ_SPLICE_REV) and target[t + 1] == 1 and target[t + 2] == 3:
                can_type = 1  # CT...
            if can_type and (target[t + 3] == 0 or target[t + 3] == 2):
                can_type = 2
            if can_type:
                donor[t] = 0 if can_type == 2 else semi_cost
        acceptor[:] = -noncan
        for t in range(2, tlen):
            can_type = 0
            if (flag & KSW_EZ_SPLICE_FOR) and target[t - 1] == 0 and target[t] == 2:
                can_type = 1  # ...AG
            if (flag & KSW_EZ_SPLICE_REV) and target[t - 1] == 0 and target[t] == 1:
                can_type = 1  # ...AC
            if can_type and (target[t - 2] == 1 or target[t - 2] == 3):
                can_type = 2
            if can_type:
                acceptor[t] = 0 if can_type == 2 else semi_cost
    return donor, acceptor


def exts2(qseq: np.ndarray, tseq: np.ndarray, mat: np.ndarray, q: int, e: int,
          q2: int, noncan: int, zdrop: int, flag: int, m: int = 5) -> Ez:
    """Splice extension (reference ksw_exts2_sse, bit-exact emulation)."""
    ez = Ez()
    qlen, tlen = len(qseq), len(tseq)
    if m <= 1 or qlen <= 0 or tlen <= 0 or q2 <= q + e:
        return ez
    with_cigar = not (flag & KSW_EZ_SCORE_ONLY)
    approx_max = bool(flag & KSW_EZ_APPROX_MAX)
    sc_mch, sc_mis, sc_N = np.int8(mat[0]), np.int8(mat[1]), np.int8(-e)
    if -int(mat.min()) > 2 * (q + e):
        return ez

    long_thres = (q2 - q) // e - 1
    if q2 > q + e + long_thres * e:
        long_thres += 1
    long_diff = long_thres * e - (q2 - q)

    tlen16 = (tlen + 15) // 16 * 16
    n_col = (min(qlen, tlen) + 15) // 16 * 16 + 16  # bytes per p row

    i8 = np.int8
    u = np.full(tlen16, -q - e, dtype=i8)
    v = np.full(tlen16, -q - e, dtype=i8)
    x = np.full(tlen16, -q - e, dtype=i8)
    y = np.full(tlen16, -q - e, dtype=i8)
    x2 = np.full(tlen16, -q2, dtype=i8)
    s = np.zeros(tlen16 + 16, dtype=i8)
    donor, acceptor = make_donor_acceptor(tseq, noncan, flag)
    H = np.full(tlen16, KSW_NEG_INF, dtype=np.int64) if not approx_max else None
    H0 = 0
    last_H0_t = 0
    sf = np.zeros(tlen16 + 16, dtype=np.uint8)
    sf[:tlen] = tseq
    qr = np.zeros(qlen + 32 + tlen16, dtype=np.uint8)
    qr[:qlen] = qseq[::-1]

    if with_cigar:
        p = np.zeros((qlen + tlen - 1) * n_col, dtype=np.uint8)
        off = [0] * (qlen + tlen - 1)
        off_end = [0] * (qlen + tlen - 1)
    else:
        p, off, off_end = None, None, None

    right = bool(flag & KSW_EZ_RIGHT)
    generic_sc = bool(flag & KSW_EZ_GENERIC_SC)
    matq = mat.reshape(m, m)
    last_st = last_en = -1
    qe_, q_, q2_ = np.int8(q + e), np.int8(q), np.int8(q2)

    for r in range(qlen + tlen - 1):
        st, en = max(0, r - qlen + 1), min(tlen - 1, r)
        st0, en0 = st, en
        st = st // 16 * 16
        en = (en + 16) // 16 * 16 - 1
        if st > 0:
            if last_st <= st - 1 <= last_en:
                x1, x21, v1 = int(x[st - 1]), int(x2[st - 1]), int(v[st - 1])
            else:
                x1, x21, v1 = -q - e, -q2, -q - e
        else:
            x1, x21 = -q - e, -q2
            v1 = (-q - e if r == 0 else
                  -e if r < long_thres else
                  long_diff if r == long_thres else 0)
        if en >= r:
            y[r] = -q - e
            u[r] = (-q - e if r == 0 else
                    -e if r < long_thres else
                    long_diff if r == long_thres else 0)
        qrr_base = qlen - 1 - r
        if not generic_sc:
            row_scores(s, sf, qr, qrr_base, st0, en0, m, sc_mch, sc_mis, sc_N)
        else:
            for t in range(st0, en0 + 1):
                s[t] = matq[sf[t], qr[qrr_base + t]]

        sl = slice(st, en + 1)
        z = s[sl].copy()
        ut = u[sl].copy()
        xt1 = np.empty(en - st + 1, dtype=i8)
        xt1[0] = x1
        xt1[1:] = x[st:en]
        x2t1 = np.empty(en - st + 1, dtype=i8)
        x2t1[0] = x21
        x2t1[1:] = x2[st:en]
        vt1 = np.empty(en - st + 1, dtype=i8)
        vt1[0] = v1
        vt1[1:] = v[st:en]
        a = xt1 + vt1
        b = y[sl] + ut
        a2 = x2t1 + vt1
        a2a = a2 + acceptor[sl]
        if with_cigar:
            if not right:
                d = np.where(a > z, np.uint8(1), np.uint8(0))
                z = np.maximum(z, a)
                d = np.where(b > z, np.uint8(2), d)
                z = np.maximum(z, b)
                d = np.where(a2a > z, np.uint8(3), d)
                z = np.maximum(z, a2a)
            else:
                d = np.where(z > a, np.uint8(0), np.uint8(1))
                z = np.maximum(z, a)
                d = np.where(z > b, d, np.uint8(2))
                z = np.maximum(z, b)
                d = np.where(z > a2a, d, np.uint8(3))
                z = np.maximum(z, a2a)
        else:
            z = np.maximum(np.maximum(z, a), np.maximum(b, a2a))
            d = None
        u[sl] = narrow(z - vt1)
        v[sl] = narrow(z - ut)
        tmp = z - q_
        a = a - tmp
        b = b - tmp
        a2 = a2 - (z - q2_)
        dn = donor[sl]
        if with_cigar:
            if not right:
                x[sl] = np.where(a > 0, a, np.int8(0)) - qe_
                d |= np.where(a > 0, np.uint8(0x08), np.uint8(0))
                y[sl] = np.where(b > 0, b, np.int8(0)) - qe_
                d |= np.where(b > 0, np.uint8(0x10), np.uint8(0))
                gt = a2 > dn
                x2[sl] = np.where(gt, a2, dn) - q2_
                d |= np.where(gt, np.uint8(0x20), np.uint8(0))
            else:
                x[sl] = np.where(a >= 0, a, np.int8(0)) - qe_
                d |= np.where(a >= 0, np.uint8(0x08), np.uint8(0))
                y[sl] = np.where(b >= 0, b, np.int8(0)) - qe_
                d |= np.where(b >= 0, np.uint8(0x10), np.uint8(0))
                ge = a2 >= dn
                x2[sl] = np.where(ge, a2, dn) - q2_
                d |= np.where(ge, np.uint8(0x20), np.uint8(0))
            p[r * n_col:r * n_col + en - st + 1] = d
            off[r], off_end[r] = st, en
        else:
            x[sl] = np.where(a > 0, a, np.int8(0)) - qe_
            y[sl] = np.where(b > 0, b, np.int8(0)) - qe_
            x2[sl] = np.where(a2 > dn, a2, dn) - q2_

        if not approx_max:
            if r > 0:
                if en0 > 0:
                    H[en0] = H[en0 - 1] + int(u[en0])
                else:
                    H[en0] = H[en0] + int(v[en0])
                max_H, max_t = int(H[en0]), en0
                en1 = st0 + (en0 - st0) // 4 * 4
                if en1 > st0:
                    Hblk = H[st0:en1] + v[st0:en1].astype(np.int64)
                    H[st0:en1] = Hblk
                    Hblk = Hblk.reshape(-1, 4)
                    for lanei in range(4):
                        col = Hblk[:, lanei]
                        cmax = int(col.max())
                        if cmax > max_H:
                            max_H = cmax
                            max_t = st0 + 4 * int(np.argmax(col)) + lanei
                for t in range(en1, en0):
                    H[t] += int(v[t])
                    if H[t] > max_H:
                        max_H, max_t = int(H[t]), t
            else:
                H[0] = int(v[0]) - (q + e)
                max_H, max_t = int(H[0]), 0
            if en0 == tlen - 1 and H[en0] > ez.mte:
                ez.mte, ez.mte_q = int(H[en0]), r - en
            if r - st0 == qlen - 1 and H[st0] > ez.mqe:
                ez.mqe, ez.mqe_t = int(H[st0]), st0
            if _apply_zdrop(ez, max_H, r, max_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = int(H[tlen - 1])
        else:
            if r > 0:
                if st0 <= last_H0_t <= en0 and st0 <= last_H0_t + 1 <= en0:
                    d0 = int(v[last_H0_t])
                    d1 = int(u[last_H0_t + 1])
                    if d0 > d1:
                        H0 += d0
                    else:
                        H0 += d1
                        last_H0_t += 1
                elif st0 <= last_H0_t <= en0:
                    H0 += int(v[last_H0_t])
                else:
                    last_H0_t += 1
                    H0 += int(u[last_H0_t])
            else:
                H0 = int(v[0]) - (q + e)
                last_H0_t = 0
            if (flag & KSW_EZ_APPROX_DROP) and _apply_zdrop(ez, H0, r, last_H0_t, zdrop, 0):
                break
            if r == qlen + tlen - 2 and en0 == tlen - 1:
                ez.score = H0
        last_st, last_en = st, en

    if with_cigar:
        rev_cigar = bool(flag & KSW_EZ_REV_CIGAR)
        if not ez.zdropped and not (flag & KSW_EZ_EXTZ_ONLY):
            ez.cigar = _backtrack_rot(p, off, off_end, n_col, tlen - 1, qlen - 1,
                                      rev_cigar, min_intron_len=long_thres)
        elif ez.max_t >= 0 and ez.max_q >= 0:
            ez.cigar = _backtrack_rot(p, off, off_end, n_col, ez.max_t, ez.max_q,
                                      rev_cigar, min_intron_len=long_thres)
    return ez
