# Frozen copy of minimap2_chaindp_tpu/ops/chain.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/ops/chain.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Chaining DP — exact host golden model.

Implements the reference's split offload contract exactly:
  * score/predecessor scan with the banded sliding window, max_skip early
    break, and float32 avg_qspan gap cost (reference chain.c:246-284)
  * compact "new_seed" array construction with p = pred<<2 | not_peak<<1 | alive
    (chain.c:286-316) — the FPGA kernel contract; compact-index order matters
    for downstream tie-breaking, so it is reproduced bit-exactly
  * bottom half: chain-end marking, score sort, peak-walk backtrack,
    min_cnt/min_sc filters, and re-sort of chains by first-anchor x
    (chain.c:329-431)

This is the golden model the Pallas kernel (ops/chain_pallas.py) is validated
against; it is also the production fallback for overflow reads.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C


@dataclass
class Chains:
    anchors: np.ndarray  # (n_v, 2) uint64 — per-chain anchors, concatenated
    u: np.ndarray        # (n_u,) uint64 — score<<32 | n_anchors, chains sorted by first-anchor x


def chain_dp(max_dist_x: int, max_dist_y: int, bw: int, max_skip: int,
             min_cnt: int, min_sc: int, is_cdna: bool, n_segs: int,
             anchors: np.ndarray) -> Chains:
    n = len(anchors)
    empty = Chains(np.empty((0, 2), dtype=np.uint64), np.empty(0, dtype=np.uint64))
    if n == 0:
        return empty
    ax = [int(v) for v in anchors[:, 0]]
    ay = [int(v) for v in anchors[:, 1]]
    f, p, t, v = [0] * n, [0] * n, [0] * n, [0] * n
    seg_of = [(y & C.MM_SEED_SEG_MASK) >> C.MM_SEED_SEG_SHIFT for y in ay]
    qpos = [y & 0xFFFFFFFF for y in ay]
    span = [(y >> 32) & 0xFF for y in ay]
    avg_qspan = float(np.float32(sum(span)) / np.float32(n))  # f32 division, chain.c:47

    # compact output (the offload contract)
    cseed_x: list[int] = []
    cseed_y: list[int] = []
    cf: list[int] = []
    cp: list[int] = []
    fpga_id = [-1] * n

    st = 0
    for i in range(n):
        ri = ax[i]
        qi = qpos[i]
        q_span = span[i]
        sidi = seg_of[i]
        max_f, max_j, n_skip = q_span, -1, 0
        while st < i and ri - ax[st] > max_dist_x:
            st += 1
        for j in range(i - 1, st - 1, -1):
            dr = ri - ax[j]
            dq = qi - qpos[j]
            sidj = seg_of[j]
            if (sidi == sidj and dr == 0) or dq <= 0:
                continue
            if (sidi == sidj and dq > max_dist_y) or dq > max_dist_x:
                continue
            dd = dr - dq if dr > dq else dq - dr
            if sidi == sidj and dd > bw:
                continue
            if n_segs > 1 and not is_cdna and sidi == sidj and dr > max_dist_y:
                continue
            min_d = dq if dq < dr else dr
            sc = q_span if min_d > q_span else min_d
            log_dd = C.ilog2_32(dd) if dd else 0
            if is_cdna or sidi != sidj:
                c_lin = int(dd * .01 * avg_qspan)
                c_log = log_dd
                if sidi != sidj and dr == 0:
                    sc += 1  # overlapping paired-end bonus
                elif dr > dq or sidi != sidj:
                    sc -= c_lin if c_lin < c_log else c_log
                else:
                    sc -= c_lin + (c_log >> 1)
            else:
                sc -= int(dd * .01 * avg_qspan) + (log_dd >> 1)
            sc += f[j]
            if sc > max_f:
                max_f, max_j = sc, j
                if n_skip > 0:
                    n_skip -= 1
            elif t[j] == i:
                n_skip += 1
                if n_skip > max_skip:
                    break
            if p[j] >= 0:
                t[p[j]] = i
        f[i], p[i] = max_f, max_j
        v[i] = v[max_j] if max_j >= 0 and v[max_j] > max_f else max_f

        # compact-array append (chain.c:286-316); predecessors not yet emitted
        # are appended first, so compact order is NOT monotone in i
        if max_j >= 0:
            if fpga_id[max_j] == -1:
                cseed_x.append(ax[max_j])
                cseed_y.append(ay[max_j])
                cf.append(f[max_j])
                cp.append((-1 << 2) | (1 if v[max_j] >= min_sc else 0)
                          | ((1 if f[max_j] < v[max_j] else 0) << 1))
                fpga_id[max_j] = len(cp) - 1
        alive = v[i] >= min_sc
        if alive or max_j >= 0:
            cseed_x.append(ax[i])
            cseed_y.append(ay[i])
            cf.append(f[i])
            pred = fpga_id[max_j] if max_j >= 0 else -1
            cp.append((pred << 2) | (1 if alive else 0)
                      | ((1 if f[i] < v[i] else 0) << 1))
            fpga_id[i] = len(cp) - 1

    return chain_backtrack(np.array(cseed_x, dtype=np.uint64),
                           np.array(cseed_y, dtype=np.uint64),
                           cf, cp, min_cnt, min_sc)


def chain_backtrack(cseed_x: np.ndarray, cseed_y: np.ndarray,
                    cf: list[int], cp: list[int],
                    min_cnt: int, min_sc: int) -> Chains:
    """Bottom half (reference mm_chain_dp_bottom, chain.c:329-431)."""
    empty = Chains(np.empty((0, 2), dtype=np.uint64), np.empty(0, dtype=np.uint64))
    new_i = len(cp)
    if new_i == 0:
        return empty

    # chain ends: alive and not a predecessor of any compact entry
    t = [0] * new_i
    for i in range(new_i):
        if cp[i] >= 0:
            t[cp[i] >> 2] = 1
    ends = [i for i in range(new_i) if (cp[i] & 1) and t[i] == 0]
    if not ends:
        return empty

    u = []
    for i in ends:
        j = i
        while j >= 0 and (cp[j] & 2):  # walk to the peak (f == v)
            j = cp[j] >> 2
        if j < 0:
            j = i
        u.append((cf[j] << 32) | j)
    u = np.sort(np.array(u, dtype=np.uint64))[::-1]

    # backtrack from highest score
    t = [0] * new_i
    n_v = 0
    v_idx: list[int] = []
    out_u: list[int] = []
    for ui in u:
        ui = int(ui)
        n_v0 = n_v
        j = ui & 0xFFFFFFFF
        while True:
            v_idx.append(j)
            n_v += 1
            t[j] = 1
            j = cp[j] >> 2
            if not (j >= 0 and t[j] == 0):
                break
        if j < 0:
            if n_v - n_v0 >= min_cnt:
                out_u.append((ui >> 32 << 32) | (n_v - n_v0))
                continue
        elif (ui >> 32) - cf[j] >= min_sc:
            if n_v - n_v0 >= min_cnt:
                out_u.append((((ui >> 32) - cf[j]) << 32) | (n_v - n_v0))
                continue
        n_v = n_v0  # no chain added, reset
        del v_idx[n_v0:]

    n_u = len(out_u)
    if n_u == 0:
        return empty

    # emit per-chain anchors in forward order
    b = np.empty((n_v, 2), dtype=np.uint64)
    k = 0
    for ui in out_u:
        ni = ui & 0xFFFFFFFF
        idx = v_idx[k:k + ni][::-1]
        b[k:k + ni, 0] = cseed_x[idx]
        b[k:k + ni, 1] = cseed_y[idx]
        k += ni

    # sort chains by first-anchor x (for mm_join_long), chain.c:410-426
    firsts = np.empty(n_u, dtype=np.uint64)
    offs = np.empty(n_u, dtype=np.int64)
    k = 0
    for i, ui in enumerate(out_u):
        firsts[i] = b[k, 0]
        offs[i] = k
        k += ui & 0xFFFFFFFF
    order = np.argsort(firsts, kind="stable")
    a_out = np.empty_like(b)
    u_out = np.empty(n_u, dtype=np.uint64)
    k = 0
    for i, j in enumerate(order):
        ni = out_u[j] & 0xFFFFFFFF
        u_out[i] = out_u[j]
        a_out[k:k + ni] = b[offs[j]:offs[j] + ni]
        k += ni
    return Chains(a_out, u_out)
