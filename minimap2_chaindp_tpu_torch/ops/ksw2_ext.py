"""ksw2 extension: the hand-written CUDA kernels (csrc/ksw2.cu) and their
plain PyTorch versions, behind the JAX package's batch API.

Port of minimap2_chaindp_tpu/ops/ksw2_pallas.py: `extd2_batch(_async)` and
`exts2_batch(_async)` keep their signatures and the three-stage protocol
(the call dispatches and returns collect_ez; collect_ez() reads the scores
and returns collect_bt; collect_bt() returns the list of K.Ez), plus a
`device` keyword: on a CUDA device the kernels launch, on the CPU the plain
versions run. `interpret`, `quantize` and `backtrack` are accepted and
change nothing: the CIGAR always comes from the walk, run where the
forward pass ran, so `p` never leaves the device.

Two wrappers launch the kernels. `ksw_forward` runs the anti-diagonal DP,
writing each job's backtrack bytes `p` in the reference's flat layout and
its ez row: `ksw2_pack.launch_plan` makes the call one block-per-job
launch with the rows in shared memory, plus a launch with the rows in
device memory for jobs too wide for it, each longest job first. `ksw_walk` runs the CIGAR walk over
`p`, a warp per job over windows of `p`. A wave is cut into calls whose
`p` bytes stay within a budget
(`P_BUDGET`, read at each call), so an unbanded 16 kb splice job (about
0.5 GB of `p`) cannot exhaust the card.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from . import ksw2 as K
from .ksw2_pack import (C_FIN_I, C_FIN_J, C_FIN_K, C_MAX, C_MAX_Q, C_MAX_T,
                        C_MQE, C_MQE_T, C_MTE, C_MTE_Q, C_SCORE, C_ZDROP,
                        EZ_COLS, M_ADROP, M_APPROX, M_ENDB, M_EXTZ, M_NCOL,
                        M_OPOFF, M_QLEN, M_QOFF, M_RIGHT, M_SCONLY, M_TLEN,
                        M_TOFF, M_W, M_ZDROP, _decode_walk, _ez_from_row,
                        gap_params, pack_jobs, split_by_budget)

P_BUDGET = 2 << 30      # backtrack bytes per forward launch
# pack_jobs' arrays that go to the device, in the wrappers' argument order
TENSOR_KEYS = ("tseq", "qrev", "dac", "meta", "poff", "order")
_launch_lock = threading.Lock()   # map_stream launches from two threads


def _kernel_device(t: torch.Tensor) -> bool:
    """True when `t` lies on a CUDA device (launch the kernel), False on
    the CPU (run the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"ksw2 runs on cuda or cpu, not {t.device}")


def _check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------- wrappers
_VARIANT_CODE = {"block": 0, "global": 1}


def _stream(dev):
    """PyTorch's current stream on `dev`, as the pointer the C entries
    take."""
    return torch.cuda.current_stream(dev).cuda_stream


def ksw_forward(tseq, qrev, dac, meta, poff, order, *, groups, scoring,
                splice, p_bytes, t_total, band_max, rows_max):
    """Forward DP of every job in `meta`; returns (p, ez): p uint8
    (p_bytes,) the flat backtrack bytes, ez int32 (R, EZ_COLS).
    scoring = (q, e, q2, e2, mat0, sc_mis, sc_n, long_thres, long_diff)
    after the gap-profile swap. Inputs are pack_jobs' arrays as tensors on
    one device; `order` and `groups` are `launch_plan`'s. Each group is one
    launch of its variant of the kernel on a CUDA device; on the CPU each
    group runs through `ksw_forward_ref`."""
    on_card = _kernel_device(meta)
    dev = meta.device
    R = meta.shape[0]
    ez = torch.empty((R, EZ_COLS), dtype=torch.int32, device=dev)
    if not on_card:
        p = torch.zeros(max(p_bytes, 1), dtype=torch.uint8)
        for g in groups:
            idx = order[g["start"]:g["start"] + g["count"]].long()
            sub = meta[idx]
            rows = int((sub[:, M_QLEN] + sub[:, M_TLEN] - 1).max())
            p_g, ez_g = ksw_forward_ref(
                tseq, qrev, dac, sub, poff[idx], scoring=scoring,
                splice=splice, p_bytes=p_bytes, t_total=t_total,
                band_max=band_max, rows_max=rows)
            p |= p_g          # the groups' bytes do not overlap
            ez[idx] = ez_g
        return p, ez
    from ._build import load
    lib = load()
    p = torch.empty(max(p_bytes, 1), dtype=torch.uint8, device=dev)
    state = hrow = None
    if any(g["variant"] == "global" for g in groups):
        state = torch.empty(7 * t_total, dtype=torch.int8, device=dev)
        hrow = torch.empty(t_total, dtype=torch.int32, device=dev)
    for g in groups:
        with torch.cuda.device(dev):
            rc = lib.mm2tpu_ksw_forward(
                *(t.data_ptr() for t in (tseq, qrev, dac, meta, poff)),
                order.data_ptr() + 4 * g["start"],
                state.data_ptr() if state is not None else None,
                hrow.data_ptr() if hrow is not None else None,
                p.data_ptr(), ez.data_ptr(), t_total, g["count"], *scoring,
                int(splice), _VARIANT_CODE[g["variant"]], g["ring"],
                g["threads"], _stream(dev))
        _check(rc, f"ksw forward ({g['variant']})")
        with _launch_lock:
            ksw_forward.launches += 1
            ksw_forward.by_variant[g["variant"]] += 1
    return p, ez


ksw_forward.launches = 0
ksw_forward.by_variant = {"block": 0, "global": 0}


def ksw_walk(p, poff, meta, order, ez, *, splice, ops_total):
    """Backtrack walk of every job that needs a CIGAR; returns ops int8
    (ops_total,) step codes at each job's meta[M_OPOFF] and writes fin
    (i, j, k) into ez's C_FIN_* columns. The last len(meta) entries of
    `order` are `launch_plan`'s walk order. CUDA tensors launch the kernel,
    CPU tensors run `ksw_walk_ref`."""
    if not _kernel_device(meta):
        return ksw_walk_ref(p, poff, meta, ez, splice=splice,
                            ops_total=ops_total)
    from ._build import load
    lib = load()
    dev = meta.device
    R = meta.shape[0]
    ops = torch.empty(max(ops_total, 1), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mm2tpu_ksw_walk(
            p.data_ptr(), poff.data_ptr(), meta.data_ptr(),
            order.data_ptr() + 4 * (order.numel() - R), ez.data_ptr(),
            ops.data_ptr(), R, int(splice), _stream(dev))
    _check(rc, "ksw walk")
    with _launch_lock:
        ksw_walk.launches += 1
    return ops


ksw_walk.launches = 0


# ---------------------------------------------------------- plain versions
def _w8(x):
    """int8 wraparound of an int32 tensor (sign-extend the low byte)."""
    return ((x & 255) ^ 128) - 128


def _band(r, qlen, tlen, w, splice):
    """Live and 16-aligned band of diagonal r (ksw2_pallas.py:70-81)."""
    st0 = torch.clamp(r - qlen + 1, min=0)
    en0 = torch.minimum(tlen - 1, r if torch.is_tensor(r)
                        else torch.full_like(tlen, r))
    if not splice:
        st0 = torch.maximum(st0, (r - w + 1) >> 1)
        en0 = torch.minimum(en0, (r + w) >> 1)
    return st0, en0, st0 // 16 * 16, (en0 + 16) // 16 * 16 - 1


def _f_seed(r, scoring, splice):
    q, e, _q2, e2, _m, _mis, _n, long_thres, long_diff = scoring
    if r == 0:
        return -(q + e)
    if r < long_thres:
        return -e
    if r == long_thres:
        return long_diff
    return 0 if splice else -e2


def ksw_forward_ref(tseq, qrev, dac, meta, poff, *, scoring, splice,
                    p_bytes, t_total, band_max, rows_max):
    """Plain PyTorch version of the forward kernel on any device: a loop
    over anti-diagonals r, vectorized over jobs and over each job's band
    (lane k is t = st + k). Same outputs as `ksw_forward`."""
    del t_total
    q, e, q2, e2, mat0, sc_mis, sc_n, _lt, _ld = scoring
    dev = meta.device
    i32, i64 = torch.int32, torch.int64
    R = meta.shape[0]
    col = lambda c: meta[:, c].to(i64)
    qlen, tlen, w, zdrop = col(M_QLEN), col(M_TLEN), col(M_W), col(M_ZDROP)
    ncol = col(M_NCOL)
    cig = ncol > 0
    right = cig & (meta[:, M_RIGHT] != 0)
    approx = meta[:, M_APPROX] != 0
    adrop = meta[:, M_ADROP] != 0
    nrows = qlen + tlen - 1
    qe, qe2 = q + e, q2 + e2
    x2_init = -q2 if splice else -qe2
    ze = 0 if splice else e2
    tsz = (tlen + 15) // 16 * 16 + 32
    TW = int(tsz.max()) + band_max if R else 1
    QW = int(qlen.max()) + 16 if R else 1
    lane = torch.arange(TW, dtype=i64, device=dev)[None, :]
    tidx = (col(M_TOFF)[:, None] + lane).clamp(max=max(len(tseq) - 1, 0))
    tmask = lane < tsz[:, None]
    sf = torch.where(tmask, tseq.to(i64)[tidx], 0)
    sig = torch.where(tmask, dac.to(i64)[tidx], 0)
    qlane = torch.arange(QW, dtype=i64, device=dev)[None, :]
    qr = torch.where(qlane < (qlen + 16)[:, None],
                     qrev.to(i64)[(col(M_QOFF)[:, None] + qlane)
                                  .clamp(max=max(len(qrev) - 1, 0))], 0)
    full = lambda v: torch.full((R, TW), v, dtype=i64, device=dev)
    u, v, x, y = full(-qe), full(-qe), full(-qe), full(-qe)
    x2, y2, s = full(x2_init), full(x2_init), full(0)
    H = full(K.KSW_NEG_INF)
    sc = lambda v: torch.full((R,), v, dtype=i64, device=dev)
    mx, mx_t, mx_q = sc(0), sc(-1), sc(-1)
    mqe, mqe_t, mte, mte_q = sc(K.KSW_NEG_INF), sc(-1), sc(K.KSW_NEG_INF), \
        sc(-1)
    score, zdropped = sc(K.KSW_NEG_INF), torch.zeros(R, dtype=torch.bool,
                                                      device=dev)
    done = zdropped.clone()
    last_st, last_en, H0, h0t = sc(-1), sc(-1), sc(0), sc(0)
    p = torch.zeros(max(p_bytes, 1), dtype=torch.uint8, device=dev)
    k = torch.arange(band_max, dtype=i64, device=dev)[None, :]
    g = lambda a, idx: a.gather(1, idx)
    g1 = lambda a, idx: a.gather(1, idx[:, None])[:, 0]

    def put(a, idx, val, mask):
        a.scatter_(1, idx, torch.where(mask, val, g(a, idx)))

    for r in range(rows_max):
        act = (r < nrows) & ~done
        st0, en0, st, en = _band(r, qlen, tlen, w, splice)
        closed = act & (st0 > en0)
        zdropped |= closed
        done |= closed
        act &= ~closed
        st = torch.where(act, st, 0)
        en = torch.where(act, en, -1)
        st0 = torch.where(act, st0, 0)
        en0 = torch.where(act, en0, 0)
        # boundary values at lane st-1 from the previous row
        prev = (st - 1).clamp(min=0)
        in_last = (st > 0) & (last_st <= st - 1) & (st - 1 <= last_en)
        x1 = torch.where(in_last, g1(x, prev), -qe)
        x21 = torch.where(in_last, g1(x2, prev), x2_init)
        v1 = torch.where(st > 0, torch.where(in_last, g1(v, prev), -qe),
                         _f_seed(r, scoring, splice))
        t = st[:, None] + k
        s_end = st0 + 16 * ((en0 - st0) // 16 + 1)
        in_band = act[:, None] & (t <= en[:, None])
        in_s = act[:, None] & (t >= st0[:, None]) & (t < s_end[:, None])
        qb = (qlen - 1 - r)[:, None] + t
        sq = g(sf, t)
        stq = g(qr, qb.clamp(0, QW - 1))
        s_new = torch.where((sq == 4) | (stq == 4), sc_n,
                            torch.where(sq == stq, mat0, sc_mis))
        z = torch.where(in_s, s_new, g(s, t))
        put(s, t, s_new, in_s)
        first = k == 0
        tm1 = (t - 1).clamp(min=0)
        inj = act[:, None] & (en >= r)[:, None] & (t == r)
        u_old, y_old, y2_old = g(u, t), g(y, t), g(y2, t)
        ut = torch.where(inj, _f_seed(r, scoring, splice), u_old)
        yt = torch.where(inj, -qe, y_old)
        y2t = torch.where(inj, -qe2, y2_old)
        xt1 = torch.where(first, x1[:, None], g(x, tm1))
        x2t1 = torch.where(first, x21[:, None], g(x2, tm1))
        vt1 = torch.where(first, v1[:, None], g(v, tm1))
        a = _w8(xt1 + vt1)
        b = _w8(yt + ut)
        a2 = _w8(x2t1 + vt1)
        if splice:
            st_sig = g(sig, t)
            dn = _w8(st_sig)
            a2c = _w8(a2 + _w8(st_sig >> 8))
            b2 = None
        else:
            b2 = _w8(y2t + ut)
            a2c = a2
        rt = right[:, None]
        d = torch.where(rt, torch.where(z > a, 0, 1), torch.where(a > z, 1, 0))
        z = torch.maximum(z, a)
        d = torch.where(rt, torch.where(z > b, d, 2), torch.where(b > z, 2, d))
        z = torch.maximum(z, b)
        d = torch.where(rt, torch.where(z > a2c, d, 3),
                        torch.where(a2c > z, 3, d))
        z = torch.maximum(z, a2c)
        if not splice:
            d = torch.where(rt, torch.where(z > b2, d, 4),
                            torch.where(b2 > z, 4, d))
            z = torch.maximum(z, b2).clamp(max=mat0)
        un = _w8(z - vt1)
        vn = _w8(z - ut)
        tmp = _w8(z - q)
        ax = _w8(a - tmp)
        bx = _w8(b - tmp)
        a2x = _w8(a2 - _w8(z - q2))
        thr = torch.where(rt, -1, 0)
        ca, cb = ax > thr, bx > thr
        d = d | torch.where(ca, 0x08, 0) | torch.where(cb, 0x10, 0)
        xn = _w8(torch.where(ca, ax, 0) - qe)
        yn = _w8(torch.where(cb, bx, 0) - qe)
        if splice:
            ca2 = torch.where(rt, a2x >= dn, a2x > dn)
            x2n = _w8(torch.where(ca2, a2x, dn) - q2)
            d = d | torch.where(ca2, 0x20, 0)
        else:
            b2x = _w8(b2 - _w8(z - q2))
            ca2, cb2 = a2x > thr, b2x > thr
            x2n = _w8(torch.where(ca2, a2x, 0) - qe2)
            put(y2, t, _w8(torch.where(cb2, b2x, 0) - qe2), in_band)
            d = d | torch.where(ca2, 0x20, 0) | torch.where(cb2, 0x40, 0)
        put(u, t, un, in_band)
        put(v, t, vn, in_band)
        put(x, t, xn, in_band)
        put(y, t, yn, in_band)
        put(x2, t, x2n, in_band)
        pm = in_band & cig[:, None]
        pidx = poff[:, None] + r * ncol[:, None] + k
        p[pidx[pm]] = d[pm].to(torch.uint8)

        # exact H row and its maximum in the reference's scan order
        ex = act & ~approx
        h_m1 = g1(H, (en0 - 1).clamp(min=0))
        h_en0 = g1(H, en0)
        hcur = g(H, t)
        is_en0 = t == en0[:, None]
        h_top = vn - qe if r == 0 else torch.where(
            (en0 > 0)[:, None], h_m1[:, None] + un, h_en0[:, None] + vn)
        hn = torch.where(is_en0, h_top, hcur + vn)
        upd = in_band & ex[:, None] & (t >= st0[:, None]) & (t <= en0[:, None])
        put(H, t, hn, upd)
        en1 = st0 + (en0 - st0) // 4 * 4
        nr4 = ((en1 - st0) >> 2).clamp(min=1)
        off = t - st0[:, None]
        key = torch.where(is_en0, 0,
                          torch.where(t < en1[:, None],
                                      1 + (off & 3) * nr4[:, None]
                                      + (off >> 2), 0x10000000 + t))
        hv = torch.where(upd, hn, K.KSW_NEG_INF * 4)
        max_h = hv.max(dim=1).values
        kk = torch.where(upd & (hv == max_h[:, None]), key,
                         0x7FFFFFFF).min(dim=1).values
        max_t = torch.where(kk == 0, en0,
                            torch.where(kk >= 0x10000000, kk - 0x10000000,
                                        st0 + ((kk - 1) % nr4) * 4
                                        + (kk - 1) // nr4))
        h_en0 = g1(H, en0)
        mte_upd = ex & (en0 == tlen - 1) & (h_en0 > mte)
        mte = torch.where(mte_upd, h_en0, mte)
        mte_q = torch.where(mte_upd, r - en, mte_q)
        h_st0 = g1(H, st0)
        mqe_upd = ex & (r - st0 == qlen - 1) & (h_st0 > mqe)
        mqe = torch.where(mqe_upd, h_st0, mqe)
        mqe_t = torch.where(mqe_upd, st0, mqe_t)

        # approximate max: the greedy H0 path
        apx = act & approx
        v0, u1 = g1(v, h0t), g1(u, (h0t + 1).clamp(max=TW - 1))
        both = (st0 <= h0t) & (h0t + 1 <= en0)
        one = (st0 <= h0t) & (h0t <= en0)
        h0_new = torch.where(
            both, H0 + torch.where(v0 > u1, v0, u1),
            torch.where(one, H0 + v0, H0 + u1))
        h0t_new = torch.where(both, torch.where(v0 > u1, h0t, h0t + 1),
                              torch.where(one, h0t, h0t + 1))
        if r == 0:
            h0_new = g1(v, torch.zeros_like(h0t)) - qe
            h0t_new = torch.zeros_like(h0t)
        H0 = torch.where(apx, h0_new, H0)
        h0t = torch.where(apx, h0t_new, h0t)

        # ksw_apply_zdrop on H (exact) or H0 (approx with APPROX_DROP)
        zj = ex | (apx & adrop)
        hval = torch.where(ex, max_h, H0)
        tval = torch.where(ex, max_t, h0t)
        bet = zj & (hval > mx)
        cand = zj & ~bet & (tval >= mx_t) & (r - tval >= mx_q)
        ll = ((tval - mx_t) - ((r - tval) - mx_q)).abs()
        dropped = cand & (zdrop >= 0) & (mx - hval > zdrop + ll * ze)
        mx = torch.where(bet, hval, mx)
        mx_t = torch.where(bet, tval, mx_t)
        mx_q = torch.where(bet, r - tval, mx_q)
        zdropped |= dropped
        fin = act & ~dropped & (r == nrows - 1) & (en0 == tlen - 1)
        score = torch.where(fin, torch.where(approx, H0, h_en0), score)
        done |= dropped | (act & (r == nrows - 1))
        last_st = torch.where(act, st, last_st)
        last_en = torch.where(act, en, last_en)

    ez = torch.zeros((R, EZ_COLS), dtype=i32, device=dev)
    for c, val in ((C_MAX, mx), (C_MAX_T, mx_t), (C_MAX_Q, mx_q),
                   (C_MQE, mqe), (C_MQE_T, mqe_t), (C_MTE, mte),
                   (C_MTE_Q, mte_q), (C_SCORE, score),
                   (C_ZDROP, zdropped.to(i64))):
        ez[:, c] = val.to(i32)
    return p, ez


def ksw_walk_ref(p, poff, meta, ez, *, splice, ops_total):
    """Plain PyTorch version of the walk kernel: a loop over walk steps,
    vectorized over jobs. Same outputs as `ksw_walk`."""
    dev = meta.device
    i64 = torch.int64
    col = lambda c: meta[:, c].to(i64)
    qlen, tlen, w, ncol = col(M_QLEN), col(M_TLEN), col(M_W), col(M_NCOL)
    ezl = ez.to(i64)
    zdropped = ezl[:, C_ZDROP] != 0
    extz = meta[:, M_EXTZ] != 0
    reach_end = extz & ~zdropped & (ezl[:, C_MQE] + col(M_ENDB)
                                    > ezl[:, C_MAX])
    if splice:
        reach_end = torch.zeros_like(reach_end)
    full = ~zdropped & ~extz
    have_max = (ezl[:, C_MAX_T] >= 0) & (ezl[:, C_MAX_Q] >= 0)
    walk = (meta[:, M_SCONLY] == 0) & (reach_end | full | have_max)
    i = torch.where(reach_end, ezl[:, C_MQE_T],
                    torch.where(full, tlen - 1, ezl[:, C_MAX_T]))
    j = torch.where(reach_end | full, qlen - 1, ezl[:, C_MAX_Q])
    i = torch.where(walk, i, -1)
    j = torch.where(walk, j, -1)
    state = torch.zeros_like(i)
    kk = torch.zeros_like(i)
    ops = torch.zeros(max(ops_total, 1), dtype=torch.int8, device=dev)
    steps = int((i + j + 2).clamp(min=0).max()) if len(i) else 0
    base = poff.to(i64)
    for _ in range(steps):
        live = (i >= 0) & (j >= 0)
        r = (i + j).clamp(min=0)
        _st0, _en0, st, en = _band(r, qlen, tlen, w, splice)
        force = torch.where(i < st, 2, torch.where(i > en, 1, -1))
        at = (base + r * ncol + (i - st)).clamp(0, max(len(p) - 1, 0))
        tmp = torch.where(live & (force < 0), p[at].to(i64), 0)
        state = torch.where(state == 0, tmp & 7,
                            torch.where((tmp >> (state + 2)) & 1 == 1,
                                        state, 0))
        state = torch.where(state == 0, tmp & 7, state)
        state = torch.where(force >= 0, force, state)
        oat = (col(M_OPOFF) + kk).clamp(max=max(ops_total - 1, 0))
        ops[oat[live]] = state[live].to(torch.int8)
        is_m = state == 0
        is_del = (state == 1) | (state == 3)
        i = torch.where(live & (is_m | is_del), i - 1, i)
        j = torch.where(live & (is_m | ~is_del), j - 1, j)
        kk = torch.where(live, kk + 1, kk)
        state = torch.where(live, state, 0)
    ez[:, C_FIN_I] = torch.where(walk, i, -1).to(ez.dtype)
    ez[:, C_FIN_J] = torch.where(walk, j, -1).to(ez.dtype)
    ez[:, C_FIN_K] = kk.to(ez.dtype)
    return ops


# --------------------------------------------------------------- batch API
def forward_scoring(mat, gaps, *, splice) -> tuple:
    """ksw_forward's `scoring` from the score matrix and gap_params."""
    q, e, q2, e2, long_thres, long_diff = gaps
    if -int(np.asarray(mat).min()) > 2 * (q + e) or (splice and q2 <= q + e):
        raise ValueError("scoring outside the kernel's domain (the "
                         "reference returns an empty result)")
    mat0, sc_mis = int(mat[0]), int(np.int8(mat[1]))
    return (q, e, q2, e2, mat0, sc_mis, -e if splice else -e2, long_thres,
            long_diff)


def _batch_async(jobs, mat, gaps, *, splice, noncan, device):
    scoring = forward_scoring(mat, gaps, splice=splice)
    long_thres = gaps[4]
    dev = torch.device(device)
    staged = []
    for idxs in split_by_budget(jobs, splice, P_BUDGET):
        grp = [jobs[i] for i in idxs]
        pk = pack_jobs(grp, splice=splice, noncan=noncan)
        ts = {k: torch.from_numpy(pk[k]).to(dev) for k in TENSOR_KEYS}
        p, ez = ksw_forward(
            *(ts[k] for k in TENSOR_KEYS), groups=pk["groups"],
            scoring=scoring, splice=splice, p_bytes=pk["p_bytes"],
            t_total=pk["t_total"], band_max=pk["band_max"],
            rows_max=pk["rows_max"])
        ops = ksw_walk(p, ts["poff"], ts["meta"], ts["order"], ez,
                       splice=splice, ops_total=pk["ops_total"])
        staged.append((grp, pk, ez, ops))

    def collect_ez():
        out_all = []
        for grp, pk, ez, ops in staged:
            ez_h = ez.cpu().numpy()
            out = [_ez_from_row(ez_h[j]) for j in range(len(grp))]
            ops_h = ops.cpu().numpy()
            ops_l = [ops_h[int(o):] for o in pk["meta"][:, M_OPOFF]]
            _decode_walk(grp, out, ez_h, ops_l, splice=splice,
                         long_thres=long_thres)
            out_all.extend(out)
        return lambda: out_all
    return collect_ez


def extd2_batch(jobs, mat, q, e, q2, e2, interpret=False, quantize=False,
                backtrack="host", device="cuda"):
    """Batched ksw_extd2: extd2_batch_async run to its end."""
    return extd2_batch_async(jobs, mat, q, e, q2, e2, interpret=interpret,
                             quantize=quantize, backtrack=backtrack,
                             device=device)()()


def extd2_batch_async(jobs, mat, q, e, q2, e2, interpret=False,
                      quantize=False, backtrack="host", device="cuda"):
    """Batched ksw_extd2 with K.extd2's per-job semantics; jobs are dicts
    (qseq, tseq, w, zdrop, end_bonus, flag). Dispatches and returns
    collect_ez (see the module docstring)."""
    del interpret, quantize, backtrack
    return _batch_async(jobs, mat, gap_params(q, e, q2, e2, False),
                        splice=False, noncan=0, device=device)


def exts2_batch(jobs, mat, q, e, q2, noncan, interpret=False,
                quantize=False, backtrack="host", device="cuda"):
    """Batched ksw_exts2: exts2_batch_async run to its end."""
    return exts2_batch_async(jobs, mat, q, e, q2, noncan,
                             interpret=interpret, quantize=quantize,
                             backtrack=backtrack, device=device)()()


def exts2_batch_async(jobs, mat, q, e, q2, noncan, interpret=False,
                      quantize=False, backtrack="host", device="cuda"):
    """Batched splice extension with ksw2_splice.exts2's per-job
    semantics (unbanded); jobs are dicts (qseq, tseq, zdrop, flag)."""
    del interpret, quantize, backtrack
    return _batch_async(jobs, mat, gap_params(q, e, q2, 0, True),
                        splice=True, noncan=noncan, device=device)
