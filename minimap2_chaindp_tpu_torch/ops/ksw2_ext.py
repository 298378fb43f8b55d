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

Three wrappers launch the kernels. `splice_signal` computes an exts2
wave's donor/acceptor signal from the uploaded targets, a block per job.
`ksw_forward` runs the anti-diagonal DP,
writing each job's backtrack bytes `p` in the reference's flat layout and
its ez row: `ksw2_pack.launch_plan` makes the call one block-per-job
launch with the rows in shared memory, plus a launch with the rows in
device memory for jobs too wide for it, each longest job first. `ksw_walk` runs the CIGAR walk over
`p`, a warp per job over windows of `p`. A wave is cut into calls whose
`p` bytes stay within a budget
(`P_BUDGET`, read at each call), so an unbanded 16 kb splice job (about
0.5 GB of `p`) cannot exhaust the card; the wave's longest jobs share the
first calls (`split_by_budget`). A batch call runs on a CUDA stream of its
thread's own (`_own_stream`).
"""
from __future__ import annotations

import threading
from contextlib import nullcontext

import numpy as np
import torch

from . import ksw2 as K
from .ksw2_pack import (C_FIN_I, C_FIN_J, C_FIN_K, C_MAX, C_MAX_Q, C_MAX_T,
                        C_MQE, C_MQE_T, C_MTE, C_MTE_Q, C_SCORE, C_ZDROP,
                        EZ_COLS, M_ADROP, M_APPROX, M_ENDB, M_EXTZ, M_NCOL,
                        M_OPOFF, M_QLEN, M_QOFF, M_RIGHT, M_SCONLY, M_SPLICE,
                        M_TLEN, M_TOFF, M_W, M_ZDROP, _decode_walk,
                        _ez_from_row, donor_acceptor, gap_params, n_col_of,
                        pack_jobs, split_by_budget)
from ..utils.trace import active

P_BUDGET = 2 << 30      # backtrack bytes per forward launch
# pack_jobs' arrays that go to the device
TENSOR_KEYS = ("tseq", "qrev", "meta", "poff", "order")
# ksw_forward's tensors, in its argument order: the uploaded arrays and the
# splice signal computed on the device from them (`device_inputs`)
FORWARD_KEYS = ("tseq", "qrev", "dac", "meta", "poff", "order")
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


def device_inputs(pk, dev, *, splice):
    """pack_jobs' arrays `pk` as tensors on `dev`, and the splice signal
    `dac` computed there from them, on the upload's stream (`splice_signal`;
    None for extd2): the tensors of FORWARD_KEYS, by name."""
    ts = {k: torch.from_numpy(pk[k]).to(dev) for k in TENSOR_KEYS}
    ts["dac"] = splice_signal(ts["tseq"], ts["meta"], t_total=pk["t_total"],
                              noncan=pk["noncan"]) if splice else None
    return ts


def splice_signal(tseq, meta, *, t_total, noncan):
    """The splice signal of every job of an exts2 wave: dac int16
    (t_total,), each job's donor (low byte) and acceptor (high byte) at
    meta[M_TOFF] over its tlen16 positions, packed as
    ksw2_pallas.py:1053-1055, from its target in `tseq` and its
    meta[M_SPLICE] flags (ksw2_pack.donor_acceptor, job by job); 0 in
    each job's T_PAD slack. CUDA tensors launch the kernel, a block per
    job; CPU tensors run `splice_signal_ref`."""
    if not _kernel_device(meta):
        return splice_signal_ref(tseq, meta, t_total=t_total, noncan=noncan)
    from ._build import load
    lib = load()
    dev = meta.device
    dac = torch.empty(t_total, dtype=torch.int16, device=dev)
    with torch.cuda.device(dev):
        rc = lib.mm2tpu_ksw_splice_signal(
            tseq.data_ptr(), meta.data_ptr(), dac.data_ptr(), meta.shape[0],
            int(noncan), _stream(dev))
    _check(rc, "ksw splice signal")
    with _launch_lock:
        splice_signal.launches += 1
    return dac


splice_signal.launches = 0


def ksw_forward(tseq, qrev, dac, meta, poff, order, *, groups, scoring,
                splice, p_bytes, t_total, band_max, rows_max):
    """Forward DP of every job in `meta`; returns (p, ez): p uint8
    (p_bytes,) the flat backtrack bytes, ez int32 (R, EZ_COLS).
    scoring = (q, e, q2, e2, mat0, sc_mis, sc_n, long_thres, long_diff)
    after the gap-profile swap. Inputs are `device_inputs`' tensors on one
    device (`dac` is read only under splice, and may be None without it);
    `order` and `groups` are `launch_plan`'s. Each group is one launch of
    its variant of the kernel on a CUDA device; on the CPU each group runs
    through `ksw_forward_ref`."""
    if splice and dac is None:
        raise ValueError("an exts2 launch needs its splice signal")
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
                tseq.data_ptr(), qrev.data_ptr(),
                dac.data_ptr() if splice else None,
                meta.data_ptr(), poff.data_ptr(),
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
    en0 = torch.minimum(tlen - 1, r)
    if not splice:
        st0 = torch.maximum(st0, (r - w + 1) >> 1)
        en0 = torch.minimum(en0, (r + w) >> 1)
    return st0, en0, st0 // 16 * 16, (en0 + 16) // 16 * 16 - 1


def _f_seed(r, scoring, splice):
    """The seed of row r's first lane (r a 0-dim tensor)."""
    q, e, _q2, e2, _m, _mis, _n, long_thres, long_diff = scoring
    f = torch.full_like(r, 0 if splice else -e2)
    f = torch.where(r == long_thres, long_diff, f)
    f = torch.where(r < long_thres, -e, f)
    return torch.where(r == 0, -(q + e), f)


def _live_order(steps_of, steps, widths=None):
    """The jobs longest first, from each job's step count `steps_of` (host
    int64): (order, live, band) where live[s] is the number of jobs of
    `order` still within their steps at step s < `steps` (a prefix of it)
    and band[s] the widest of `widths` among them (0 without widths)."""
    order = np.argsort(-steps_of, kind="stable")
    live = np.searchsorted(-steps_of[order], -np.arange(steps), side="left")
    band = np.zeros(steps, dtype=np.int64)
    if widths is not None and len(order):
        band = np.maximum.accumulate(widths[order])[np.maximum(live - 1, 0)]
    return order, live.tolist(), band.tolist()


GRAPH_STEPS = 32    # the shortest run of steps on one live prefix


def _chunks(live, band, length=GRAPH_STEPS):
    """(first step, steps) of each run of steps on one prefix: the steps
    while the live count and band stay as at the first, or `length` steps
    where that is fewer. The live count and band only fall, so the first
    step's prefix and band hold every step of the run; a job whose steps
    end inside the run stays in it masked, as a z-dropped job does."""
    out, s, total = [], 0, len(live)
    while s < total:
        e = s + 1
        while e < total and live[e] == live[s] and band[e] == band[s]:
            e += 1
        e = max(e, min(s + length, total))
        out.append((s, e - s))
        s = e
    return out


def _stepper(dev):
    """run(step, count): step() `count` times. On a CUDA device each run
    is captured once as a CUDA graph and replayed, since issuing a step's
    few hundred small ops costs more than running them once few jobs are
    live. The graphs share one memory pool: each is replayed before the
    next is captured, and the last one is kept until then, which keeps
    the pool alive. step() must update its state in place and read
    nothing back to the host."""
    if dev.type != "cuda":
        def run(step, count):
            for _ in range(count):
                step()
        return run
    pool = torch.cuda.graph_pool_handle()
    last = []

    def run(step, count):
        g = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            g.capture_begin(pool=pool, capture_error_mode="thread_local")
            step()
            g.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        last[:] = [g]
        for _ in range(count):
            g.replay()
    return run


def _release_graphs(dev) -> None:
    """Give a finished stepper's graph pool back to the card. Its blocks
    stay cached once its last graph is gone, and a later capture cannot
    free them (no cudaFree while a stream captures), so the plain runs of
    one process would pile their pools up until a capture runs out of
    memory."""
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def ksw_forward_ref(tseq, qrev, dac, meta, poff, *, scoring, splice,
                    p_bytes, t_total, band_max, rows_max):
    """Plain PyTorch version of the forward kernel on any device: a loop
    over anti-diagonals r, vectorized over jobs and over each job's band
    (lane k is t = st + k). Same outputs as `ksw_forward`.

    The jobs are stepped longest first: row r works on the prefix of jobs
    still within their rows and on the widest lanes among them (a job's
    n_col_of + 16 lanes hold its aligned band and score block on every
    row), so a row costs what its live jobs need. The row is a device
    tensor and the state is updated in place, masked bytes go to a scratch
    slot past the end of p: nothing in a row waits on the device, and a
    run of rows on one prefix (`_chunks`) replays from a CUDA graph
    (`_stepper`)."""
    del t_total
    q, e, q2, e2, mat0, sc_mis, sc_n, _lt, _ld = scoring
    dev = meta.device
    i32, i64 = torch.int32, torch.int64
    R = meta.shape[0]
    mh = meta.cpu().numpy().astype(np.int64)
    ql_h, tl_h, w_h = mh[:, M_QLEN], mh[:, M_TLEN], mh[:, M_W]
    widths = np.array([n_col_of(a, b, max(a, b) if splice or c < 0 else c,
                                splice) + 16
                       for a, b, c in zip(ql_h, tl_h, w_h)], dtype=np.int64)
    order, n_live, band = _live_order(ql_h + tl_h - 1, rows_max, widths)
    perm = torch.from_numpy(order).to(dev)
    meta, poff = meta[perm], poff[perm].to(i64)
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
    sig = torch.where(tmask, dac.to(i64)[tidx], 0) if splice else None
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
    p_scratch = max(p_bytes, 1)
    p = torch.zeros(p_scratch + 1, dtype=torch.uint8, device=dev)
    lanes = torch.arange(band_max, dtype=i64, device=dev)[None, :]
    r = torch.zeros((), dtype=i64, device=dev)
    ez = torch.zeros((R, EZ_COLS), dtype=i32, device=dev)
    g = lambda a, idx: a.gather(1, idx)
    g1 = lambda a, idx: a.gather(1, idx[:, None])[:, 0]

    def put(a, idx, val, mask):
        a.scatter_(1, idx, torch.where(mask, val, g(a, idx)))

    def emit(lo, hi):
        """The ez rows of jobs lo..hi-1 of the order, past their rows."""
        for c, val in ((C_MAX, mx), (C_MAX_T, mx_t), (C_MAX_Q, mx_q),
                       (C_MQE, mqe), (C_MQE_T, mqe_t), (C_MTE, mte),
                       (C_MTE_Q, mte_q), (C_SCORE, score),
                       (C_ZDROP, zdropped)):
            ez[lo:hi, c] = val[lo:hi].to(i32)

    def row():
        """Anti-diagonal r of the live prefix, on lanes k; then r += 1."""
        act = (r < nrows) & ~done
        st0, en0, st, en = _band(r, qlen, tlen, w, splice)
        closed = act & (st0 > en0)
        zdropped.logical_or_(closed)
        done.logical_or_(closed)
        act &= ~closed
        st = torch.where(act, st, 0)
        en = torch.where(act, en, -1)
        st0 = torch.where(act, st0, 0)
        en0 = torch.where(act, en0, 0)
        f_seed = _f_seed(r, scoring, splice)
        # boundary values at lane st-1 from the previous row
        prev = (st - 1).clamp(min=0)
        in_last = (st > 0) & (last_st <= st - 1) & (st - 1 <= last_en)
        x1 = torch.where(in_last, g1(x, prev), -qe)
        x21 = torch.where(in_last, g1(x2, prev), x2_init)
        v1 = torch.where(st > 0, torch.where(in_last, g1(v, prev), -qe),
                         f_seed)
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
        ut = torch.where(inj, f_seed, u_old)
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
        pidx = torch.where(in_band & cig[:, None],
                           poff[:, None] + r * ncol[:, None] + k, p_scratch)
        p.scatter_(0, pidx.reshape(-1), d.to(torch.uint8).reshape(-1))

        # exact H row and its maximum in the reference's scan order
        ex = act & ~approx
        h_m1 = g1(H, (en0 - 1).clamp(min=0))
        h_en0 = g1(H, en0)
        hcur = g(H, t)
        is_en0 = t == en0[:, None]
        h_top = torch.where(r == 0, vn - qe, torch.where(
            (en0 > 0)[:, None], h_m1[:, None] + un, h_en0[:, None] + vn))
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
        mte.copy_(torch.where(mte_upd, h_en0, mte))
        mte_q.copy_(torch.where(mte_upd, r - en, mte_q))
        h_st0 = g1(H, st0)
        mqe_upd = ex & (r - st0 == qlen - 1) & (h_st0 > mqe)
        mqe.copy_(torch.where(mqe_upd, h_st0, mqe))
        mqe_t.copy_(torch.where(mqe_upd, st0, mqe_t))

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
        h0_new = torch.where(r == 0, g1(v, torch.zeros_like(h0t)) - qe,
                             h0_new)
        h0t_new = torch.where(r == 0, 0, h0t_new)
        H0.copy_(torch.where(apx, h0_new, H0))
        h0t.copy_(torch.where(apx, h0t_new, h0t))

        # ksw_apply_zdrop on H (exact) or H0 (approx with APPROX_DROP)
        zj = ex | (apx & adrop)
        hval = torch.where(ex, max_h, H0)
        tval = torch.where(ex, max_t, h0t)
        bet = zj & (hval > mx)
        cand = zj & ~bet & (tval >= mx_t) & (r - tval >= mx_q)
        ll = ((tval - mx_t) - ((r - tval) - mx_q)).abs()
        dropped = cand & (zdrop >= 0) & (mx - hval > zdrop + ll * ze)
        mx.copy_(torch.where(bet, hval, mx))
        mx_t.copy_(torch.where(bet, tval, mx_t))
        mx_q.copy_(torch.where(bet, r - tval, mx_q))
        zdropped.logical_or_(dropped)
        fin = act & ~dropped & (r == nrows - 1) & (en0 == tlen - 1)
        score.copy_(torch.where(fin, torch.where(approx, H0, h_en0), score))
        done.logical_or_(dropped | (act & (r == nrows - 1)))
        last_st.copy_(torch.where(act, st, last_st))
        last_en.copy_(torch.where(act, en, last_en))
        r.add_(1)

    run = _stepper(dev)
    nl = R      # the live prefix
    for r0, count in _chunks(n_live, band):
        n = n_live[r0]
        if n < nl:
            emit(n, nl)
            if n == 0:
                break
            (qlen, tlen, w, zdrop, ncol, cig, right, approx, adrop, nrows,
             poff, mx, mx_t, mx_q, mqe, mqe_t, mte, mte_q, score, zdropped,
             done, last_st, last_en, H0, h0t, sf, sig, qr, u, v, x, y, x2,
             y2, s, H) = (a if a is None else a[:n] for a in (
                 qlen, tlen, w, zdrop, ncol, cig, right, approx, adrop,
                 nrows, poff, mx, mx_t, mx_q, mqe, mqe_t, mte, mte_q, score,
                 zdropped, done, last_st, last_en, H0, h0t, sf, sig, qr, u,
                 v, x, y, x2, y2, s, H))
            nl = n
        k = lanes[:, :band[r0]]
        run(row, count)
    del run
    _release_graphs(dev)

    emit(0, nl)
    ez_out = torch.empty_like(ez)
    ez_out[perm] = ez
    return p[:p_scratch], ez_out


def splice_signal_ref(tseq, meta, *, t_total, noncan):
    """Plain version of the splice-signal kernel on any device: each job's
    `donor_acceptor` over its target in `tseq` under its meta[M_SPLICE]
    flags, packed as the kernel packs it. Same output as `splice_signal`."""
    ts = tseq.cpu().numpy()
    dac = np.zeros(t_total, dtype=np.int16)
    for to, tl, flag in meta[:, [M_TOFF, M_TLEN, M_SPLICE]].tolist():
        donor, acceptor = donor_acceptor(ts[to:to + tl], noncan, flag)
        dac[to:to + len(donor)] = ((donor.astype(np.int16) & 0xFF)
                                   | ((acceptor.astype(np.int16) & 0xFF)
                                      << 8))
    return torch.from_numpy(dac).to(meta.device)


def ksw_walk_ref(p, poff, meta, ez, *, splice, ops_total):
    """Plain PyTorch version of the walk kernel: a loop over walk steps,
    vectorized over jobs. Same outputs as `ksw_walk`. The jobs are stepped
    longest walk bound (i + j + 2) first, each step on the prefix of jobs
    still within their bound, the state updated in place; masked step
    codes go to a scratch slot past the end of ops, nothing in a step
    waits on the device, and a run of steps on one prefix (`_chunks`)
    replays from a CUDA graph (`_stepper`)."""
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
    bound = (i + j + 2).clamp(min=0).cpu().numpy()
    order, n_live, band = _live_order(bound, int(bound.max())
                                      if len(bound) else 0)
    perm = torch.from_numpy(order).to(dev)
    qlen, tlen, w, ncol, i, j = (a[perm] for a in (qlen, tlen, w, ncol, i, j))
    base, opoff = poff.to(i64)[perm], col(M_OPOFF)[perm]
    state = torch.zeros_like(i)
    kk = torch.zeros_like(i)
    fin_i, fin_j, fin_k = i.clone(), j.clone(), kk.clone()
    ops_scratch = max(ops_total, 1)
    ops = torch.zeros(ops_scratch + 1, dtype=torch.int8, device=dev)

    def step():
        live = (i >= 0) & (j >= 0)
        r = (i + j).clamp(min=0)
        _st0, _en0, st, en = _band(r, qlen, tlen, w, splice)
        force = torch.where(i < st, 2, torch.where(i > en, 1, -1))
        at = (base + r * ncol + (i - st)).clamp(0, max(len(p) - 1, 0))
        tmp = torch.where(live & (force < 0), p.index_select(0, at).to(i64),
                          0)
        state.copy_(torch.where(state == 0, tmp & 7,
                                torch.where((tmp >> (state + 2)) & 1 == 1,
                                            state, 0)))
        state.copy_(torch.where(state == 0, tmp & 7, state))
        state.copy_(torch.where(force >= 0, force, state))
        oat = (opoff + kk).clamp(max=max(ops_total - 1, 0))
        ops.scatter_(0, torch.where(live, oat, ops_scratch),
                     state.to(torch.int8))
        is_m = state == 0
        is_del = (state == 1) | (state == 3)
        i.copy_(torch.where(live & (is_m | is_del), i - 1, i))
        j.copy_(torch.where(live & (is_m | ~is_del), j - 1, j))
        kk.copy_(torch.where(live, kk + 1, kk))
        state.copy_(torch.where(live, state, 0))

    run = _stepper(dev)
    nl = len(order)     # the live prefix
    for s0, count in _chunks(n_live, band):
        n = n_live[s0]
        if n < nl:
            fin_i[n:nl], fin_j[n:nl], fin_k[n:nl] = i[n:], j[n:], kk[n:]
            (qlen, tlen, w, ncol, base, opoff, i, j, state, kk) = (
                a[:n] for a in (qlen, tlen, w, ncol, base, opoff, i, j,
                                state, kk))
            nl = n
        run(step, count)
    del run
    _release_graphs(dev)
    fin_i[:nl], fin_j[:nl], fin_k[:nl] = i, j, kk
    for c, val in ((C_FIN_I, fin_i), (C_FIN_J, fin_j), (C_FIN_K, fin_k)):
        ez[perm, c] = val.to(ez.dtype)     # (-1, -1, 0) where no walk
    return ops[:ops_scratch]


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


_thread = threading.local()


def _own_stream(dev):
    """A context that makes a CUDA stream of the calling thread's own the
    current one on `dev` (nothing on the CPU). PyTorch's current stream is
    one stream for every thread, and a pageable upload or read-back waits
    for all the work on its stream: on a shared stream one batch thread's
    copies would wait for the other's launches, a long spliced job's for
    a tenth of a second or more. One stream a thread, kept, so that the
    caching allocator reuses each thread's blocks on that thread's
    stream."""
    if dev.type != "cuda":
        return nullcontext()
    streams = _thread.__dict__.setdefault("streams", {})
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in streams:
        streams[key] = torch.cuda.Stream(torch.device("cuda", key))
    return torch.cuda.stream(streams[key])


def _batch_async(jobs, mat, gaps, *, splice, noncan, device, timers=None):
    span = timers.time if timers is not None else (lambda _n: nullcontext())
    counting = timers is not None and active()
    scoring = forward_scoring(mat, gaps, splice=splice)
    long_thres = gaps[4]
    dev = torch.device(device)
    staged = []
    with _own_stream(dev):
        for idxs in split_by_budget(jobs, splice, P_BUDGET):
            grp = [jobs[i] for i in idxs]
            with span("ext_pack"):
                pk = pack_jobs(grp, splice=splice, noncan=noncan)
            with span("ext_upload"):
                ts = device_inputs(pk, dev, splice=splice)
            with span("ext_launch"):
                p, ez = ksw_forward(
                    *(ts[k] for k in FORWARD_KEYS), groups=pk["groups"],
                    scoring=scoring, splice=splice, p_bytes=pk["p_bytes"],
                    t_total=pk["t_total"], band_max=pk["band_max"],
                    rows_max=pk["rows_max"])
                ops = ksw_walk(p, ts["poff"], ts["meta"], ts["order"], ez,
                               splice=splice, ops_total=pk["ops_total"])
            if counting:
                timers.count("ksw_h2d_bytes",
                             sum(pk[k].nbytes for k in TENSOR_KEYS))
                timers.count("ksw_signal_jobs", len(grp) if splice else 0)
            staged.append((idxs, grp, pk, ez, ops))

    def collect_ez():
        out_all = [None] * len(jobs)
        with _own_stream(dev):
            for idxs, grp, pk, ez, ops in staged:
                if dev.type == "cuda":
                    # the card's work ends here; the read-back below copies
                    with span("device_wait"):
                        torch.cuda.current_stream(dev).synchronize()
                with span("ext_decode"):
                    ez_h = ez.cpu().numpy()
                    out = [_ez_from_row(ez_h[j]) for j in range(len(grp))]
                    ops_h = ops.cpu().numpy()
                    ops_l = [ops_h[int(o):] for o in pk["meta"][:, M_OPOFF]]
                    _decode_walk(grp, out, ez_h, ops_l, splice=splice,
                                 long_thres=long_thres)
                if counting:
                    timers.count("ksw_d2h_bytes", ez_h.nbytes + ops_h.nbytes)
                    count_work(timers, grp, out, splice)
                for i, res in zip(idxs, out):
                    out_all[i] = res
        return lambda: out_all
    return collect_ez


def count_work(timers, jobs, results, splice: bool) -> None:
    """One launch's work counters, each as benchmark/roofline.py's
    `ksw_work` counts it: ksw_cells_<kind> (the cells of the live band of
    every anti-diagonal a job computes: all of them, or up to its maximum
    where it z-dropped), of them those of approximate-maximum jobs
    (ksw_cells_<kind>_approx) and of score-only jobs
    (ksw_cells_<kind>_score), ksw_jobs_<kind>, walk_steps (a step per
    CIGAR base of every job with a CIGAR) and ksw_in_bytes (the query and
    the target once, and a splice signal a target base); <kind> is extd2
    or exts2."""
    kind = "exts2" if splice else "extd2"
    ql = np.array([len(j["qseq"]) for j in jobs], np.int64)
    tl = np.array([len(j["tseq"]) for j in jobs], np.int64)
    flag = np.array([j["flag"] for j in jobs], np.int64)
    rows = ql + tl - 1
    cut = np.array([max(ez.max_t + ez.max_q + 1, 1) if ez.zdropped
                    else r for ez, r in zip(results, rows)], np.int64)
    rows = np.minimum(rows, cut)
    w = None
    if not splice:
        w = np.array([j["w"] for j in jobs], np.int64)
        w = np.where(w >= 0, w, np.maximum(ql, tl))
    cells = _band_cells(ql, tl, w, rows)
    score = (flag & K.KSW_EZ_SCORE_ONLY) != 0
    steps = sum(int(c) >> 4 for ez, s in zip(results, score) if not s
                for c in ez.cigar)
    timers.count(f"ksw_cells_{kind}", int(cells.sum()))
    timers.count(f"ksw_cells_{kind}_approx",
                 int(cells[(flag & K.KSW_EZ_APPROX_MAX) != 0].sum()))
    timers.count(f"ksw_cells_{kind}_score", int(cells[score].sum()))
    timers.count(f"ksw_jobs_{kind}", len(jobs))
    timers.count("walk_steps", steps)
    timers.count("ksw_in_bytes", int((ql + tl * (2 if splice else 1)).sum()))


def _band_cells(ql, tl, w, rows, chunk: int = 1 << 22) -> np.ndarray:
    """Each job's cells over its first `rows` anti-diagonals: those of the
    query x target matrix, and of the band of width `w` where it is given
    (extd2's). Where no band binds (none, or w >= ql + tl - 1) the sum is
    closed: anti-diagonal r holds min(r + 1, ql, tl, ql + tl - 1 - r)
    cells. Elsewhere one int32 lane a row, over jobs taken `chunk` rows at
    once."""
    out = np.empty(len(rows), np.int64)
    free = np.ones(len(rows), bool) if w is None else w >= ql + tl - 1
    a, b, R = (np.minimum(ql, tl)[free], np.maximum(ql, tl)[free],
               rows[free])
    n = np.maximum(R - b, 0)        # rows past both sides' lengths
    out[free] = np.where(
        R <= a, R * (R + 1) // 2,
        a * (a + 1) // 2 + (np.minimum(R, b) - a) * a
        + n * (a - 1) - n * (n - 1) // 2)
    band = np.flatnonzero(~free)
    i = 0
    while i < len(band):
        rr = rows[band[i:]]
        j = i + max(1, int(np.searchsorted(np.cumsum(rr), chunk,
                                           side="right")))
        k = band[i:j]
        rr = rows[k]
        ends = np.cumsum(rr)
        per = lambda v: np.repeat(v[k].astype(np.int32), rr)
        r = np.arange(int(ends[-1]), dtype=np.int32) \
            - np.repeat((ends - rr).astype(np.int32), rr)
        st = np.maximum(r - per(ql) + 1, 0)
        en = np.minimum(per(tl) - 1, r)
        wr = per(w)
        np.maximum(st, (r - wr + 1) >> 1, out=st)
        np.minimum(en, (r + wr) >> 1, out=en)
        cum = np.concatenate(([0], np.cumsum(np.maximum(en - st + 1, 0),
                                             dtype=np.int64)))
        out[k] = cum[ends] - cum[ends - rr]
        i = j
    return out


def extd2_batch(jobs, mat, q, e, q2, e2, interpret=False, quantize=False,
                backtrack="host", device="cuda", timers=None):
    """Batched ksw_extd2: extd2_batch_async run to its end."""
    return extd2_batch_async(jobs, mat, q, e, q2, e2, interpret=interpret,
                             quantize=quantize, backtrack=backtrack,
                             device=device, timers=timers)()()


def extd2_batch_async(jobs, mat, q, e, q2, e2, interpret=False,
                      quantize=False, backtrack="host", device="cuda",
                      timers=None):
    """Batched ksw_extd2 with K.extd2's per-job semantics; jobs are dicts
    (qseq, tseq, w, zdrop, end_bonus, flag). Dispatches and returns
    collect_ez (see the module docstring). `timers`, when given, receives
    the spans ext_pack, ext_upload, ext_launch, device_wait and ext_decode
    and, in a trace, the launch work counters (`count_work`, ksw_h2d_bytes,
    ksw_d2h_bytes, ksw_signal_jobs: the jobs whose splice signal the
    device computed)."""
    del interpret, quantize, backtrack
    return _batch_async(jobs, mat, gap_params(q, e, q2, e2, False),
                        splice=False, noncan=0, device=device, timers=timers)


def exts2_batch(jobs, mat, q, e, q2, noncan, interpret=False,
                quantize=False, backtrack="host", device="cuda", timers=None):
    """Batched ksw_exts2: exts2_batch_async run to its end."""
    return exts2_batch_async(jobs, mat, q, e, q2, noncan,
                             interpret=interpret, quantize=quantize,
                             backtrack=backtrack, device=device,
                             timers=timers)()()


def exts2_batch_async(jobs, mat, q, e, q2, noncan, interpret=False,
                      quantize=False, backtrack="host", device="cuda",
                      timers=None):
    """Batched splice extension with ksw2_splice.exts2's per-job
    semantics (unbanded); jobs are dicts (qseq, tseq, zdrop, flag).
    `timers` as extd2_batch_async's."""
    del interpret, quantize, backtrack
    return _batch_async(jobs, mat, gap_params(q, e, q2, 0, True),
                        splice=True, noncan=noncan, device=device,
                        timers=timers)
