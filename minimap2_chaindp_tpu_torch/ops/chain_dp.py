"""Chaining-DP score pass: the hand-written CUDA kernel (csrc/chain_dp.cu)
and its plain PyTorch version.

Port of minimap2_chaindp_tpu/ops/chain_pallas.py:chain_scores_batch with the
same signature and output shapes: f and p are (R, max_n) int32, flag is
(R, 128) int32 with the read's flag in column 0. Inputs are tensors on the
call's device: CUDA tensors launch the kernel, CPU tensors run
`chain_scores_batch_ref`. The contract both implement is written at the top
of csrc/chain_dp.cu.
"""
from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from .chain_pack import LANES, N_EXC, NEG_INF, TBL

# The kernel's two forms (csrc/chain_dp.cu): "staged", a block a read with
# producer warps ahead of one consumer warp, for launches whose time is the
# chain of their longest read; "warp", a warp a read and fewer instructions a
# candidate, for launches with far more reads than the card holds at once.
FORMS = ("staged", "warp")
WARP_FORM_READS_PER_SM = 16


def chain_form(n_reads: int, n_sm: int) -> str:
    """The form a launch of n_reads rows takes on a card with n_sm
    multiprocessors: staged up to WARP_FORM_READS_PER_SM reads each (three or
    four rounds of the four to six blocks an SM holds), warp beyond. On an
    H100 the staged form led at 726, 1024 and 2048 reads of the port's paths
    and the warp form at 8192 x 1024 anchors (chip_smoke.py times both
    wherever it checks the kernel)."""
    return "warp" if n_reads > WARP_FORM_READS_PER_SM * n_sm else "staged"


@functools.lru_cache(maxsize=None)
def _n_sm(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_I32_NAMES = ("xhi", "rpos", "qpos", "span", "sid", "stw", "nn", "exc")


def _mode(is_cdna: bool, many_segs: bool) -> int:
    return 2 if is_cdna else (1 if many_segs else 0)


def _check(tensors: dict, *, max_n, max_dist_y, bw, is_cdna, many_segs):
    """Validate limits, device, dtype, shape and contiguity; raise on
    anything the kernel does not take."""
    # exact-c_lin domain (chain_pallas.py:423-426): the same-seg linear gap
    # cost is tabled for dd < TBL
    if (max_dist_y if is_cdna else bw) >= TBL:
        raise ValueError("same-seg gap-cost domain >= TBL uses the host path")
    if max_n > 1 << 16:
        raise ValueError("max_n must be <= 65536")
    dev = tensors["rpos"].device
    R = tensors["rpos"].shape[0]
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, rpos on {dev}")
        want = torch.float32 if name == "w1" else torch.int32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        shape = (R, LANES) if name in ("nn", "w1", "exc") else (R, max_n)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")


def chain_scores_batch(xhi, rpos, qpos, span, sid, stw, nn, w1, exc, *,
                       max_n, max_dist_x, max_dist_y, bw, max_skip, is_cdna,
                       many_segs, use_exc=None, score_bound=None):
    """Batched chaining score pass; returns (f, p, flag).

    use_exc: whether the c_lin exception patches apply. None means True:
    the JAX version infers it from `exc`, and an empty slot (dd = -1) never
    matches a gap, so both give the same outputs without reading `exc` back
    from the card. score_bound selected a TPU epilogue only; it is accepted
    and does not change the outputs."""
    del score_bound
    use_exc = True if use_exc is None else bool(use_exc)
    args = dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid, stw=stw,
                nn=nn, w1=w1, exc=exc)
    _check(args, max_n=max_n, max_dist_y=max_dist_y, bw=bw,
           is_cdna=is_cdna, many_segs=many_segs)
    dev = rpos.device
    kw = dict(max_n=max_n, max_dist_x=max_dist_x, max_dist_y=max_dist_y,
              bw=bw, max_skip=max_skip, is_cdna=is_cdna, many_segs=many_segs)
    if dev.type == "cpu":
        return chain_scores_batch_ref(*args.values(), use_exc=use_exc, **kw)
    if dev.type != "cuda":
        raise ValueError(f"chain_scores_batch runs on cuda or cpu, not {dev}")
    from ._build import load
    lib = load()
    R = rpos.shape[0]
    f = torch.empty((R, max_n), dtype=torch.int32, device=dev)
    p = torch.empty((R, max_n), dtype=torch.int32, device=dev)
    flag = torch.empty((R, LANES), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        form = chain_scores_batch.force or chain_form(
            R, _n_sm(torch.cuda.current_device()))
        rc = lib.mm2tpu_chain_dp(
            *(t.data_ptr() for t in (xhi, rpos, qpos, span, sid, stw, nn, w1,
                                     exc, f, p, flag)),
            R, max_n, max_dist_x, max_dist_y, bw, max_skip,
            _mode(is_cdna, many_segs), int(use_exc), FORMS.index(form),
            stream)
    if rc != 0:
        raise RuntimeError(f"chain_dp kernel launch failed: CUDA error {rc}")
    with _launch_lock:   # map_stream launches from two threads
        chain_scores_batch.launches += 1
        chain_scores_batch.by_form[form] += 1
    return f, p, flag


chain_scores_batch.launches = 0
chain_scores_batch.by_form = dict.fromkeys(FORMS, 0)
chain_scores_batch.force = None   # a form of FORMS, where a caller times both
_launch_lock = threading.Lock()


def work_mode(is_cdna: bool, many_segs: bool) -> str:
    """The launch work counters' name for a mode: chain_pairs_<mode>."""
    return "cdna" if is_cdna else ("many_segs" if many_segs else "single")


def window_pairs(stw, nn) -> int:
    """The candidate pairs a launch scores: j in [max(stw[r, i], 0), i) for
    every anchor i < nn[r, 0] of every row (numpy stw (R, max_n), nn
    (R, LANES))."""
    i = np.arange(stw.shape[1], dtype=np.int64)[None, :]
    live = i < nn[:, :1].astype(np.int64)
    return int(((i - np.maximum(stw.astype(np.int64), 0)) * live).sum())


def count_launch(timers, mode: str, pairs: int, in_bytes: int, out,
                 h2d_bytes: int) -> None:
    """One launch's work counters: its candidate pairs (chain_pairs_<mode>),
    the bytes of its nine inputs (chain_in_bytes), those of f, p and the
    flag column of its outputs `out` (chain_out_bytes; their sizes only are
    read) and the bytes the host uploaded for it (chain_h2d_bytes)."""
    f, p, flag = out
    timers.count(f"chain_pairs_{mode}", pairs)
    timers.count("chain_in_bytes", in_bytes)
    timers.count("chain_out_bytes", f.nbytes + p.nbytes + flag[:, 0].nbytes)
    timers.count("chain_h2d_bytes", h2d_bytes)


def chain_scores_batch_ref(xhi, rpos, qpos, span, sid, stw, nn, w1, exc, *,
                           max_n, max_dist_x, max_dist_y, bw, max_skip,
                           is_cdna, many_segs, use_exc=True):
    """Plain PyTorch version of the kernel on any device: a loop over anchor
    index i, vectorized over reads and over the window [min_r stw, i)."""
    R = rpos.shape[0]
    dev = rpos.device
    i32 = torch.int32
    single = not is_cdna and not many_segs
    n = nn[:, 0].clamp(max=max_n)
    w = w1[:, 0:1]
    excs = [(exc[:, 2 * k:2 * k + 1], exc[:, 2 * k + 1:2 * k + 2])
            for k in range(N_EXC)] if use_exc else []
    idx = torch.arange(max_n, dtype=i32, device=dev)
    # padded anchors get an empty window
    st = torch.where(idx[None, :] < n[:, None], stw.clamp(min=0), idx[None, :])
    lo = st.min(dim=0).values.tolist() if R else []
    f = torch.zeros((R, max_n), dtype=i32, device=dev)
    p = torch.full((R, max_n), -1, dtype=i32, device=dev)
    flag = torch.zeros(R, dtype=torch.bool, device=dev)
    mdy_x = min(max_dist_y, max_dist_x) & 0xFFFFFFFF
    neg = torch.full((R,), NEG_INF, dtype=i32, device=dev)
    none = torch.full((R,), -1, dtype=i32, device=dev)
    n_hi = int(n.max()) if R else 0
    for i in range(n_hi):
        qs = span[:, i]
        act = i < n
        lo_i = lo[i]
        if lo_i < i:
            j = idx[lo_i:i]
            dr = rpos[:, i:i + 1] - rpos[:, lo_i:i]
            dq = qpos[:, i:i + 1] - qpos[:, lo_i:i]
            dd = (dr - dq).abs()
            valid = j[None, :] >= st[:, i:i + 1]
            if single:
                valid &= (dr != 0) & (dd <= bw) \
                    & (((dq - 1).long() & 0xFFFFFFFF) < mdy_x)
            else:
                same = sid[:, lo_i:i] == sid[:, i:i + 1]
                valid &= (xhi[:, lo_i:i] == xhi[:, i:i + 1]) \
                    & (dr <= max_dist_x)
                valid &= ~((same & (dr == 0)) | (dq <= 0))
                valid &= ~((same & (dq > max_dist_y)) | (dq > max_dist_x))
                valid &= ~(same & (dd > bw))
                if many_segs and not is_cdna:
                    valid &= ~(same & (dr > max_dist_y))
            sc = torch.minimum(torch.minimum(dq, dr), qs[:, None])
            ddf = dd.float()
            # c_lin is used only for dd < TBL; the clamp keeps the float to
            # int conversion in range elsewhere
            c_lin = (ddf.clamp(max=float(TBL)) * w).to(i32)
            for dk, ck in excs:
                c_lin = torch.where(dd == dk, ck, c_lin)
            log_dd = (ddf.clamp(min=1.0).view(i32) >> 23) - 127
            pen_same = c_lin + (log_dd >> 1)
            if single:
                sc = sc - pen_same
            else:
                pen_other = torch.where(dd >= TBL, log_dd,
                                        torch.minimum(c_lin, log_dd))
                if is_cdna:
                    sc = torch.where(
                        ~same & (dr == 0), sc + 1,
                        torch.where((dr > dq) | ~same, sc - pen_other,
                                    sc - pen_same))
                else:
                    sc = torch.where(same, sc - pen_same,
                                     torch.where(dr == 0, sc + 1,
                                                 sc - pen_other))
            scv = torch.where(valid, sc + f[:, lo_i:i], NEG_INF)
            cur = scv.max(dim=1).values
            is_best = valid & (scv == cur[:, None])
            best_j = torch.where(is_best, j[None, :], -1).max(dim=1).values
            above = (valid & (j[None, :] > best_j[:, None])).sum(dim=1)
        else:
            cur, best_j, above = neg, none, torch.zeros_like(n)
        have = act & (cur > qs)
        f[:, i] = torch.where(act, torch.maximum(cur, qs), 0)
        p[:, i] = torch.where(have, best_j, -1)
        flag |= have & (above > max_skip)
    flag_out = flag.to(i32)[:, None].expand(R, LANES).contiguous()
    return f, p, flag_out
