"""The mesh's step functions: sharded seed collection, the sharded fused
flow and the sharded map step, each run on every rank of a
parallel/mesh.Mesh by `Mesh.step`.

Port of minimap2_chaindp_tpu/models/device_pipeline.py
(`make_sharded_collect_step` :32, `make_sharded_flow_step` :61,
`make_sharded_map_step` :191). Where JAX's shard_map gave each device its
block, a step here gets its rank's data slice of the query arrays and its
index shard of the tables (`tables`, sent once by `Mesh.put`); each psum
over an axis is a sum over the rank's group of that axis (`ctx.index`,
`ctx.data`), each all_gather the same. Every device of the index axis
computed the same outputs in JAX; here only the index-0 ranks' outputs go
back to rank 0, so the other ranks stop after their last collective and
the chain kernel runs once a data row, on its index-0 rank's device
(ops/chain_dp.chain_scores_batch: the CUDA kernel on a card, its plain
version on the CPU). Outputs equal the single-device versions anchor for
anchor.
"""
from __future__ import annotations

import torch

from .. import constants as C
from ..ops.chain_dp import chain_scores_batch
from ..ops.seeds_device import PAD_HI, SIGN, _collect_dev, _key_search
from .device_flow import derive_queries, flow_tail

_TABLES = ("khi", "klo", "starts", "vhi", "vlo")


def sharded_collect_step(ctx, tables, qhi, qlo, qvalid, qpos, qspan, qseg,
                         qtnd, qls, *, max_occ, cap):
    """Sharded-index seed collection (JAX make_sharded_collect_step): the
    key path of _collect_dev on this rank's shard, the disjoint per-slot
    contributions summed over the index group. Returns (xhi, xlo, yhi,
    ylo, total, cnt, over) for this rank's rows, as the single-device
    collect does (total (R,), over as int32)."""
    out = _collect_dev(*(tables[k] for k in _TABLES), qhi, qlo,
                       qvalid.bool(), qpos, qspan, qseg, qtnd, max_occ, qls,
                       cap=cap, group=ctx.index)
    return (*out[:6], out[6].to(torch.int32))


def sharded_flow_step(ctx, tables, qhi, qlo, qpos, qspan8, nmv, qls, nn, w1,
                      exc, *, max_occ, cap, max_dist_x, max_dist_y, bw,
                      max_skip, use_exc):
    """The fused flow over an index-sharded CSR (JAX
    make_sharded_flow_step), with capacity-bounded hit routing:
    1. one sum over the index group of the per-minimizer occurrence
       counts gives each shard every minimizer's global slot base (keys
       partition across shards, so each count has one owner);
    2. each shard expands its own hits into cap / n_index slots tagged
       with global slot ids (the caller sized `cap` from the real
       per-shard hit counts);
    3. an all_gather over the index group routes the hits to every rank
       of the data row;
    4. one stable 3-key sort ((biased xhi, rpos), global slot) rebuilds
       the single-device anchor order: the global slot id is the host's
       expansion index, so equal x tie-break as the host's radix sort
       does; pads carry the largest keys and go last.
    Then flow_tail: the window starts and the chain kernel. Returns (xhi,
    xlo, yhi, ylo, f, p, flag) for this rank's rows on an index-0 rank,
    nothing on the others (their outputs are not gathered)."""
    khi, klo, starts, vhi, vlo = (tables[k] for k in _TABLES)
    qvalid, qspan, qtnd, qseg = derive_queries(qhi, qlo, qspan8, nmv)
    R, M = qhi.shape
    n_index = ctx.index.size
    cap_shard = cap // n_index
    dev = qhi.device
    pos_c, found = _key_search(khi, klo, qhi, qlo, qvalid)
    cnt = torch.where(found, starts[pos_c + 1] - starts[pos_c], 0)
    keep = found & (cnt < max_occ)
    occ_l = torch.where(keep, cnt, 0)
    # collective 1: the count sum (each minimizer owned by one shard)
    occ_g = ctx.index.all_reduce(occ_l)
    cum_g = torch.cumsum(occ_g, dim=1)
    base_m = cum_g - occ_g
    total = cum_g[:, -1]

    # compact local expansion into cap_shard slots + global slot ids
    cum_l = torch.cumsum(occ_l, dim=1)
    total_l = cum_l[:, -1]
    slot = torch.arange(cap_shard, dtype=cum_l.dtype, device=dev)[None, :] \
        .expand(R, cap_shard).contiguous()
    midx = torch.searchsorted(cum_l.contiguous(), slot, right=True)
    midx_c = midx.clamp(max=M - 1)
    cum_prev = torch.where(
        midx_c > 0, torch.gather(cum_l, 1, (midx_c - 1).clamp(min=0)), 0)
    within = slot - cum_prev
    live_l = slot < total_l[:, None]
    vidx = torch.gather(starts[pos_c].long(), 1, midx_c) + within
    vidx = vidx.clamp(0, vhi.shape[0] - 1)
    rid = vhi[vidx]
    rlo = vlo[vidx]
    rpos = (rlo >> 1) & 0x7FFFFFFF
    rstrand = rlo & 1
    qp = torch.gather(qpos, 1, midx_c)
    qsp = torch.gather(qspan, 1, midx_c)
    sid = torch.gather(qseg, 1, midx_c)
    tnd = torch.gather(qtnd, 1, midx_c)
    fwd = rstrand == (qp & 1)
    xhi = torch.where(fwd, rid, rid ^ SIGN)
    xlo = rpos
    ylo = torch.where(fwd, qp >> 1,
                      qls - ((qp >> 1) + 1 - qsp) - 1).to(torch.int32)
    yhi = qsp | torch.where(tnd != 0, C.MM_SEED_TANDEM >> 32, 0) \
        .to(torch.int32) | (sid << (C.MM_SEED_SEG_SHIFT - 32))
    gslot = torch.gather(base_m, 1, midx_c) + within
    gslot = torch.where(live_l, gslot, PAD_HI)

    # collective 2: capacity-bounded hit routing (a compact all_gather)
    def ag(x):
        g = ctx.index.all_gather(x)                       # (n_i, R, S)
        return g.permute(1, 0, 2).reshape(R, cap)

    gs, xh2, xl2, yh2, yl2 = (ag(v) for v in (gslot, xhi, xlo, yhi, ylo))
    if ctx.index_idx:
        return ()
    # the 3-key stable sort, least significant key first: the global
    # slot, then (biased xhi, rpos) packed into one int64
    pad = gs == PAD_HI
    skh = torch.where(pad, PAD_HI, xh2 ^ SIGN).long()
    skl = torch.where(pad, PAD_HI, xl2).long()
    order = torch.sort(gs, dim=1, stable=True).indices
    key = torch.gather((skh << 32) | (skl & 0xFFFFFFFF), 1, order)
    order = torch.gather(order, 1,
                         torch.sort(key, dim=1, stable=True).indices)
    xh2, xl2, yh2, yl2 = (torch.gather(v, 1, order)
                          for v in (xh2, xl2, yh2, yl2))
    f, p, flag = flow_tail(xh2, xl2, yh2, yl2, total.to(torch.int32), nn,
                           w1, exc, cap=cap, max_dist_x=max_dist_x,
                           max_dist_y=max_dist_y, bw=bw, max_skip=max_skip,
                           use_exc=use_exc)
    return xh2, xl2, yh2, yl2, f, p, flag


def sharded_map_step(ctx, tables, qkeys, xhi, rpos, qpos, span, sid, stw,
                     nn, w1, exc, *, max_n, max_dist, bw, max_skip):
    """The dry run's mapping step (JAX make_sharded_map_step): a lookup of
    each query key in this rank's shard of the sorted int32 `keys`, the
    hit counts summed over the index group, the chain kernel on this
    rank's reads, and the flagged reads summed over the data group.
    Returns (f, p, flag, occ, total_flagged (1,)) on an index-0 rank,
    nothing on the others (their outputs are not gathered)."""
    keys = tables["keys"]
    pos = torch.searchsorted(keys, qkeys.contiguous())
    pos_c = pos.clamp(max=keys.shape[0] - 1)
    hit = (keys[pos_c] == qkeys).to(torch.int32)
    occ = ctx.index.all_reduce(hit)
    if ctx.index_idx:
        return ()
    f, p, flag = chain_scores_batch(
        xhi, rpos, qpos, span, sid, stw, nn, w1, exc, max_n=max_n,
        max_dist_x=max_dist, max_dist_y=max_dist, bw=bw, max_skip=max_skip,
        is_cdna=False, many_segs=False)
    total_flagged = ctx.data.all_reduce(flag[:, :1].sum(0, dtype=torch.int64))
    return f, p, flag, occ, total_flagged
