"""Fused device flow in PyTorch: seed collect -> window starts -> chaining
kernel, one device step per read bucket.

Port of minimap2_chaindp_tpu/models/device_flow.py. The host sketches each
read and looks up its CSR key positions; the device expands them into
anchors, sorts them, computes each anchor's window start and runs the
chain kernel; anchors, f, p and the flag come back, and the host runs the
chain bottom half. With a mesh (parallel/mesh.Mesh) the CSR is
key-range-sharded over its index axis and each bucket runs the sharded
step (models/device_pipeline.sharded_flow_step), which ships each
minimizer's split key instead of its position; the output is the same.

Host-side statistics (exact anchor count, span sum, over-occurrence mask)
make the flow synchronization-free: bucket routing, overflow fallback and
the kernel's w1/exc inputs are known before dispatch. Fallbacks (the
reference's err_flag pattern, map.c:933-944): anchor-count overflow,
gap-cost exception overflow or avg_qspan < 1.6, and the kernel's skip flag
leave the read to the runtime's staged path. A CUDA error raises.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..ops import chain_pack as CP
from ..ops.chain import Chains, chain_backtrack
from ..ops.chain_dp import chain_scores_batch
from ..ops.chain_host import _v_from_fp, compact_from_fpv
from ..ops.seeds import SeedHits
from ..ops.seeds_device import (PAD_HI, SIGN, _collect_dev_pos, _rep_len,
                                device_index_cached, split_u64)
from ..utils.timers import Timers

# (minimizer-count, anchor-capacity) buckets: a read takes the smallest
# bucket that fits both counts; past the last one it takes the staged path
M_BUCKETS = (256, 1024, 2048, 4096)
CAP_BUCKETS = (512, 1024, 2048, 4096, 8192)


def host_seed_stats(mi, mv: np.ndarray, max_occ: int):
    """Exact per-read anchor count, anchor span sum, over-occurrence mask,
    and per-minimizer (key position, kept occurrence) arrays from the host
    CSR tables, without expanding anchors (mirrors _collect_dev's masking,
    map.c:119-141). pos/occ feed the mesh dispatcher's per-shard counts.

    Copied verbatim from minimap2_chaindp_tpu/models/device_flow.py:46-68."""
    key = mv[:, 0] >> np.uint64(8)
    nk = len(mi.keys)
    if nk == 0:
        z = np.zeros(len(mv), np.int64)
        return 0, 0, np.zeros(len(mv), bool), z, z
    from ..native import key_lookup_batch
    pos = key_lookup_batch(mi.keys, key)   # prefix-directory path (r5):
    if pos is None:                        # genome-scale searchsorted was
        pos = np.searchsorted(mi.keys, key)   # the same key-search wall
    pos_c = np.minimum(pos, nk - 1)
    found = mi.keys[pos_c] == key
    cnt = np.where(found,
                   (mi.starts[pos_c + 1] - mi.starts[pos_c]).astype(np.int64),
                   0)
    over = found & (cnt >= max_occ)
    occ = np.where(found & ~over, cnt, 0)
    span = (mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
    return int(occ.sum()), int((span * occ).sum()), over, pos_c, occ


def derive_queries(qhi, qlo, qspan8, nmv):
    """The key path's query masks derived on the device (port of
    minimap2_chaindp_tpu/models/device_flow.py:71-90): valid = slot <
    count, tandem = neighbour key equality (the host packer's same-key
    marking), seg = 0 (single-segment flow); spans ride as uint8 (HPC
    spans reach 255, sketch.c:111). Returns (qvalid, qspan, qtnd, qseg)."""
    R, M = qhi.shape
    mslot = torch.arange(M, dtype=torch.int32, device=qhi.device)[None, :]
    qvalid = mslot < nmv
    qspan = qspan8.to(torch.int32)
    same_r = qvalid[:, 1:] & (qhi[:, 1:] == qhi[:, :-1]) \
        & (qlo[:, 1:] == qlo[:, :-1])
    z1 = torch.zeros((R, 1), dtype=torch.bool, device=qhi.device)
    qtnd = (torch.cat([same_r, z1], dim=1)
            | torch.cat([z1, same_r], dim=1)).to(torch.int32)
    qseg = torch.zeros((R, M), dtype=torch.int32, device=qhi.device)
    return qvalid, qspan, qtnd, qseg


def derive_queries_pos(qposidx: torch.Tensor):
    """Tandem marking for the H2D-slim flow: adjacent minimizers share a key
    iff they share a CSR position (both present; -1 marks absent/pad
    slots); seg is 0 everywhere. Port of
    minimap2_chaindp_tpu/models/device_flow.py:92-103."""
    R, M = qposidx.shape
    same_r = (qposidx[:, 1:] >= 0) & (qposidx[:, 1:] == qposidx[:, :-1])
    z1 = torch.zeros((R, 1), dtype=torch.bool, device=qposidx.device)
    qtnd = (torch.cat([same_r, z1], dim=1)
            | torch.cat([z1, same_r], dim=1)).to(torch.int32)
    qseg = torch.zeros((R, M), dtype=torch.int32, device=qposidx.device)
    return qtnd, qseg


def flow_tail(xhi, xlo, yhi, ylo, total, nn, w1, exc, *, cap, max_dist_x,
              max_dist_y, bw, max_skip, use_exc):
    """Post-collect device stages: pad masking, fused window starts and the
    chaining kernel. Returns (f, p, flag) as (R, cap), (R, cap), (R, 128)
    int32 tensors."""
    slot = torch.arange(cap, dtype=torch.int32, device=xhi.device)[None, :]
    live = slot < total[:, None]
    # kernel padding invariants: rpos = qpos = 0 at padded slots
    rpos = torch.where(live, xlo, 0)
    qpos_a = torch.where(live, ylo, 0)
    span_a = torch.where(live, yhi & 0xFF, 0)
    # fused window starts (pack_reads' stw semantics): the first j whose
    # (biased xhi, rpos) key reaches (skh_i, max(rpos_i - max_dist_x, 0));
    # the same-x start dominates whenever rpos_i - max_dist_x borrows, and
    # padded queries land past `total`
    skh = torch.where(live, xhi ^ SIGN, PAD_HI).long()
    skl = torch.where(live, xlo, PAD_HI).long()
    key = (skh << 32) | skl
    target = (skh << 32) | (skl - max_dist_x).clamp(min=0)
    stw = torch.searchsorted(key, target, side="left").to(torch.int32)
    sid = torch.zeros_like(rpos)      # single-seg: never read
    return chain_scores_batch(
        xhi, rpos, qpos_a, span_a, sid, stw, nn, w1, exc, max_n=cap,
        max_dist_x=max_dist_x, max_dist_y=max_dist_y, bw=bw,
        max_skip=max_skip, is_cdna=False, many_segs=False, use_exc=use_exc)


def flow_step(dx, qposidx, qpos, qspan8, max_occ, qls, nn, w1, exc, *, cap,
              max_dist_x, max_dist_y, bw, max_skip, use_exc):
    """One fused device step for a bucket: collect, window starts, chain.
    Returns (xhi, xlo, yhi, ylo, f, p, flag) device tensors."""
    qtnd, qseg = derive_queries_pos(qposidx)
    xhi, xlo, yhi, ylo, total, _cnt, _over = _collect_dev_pos(
        dx.starts, dx.vhi, dx.vlo, qposidx, qpos, qspan8.to(torch.int32),
        qseg, qtnd, max_occ, qls, cap=cap)
    f, p, flag = flow_tail(xhi, xlo, yhi, ylo, total, nn, w1, exc, cap=cap,
                           max_dist_x=max_dist_x, max_dist_y=max_dist_y,
                           bw=bw, max_skip=max_skip, use_exc=use_exc)
    return xhi, xlo, yhi, ylo, f, p, flag


def flow_mode_ok(opt) -> bool:
    """Whole-run eligibility: single-segment genomic chaining with the
    gap-cost table domain (the staged path covers the rest)."""
    bad = (C.MM_F_NO_DIAG | C.MM_F_FOR_ONLY | C.MM_F_REV_ONLY
           | C.MM_F_SPLICE)
    return not (opt.flag & bad) and opt.bw < CP.TBL


class DeviceFlow:
    """Dispatcher for the fused collect+chain device step on one device
    (`"cuda"`, `"cuda:N"` or `"cpu"`; the CPU runs the plain versions), or
    with `mesh` on a parallel/mesh.Mesh (JAX DeviceFlow(mesh=...),
    device_flow.py:208-283): the CSR tables are cut into the mesh's index
    shards and sent to its ranks once, each bucket's rows split over its
    data ranks, and a read whose hits crowd one shard past the bucket's
    per-shard capacity is left to the staged path, as in JAX."""

    def __init__(self, mi, opt, device="cuda", ship_anchors: bool = True,
                 mesh=None):
        self.mi = mi
        self.opt = opt
        self.mesh = mesh
        # ship_anchors=False: the host re-derives the anchors from its own
        # CSR copy (the same collect the host path runs) and only f/p/flag
        # are read back
        self.ship_anchors = ship_anchors
        if mesh is None:
            self.device = torch.device(device)
            self.dx = device_index_cached(mi, self.device)
        else:
            from ..ops.seeds_device import shard_index_tables
            self.device = mesh.device
            self.n_index, self.n_data = mesh.n_index, mesh.n_data
            (khi, klo, starts, vhi, vlo, _kp, _vp,
             cuts) = shard_index_tables(mi, self.n_index)
            mesh.put("flow", dict(khi=khi, klo=klo, starts=starts, vhi=vhi,
                                  vlo=vlo))
            self._cuts = np.asarray(cuts, dtype=np.int64)  # key-pos ranges

    def _launch(self, q: dict, *, cap, gq, gr, use_exc):
        """One bucket's device step. `q` holds the bucket's host arrays:
        qposidx (single device) or qhi/qlo/nmv (mesh), and qpos, qspan8,
        qls, nn, w1, exc. Returns (xhi, xlo, yhi, ylo, f, p, flag)."""
        if self.mesh is not None:
            from .device_pipeline import sharded_flow_step
            opt = self.opt
            return tuple(self.mesh.step(
                sharded_flow_step,
                {k: q[k] for k in ("qhi", "qlo", "qpos", "qspan8", "nmv",
                                   "qls", "nn", "w1", "exc")},
                table="flow", max_occ=opt.mid_occ, cap=cap,
                max_dist_x=gr, max_dist_y=gq, bw=opt.bw,
                max_skip=opt.max_chain_skip, use_exc=use_exc))
        return self.step(self.place(q), cap=cap, gq=gq, gr=gr,
                         use_exc=use_exc)

    def place(self, q: dict) -> dict:
        """A single-device bucket's host arrays as tensors on the device."""
        return {k: torch.from_numpy(q[k]).to(self.device)
                for k in ("qposidx", "qpos", "qspan8", "qls", "nn", "w1",
                          "exc")}

    def step(self, d: dict, *, cap, gq, gr, use_exc):
        """flow_step on a bucket that place() put on the device."""
        opt = self.opt
        return flow_step(self.dx, d["qposidx"], d["qpos"], d["qspan8"],
                         opt.mid_occ, d["qls"], d["nn"], d["w1"], d["exc"],
                         cap=cap, max_dist_x=gr, max_dist_y=gq, bw=opt.bw,
                         max_skip=opt.max_chain_skip, use_exc=use_exc)

    def buckets(self, units):
        """The fused step's work for `units` (a list of (segs, UnitInfo)):
        each read's eligibility and the fill of its bucket. Returns
        (results, stats, buckets): `results` the Chains of the reads with
        no hit (their info.sh is filled here; no device work), `stats` the
        host seed stats by unit index, and `buckets`, sorted by
        (mb, cb, gq, gr), a list of (entries, q, kw): the rows' (unit
        index, w1, exceptions), the host arrays and _launch's keywords.
        Ineligible units appear in neither and are left for the staged
        path."""
        opt, mi = self.opt, self.mi
        results: dict[int, Chains] = {}
        stats: dict[int, tuple] = {}
        by_bucket: dict[tuple, list] = {}
        for k, (segs, info) in enumerate(units):
            if len(info.segs) != 1 or info.mv is None or len(info.mv) == 0:
                continue
            mb = next((m for m in M_BUCKETS if len(info.mv) <= m), None)
            if mb is None:
                continue
            n, span_sum, over, pos, occ = host_seed_stats(mi, info.mv,
                                                          opt.mid_occ)
            stats[k] = (n, span_sum, over, pos, occ)
            if n == 0:
                # the empty SeedHits is assembled on the host; no device work
                info.sh = self._seedhits(info.mv, over,
                                         np.empty((0, 2), np.uint64))
                results[k] = Chains(np.empty((0, 2), np.uint64),
                                    np.empty(0, np.uint64))
                continue
            cb = next((c for c in CAP_BUCKETS if n <= c), None)
            if cb is None:
                continue  # anchor overflow -> staged path
            if self.mesh is not None:
                # capacity-bounded routing: every shard's compact hit
                # buffer (cap / n_index slots) must hold this read's hits
                # on that shard: bump the bucket or leave the read
                sh_id = np.searchsorted(self._cuts[1:-1], pos, side="right")
                per_shard = np.bincount(sh_id, weights=occ,
                                        minlength=self.n_index)
                need = int(per_shard.max()) * self.n_index
                cb = next((c for c in CAP_BUCKETS
                           if n <= c and need <= c), None)
                if cb is None:
                    continue  # shard-skewed read -> staged path
            avg = np.float32(span_sum) / np.float32(n)
            if avg < 1.6:  # c_log shortcut domain (chain_pack)
                continue
            w1, excl = CP.clin_slope_exc(avg)
            if excl is None:
                continue  # exception overflow -> staged path
            key = (mb, cb, info.gap_qry, info.gap_ref)
            by_bucket.setdefault(key, []).append((k, w1, excl))

        out = []
        mesh = self.mesh
        for (mb, cb, gq, gr), entries in sorted(by_bucket.items()):
            # a mesh splits the rows over its data ranks
            R = len(entries) if mesh is None \
                else -(-len(entries) // self.n_data) * self.n_data
            q = dict(qpos=np.zeros((R, mb), np.int32),
                     qspan8=np.zeros((R, mb), np.uint8),  # UNSIGNED: HPC
                     #   spans reach 255 (sketch.c:111); int8 would wrap
                     qls=np.zeros((R, 1), np.int32),
                     nn=np.zeros((R, CP.LANES), np.int32),
                     w1=np.zeros((R, CP.LANES), np.float32),
                     exc=np.full((R, CP.LANES), -1, np.int32))
            if mesh is None:
                q["qposidx"] = np.full((R, mb), -1, np.int32)
            else:
                q.update(qhi=np.full((R, mb), 0x7FFFFFFF, np.int32),
                         qlo=np.zeros((R, mb), np.int32),
                         nmv=np.zeros((R, 1), np.int32))
            for r, (k, w1, excl) in enumerate(entries):
                info = units[k][1]
                mv = info.mv
                nmv = len(mv)
                _n, _ss, over_k, pos_k, occ_k = stats[k]
                if mesh is None:
                    found_k = (occ_k > 0) | over_k
                    q["qposidx"][r, :nmv] = np.where(found_k, pos_k, -1)
                else:
                    q["qhi"][r, :nmv], q["qlo"][r, :nmv] = split_u64(
                        mv[:, 0] >> np.uint64(8))
                    q["nmv"][r, 0] = nmv
                q["qpos"][r, :nmv] = (mv[:, 1]
                                      & np.uint64(0xFFFFFFFF)).astype(np.int64)
                q["qspan8"][r, :nmv] = (mv[:, 0]
                                        & np.uint64(0xFF)).astype(np.int64)
                q["qls"][r, 0] = info.qlen_sum
                q["nn"][r, 0] = stats[k][0]
                q["w1"][r, 0] = w1
                for j, (dd, val) in enumerate(excl):
                    q["exc"][r, 2 * j] = dd
                    q["exc"][r, 2 * j + 1] = val
            out.append((entries, q, dict(cap=cb, gq=gq, gr=gr,
                                         use_exc=CP.infer_use_exc(q["exc"]))))
        return results, stats, out

    def run(self, units, timers: Timers | None = None) -> dict[int, Chains]:
        """Run eligible units through the fused device step.

        `units` is a list of (segs, UnitInfo); eligible units get info.sh
        filled (anchors from the device, host-computed rep_len / mini_pos)
        and an entry in the returned {unit_index: Chains} dict. Ineligible
        or fallback units are left for the staged path."""
        timers = timers if timers is not None else Timers()
        opt, mi = self.opt, self.mi
        results, stats, buckets = self.buckets(units)
        staged = []
        for entries, q, kw in buckets:
            with timers.time("kernel"):
                out = self._launch(q, **kw)
            staged.append((entries, out))

        from ..native import chain_bottom_native
        from ..ops.seeds import collect_seed_hits
        # host-side anchor re-derivation overlaps the device execution of
        # the staged dispatches (nothing above waited on the device)
        host_sh: dict[int, SeedHits] = {}
        if not self.ship_anchors:
            with timers.time("seed"):
                for entries, _out in staged:
                    for k, _, _ in entries:
                        info = units[k][1]
                        host_sh[k] = collect_seed_hits(
                            mi, opt.flag, opt.mid_occ, info.mv, None,
                            info.qlen_sum)

        for entries, out in staged:
            with timers.time("kernel"):
                xhi, xlo, yhi, ylo, f, p, flag = out
                if self.ship_anchors:
                    fetch = (xhi, xlo, yhi, ylo, f, p, flag[:, 0])
                else:
                    fetch = (f, p, flag[:, 0])
                arrs = [t.cpu().numpy() for t in fetch]
            if self.ship_anchors:
                xhi, xlo, yhi, ylo, f, p, flag = arrs
            else:
                f, p, flag = arrs
            with timers.time("bottom"):
                if self.ship_anchors:
                    # u64 anchor assembly, one vectorized pass per bucket
                    ax = ((xhi.astype(np.int64) & 0xFFFFFFFF)
                          .astype(np.uint64)
                          << np.uint64(32)) | xlo.astype(np.uint64)
                    ay = ((yhi.astype(np.int64) & 0xFFFFFFFF)
                          .astype(np.uint64)
                          << np.uint64(32)) | ylo.astype(np.uint64)
                for r, (k, _, _) in enumerate(entries):
                    info = units[k][1]
                    n, _span_sum, over = stats[k][:3]
                    if flag[r]:
                        # skip-divergence -> exact host recompute; the
                        # host-derived SeedHits stay usable
                        timers.count("fallback")
                        if k in host_sh:
                            info.sh = host_sh[k]
                        continue
                    if self.ship_anchors:
                        anchors = np.stack([ax[r, :n], ay[r, :n]], axis=1)
                        info.sh = self._seedhits(info.mv, over, anchors)
                    else:
                        info.sh = host_sh[k]
                        anchors = info.sh.anchors
                        if len(anchors) != n:  # err_flag pattern
                            timers.count("fallback")
                            continue
                    ch = chain_bottom_native(anchors, f[r, :n], p[r, :n],
                                             opt.min_cnt,
                                             opt.min_chain_score)
                    if ch is None:  # no native lib: exact Python bottom
                        v = _v_from_fp(f[r, :n], p[r, :n])
                        cx, cy, cf, cp = compact_from_fpv(
                            anchors, f[r, :n], p[r, :n], v,
                            opt.min_chain_score)
                        ch = chain_backtrack(cx, cy, cf, cp, opt.min_cnt,
                                             opt.min_chain_score)
                    results[k] = ch
                    timers.count("device_reads")
        return results

    @staticmethod
    def _seedhits(mv, over, anchors) -> SeedHits:
        from ..ops.seeds import mini_pos_of
        return SeedHits(anchors, _rep_len(mv, over), mini_pos_of(mv, ~over))
