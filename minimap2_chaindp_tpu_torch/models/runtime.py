"""TorchRuntime: batched mapping on one device, the fused flow first and
the staged path for everything else.

Port of the single-chip path of minimap2_chaindp_tpu/models/runtime.py
(`map_stream` :243-269, `_map_batch1` :503-789 without the lanes, the share
controller and the probe):
- every single-segment unit the fused flow accepts is seeded and chained
  on the device (models/device_flow.DeviceFlow.run) and finished by one
  native host call (regions, extension on host SIMD, mapq, SAM/PAF text);
- every other fragment (splice reads, paired-end and multi-segment
  fragments, flow fallbacks, reads the native finish declines) takes the
  staged path: host seed collection, the chain kernel over size buckets
  (`_chain_batch`), then the extension waves of all in-flight reads through
  `run_scheduler` into the CUDA ksw2 kernels (models/batch_align.py), and
  the SAM/PAF text.
Output is byte-identical to HostRuntime.
"""
from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from .. import constants as C
from ..ops import chain_pack as CP
from ..ops.chain import Chains, chain_backtrack
from ..ops.chain_dp import chain_scores_batch
from ..ops.chain_host import _v_from_fp, compact_from_fpv, split_anchors
from ..utils.timers import Timers
from .batch_align import CudaAlignExecutor, run_scheduler
from .device_flow import DeviceFlow, flow_mode_ok
from .pipeline import (finish_unit_gen, format_frag, host_chain,
                       prepare_frag, seed_unit)

# staged chain buckets: a unit takes the smallest that holds its anchors
# (models/runtime.py:21); past the last one it chains on the host
BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
_CHAIN_FIELDS = ("xhi", "rpos", "qpos", "span", "sid", "stw")


class TorchRuntime:
    """Maps fragments in batches on one device; output order == input
    order. Same surface as HostRuntime (map_batch / map_stream); the
    staged path runs on the calling thread, so `n_threads` only sets the
    HostRuntime-compatible signature."""

    def __init__(self, mi, opt, device="cuda", n_threads: int = 1):
        del n_threads
        self.mi = mi
        self.opt = opt
        self.device = torch.device(device)
        self.timers = Timers()
        self._flow = None
        self._flow_lock = threading.Lock()
        # the staged units run the Python align skeleton, which yields the
        # extension waves; the native one-call skeleton is switched off on
        # a copy only (models/runtime.py:872-878), since on the shared
        # opt it would also switch off the flow's native finish
        self._opt_staged = copy.copy(opt)
        self._opt_staged.native_skeleton = False
        self.align_exec = CudaAlignExecutor(self._opt_staged,
                                            device=self.device,
                                            timers=self.timers)

    def _get_flow(self):
        """The fused flow, built (and the CSR tables uploaded) on first
        use, and only when the run's mode can take it."""
        if not flow_mode_ok(self.opt):
            return None
        if self._flow is None:
            with self._flow_lock:
                if self._flow is None:
                    self._flow = DeviceFlow(self.mi, self.opt,
                                            device=self.device)
        return self._flow

    def map_stream(self, batches, rg_id: str = ""):
        """2-deep threaded pipeline over read batches (kt_pipeline step
        overlap, map.c:637): batch k+1's host work interleaves with batch
        k's device waits and native calls, which release the GIL."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = deque()
            for batch in batches:
                futs.append(ex.submit(self.map_batch, batch, rg_id))
                if len(futs) >= 2:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()

    def map_batch(self, frags, rg_id: str = "") -> list[list[str]]:
        """Map a batch of fragments; returns per-fragment output lines."""
        from ..native import (map_unit_ok,
                                                 map_unit_text_chains_native)
        opt, mi = self.opt, self.mi
        frag_meta, units = [], []
        with self.timers.time("seed"):
            for frag in frags:
                work, flipped, us = prepare_frag(opt, frag.segs)
                start = len(units)
                for u in us:
                    units.append((u, seed_unit(mi, opt, u,
                                               collect_hits=False)))
                frag_meta.append((frag.segs, work, flipped,
                                  slice(start, len(units))))

        flow_chains: dict[int, Chains] = {}
        if any(len(u) == 1 for u, _ in units):
            flow = self._get_flow()
            if flow is not None:
                flow_chains = flow.run(units, self.timers)

        # native finish of flow-chained single-segment fragments
        lines: list = [None] * len(frags)
        done: set[int] = set()
        if flow_chains and map_unit_ok(opt, mi):
            with self.timers.time("align"):
                for fi, (segs, _w, _f, sl) in enumerate(frag_meta):
                    k = sl.start
                    if len(segs) != 1 or sl.stop - k != 1 \
                            or k not in flow_chains:
                        continue
                    info = units[k][1]
                    if info.sh is None:
                        continue
                    got = map_unit_text_chains_native(
                        mi, opt, segs[0], rg_id, flow_chains[k],
                        info.sh.rep_len, info.sh.mini_pos)
                    if got is not None:
                        lines[fi] = got
                        done.add(k)
                        self.timers.count("native_finish")

        # the staged path for every other unit
        staged = [k for k in range(len(units)) if k not in done]
        regs: dict[int, list] = {}
        if staged:
            self.timers.count("staged_frags",
                              sum(ls is None for ls in lines))
            pending = [units[k] for k in staged]
            with self.timers.time("seed"):
                self._seed_hits(pending)
            chains = self._chain_batch(pending, {
                i: flow_chains[k] for i, k in enumerate(staged)
                if k in flow_chains})
            with self.timers.time("align"):
                gens = [finish_unit_gen(mi, self._opt_staged, info, ch)
                        for (_u, info), ch in zip(pending, chains)]
                regs = dict(zip(staged, run_scheduler(gens,
                                                      self.align_exec)))
        with self.timers.time("epilogue"):
            for fi, (segs, work, flipped, sl) in enumerate(frag_meta):
                if lines[fi] is None:
                    regss = [r for k in range(sl.start, sl.stop)
                             for r in regs[k]]
                    lines[fi] = format_frag(mi, opt, segs, work, flipped,
                                            regss, rg_id)
        return lines

    def _seed_hits(self, units) -> None:
        """Fill UnitInfo.sh on the host for units the flow left without
        anchors (models/runtime.py:1052-1091, host branch)."""
        from ..ops.seeds import collect_seed_hits
        opt, mi = self.opt, self.mi
        for segs, info in units:
            if info.mv is not None and len(info.mv) and info.sh is None:
                info.sh = collect_seed_hits(mi, opt.flag, opt.mid_occ,
                                            info.mv, segs[0].name,
                                            info.qlen_sum)

    def _chain_batch(self, pending, precomputed=None) -> list[Chains]:
        """Chains of every unit, batched on the device by (size bucket, gap
        bounds, many_segs): port of models/runtime.py:1093-1195 without the
        native-chain crossover. `pending` is a list of (segs, UnitInfo);
        `precomputed` carries Chains the fused flow already made."""
        from ..native import chain_bottom_native
        opt = self.opt
        is_cdna = bool(opt.flag & C.MM_F_SPLICE)
        results: dict[int, Chains] = dict(precomputed or {})
        by_bucket: dict[tuple, list[int]] = {}
        host_idx: list[int] = []
        for k, (segs, info) in enumerate(pending):
            if k in results:
                continue
            if info.sh is None:
                results[k] = None
                continue
            n = len(info.sh.anchors)
            if n == 0:
                results[k] = Chains(np.empty((0, 2), np.uint64),
                                    np.empty(0, np.uint64))
                continue
            b = next((b for b in BUCKETS if n <= b), None)
            # oversized units and same-seg gap costs beyond the exact
            # table (bw genomic, max_dist_y cdna) chain on the host
            clin_dom = info.gap_qry if is_cdna else opt.bw
            if b is None or clin_dom >= CP.TBL:
                host_idx.append(k)
            else:
                key = (b, info.gap_qry, info.gap_ref, len(segs) > 1)
                by_bucket.setdefault(key, []).append(k)

        # dispatch every bucket before reading any back
        staged = []
        dev = self.device
        for (b, gq, gr, many), idxs in sorted(by_bucket.items()):
            reads = []
            for k in idxs:
                a = pending[k][1].sh.anchors
                xhi, rpos, qpos, span, sid = split_anchors(a)
                reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span,
                                  sid=sid, avg_qspan=np.float32(span.sum())
                                  / np.float32(len(a))))
            with self.timers.time("pack"):
                packed, nn, w1, exc, host_flag = CP.pack_reads(reads, b, gr)
            to_dev = lambda arr: torch.from_numpy(arr).to(dev)
            with self.timers.time("kernel"):
                out = chain_scores_batch(
                    *(to_dev(packed[x]) for x in _CHAIN_FIELDS),
                    to_dev(nn), to_dev(w1), to_dev(exc), max_n=b,
                    max_dist_x=gr, max_dist_y=gq, bw=opt.bw,
                    max_skip=opt.max_chain_skip, is_cdna=is_cdna,
                    many_segs=many, use_exc=CP.infer_use_exc(exc))
            staged.append((idxs, host_flag, out))
        for idxs, host_flag, (f, p, flag) in staged:
            with self.timers.time("kernel"):
                f, p, flag = (f.cpu().numpy(), p.cpu().numpy(),
                              flag[:, 0].cpu().numpy())
            with self.timers.time("bottom"):
                for r, k in enumerate(idxs):
                    if host_flag[r] or flag[r]:
                        host_idx.append(k)
                        self.timers.count("fallback")
                        continue
                    a = pending[k][1].sh.anchors
                    n = len(a)
                    ch = chain_bottom_native(a, f[r, :n], p[r, :n],
                                             opt.min_cnt,
                                             opt.min_chain_score)
                    if ch is None:  # no native library: exact Python
                        v = _v_from_fp(f[r, :n], p[r, :n])
                        cx, cy, cf, cp = compact_from_fpv(
                            a, f[r, :n], p[r, :n], v, opt.min_chain_score)
                        ch = chain_backtrack(cx, cy, cf, cp, opt.min_cnt,
                                             opt.min_chain_score)
                    results[k] = ch
                    self.timers.count("staged_device_reads")

        with self.timers.time("host_chain"):
            for k in host_idx:
                segs, info = pending[k]
                results[k] = host_chain(opt, info, len(segs))
        return [results[k] for k in range(len(pending))]
