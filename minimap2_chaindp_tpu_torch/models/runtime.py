"""TorchRuntime: batched mapping on one device, with the JAX runtime's
routings between the card's paths and the host's native lane.

Port of the single-chip path of minimap2_chaindp_tpu/models/runtime.py
(`map_stream` :243-269, `map_batch` :270-351, `_host_rt` :455-466,
`_map_batch1` :503-789, `_seed_hits` :1052-1091, `_chain_batch`
:1093-1195). The card's paths:
- every single-segment unit the fused flow accepts is seeded and chained
  on the device (models/device_flow.DeviceFlow.run) and finished by one
  native host call (regions, extension on host SIMD, mapq, SAM/PAF text);
- every other fragment of the card's share (splice reads, paired-end and
  multi-segment fragments, flow fallbacks, reads the native finish
  declines) takes the staged path: seed collection (on the host, or by key
  on the card with `device_seeds`), the chain kernel over size buckets
  (`_chain_batch`; units of at most `native_chain_max` anchors chain on the
  host), then each unit's back half (regions, alignment, mapq, pairing):
  the native driver's from the chains where the options have a CIGAR,
  dual-affine scoring and no splicing (models/replay.py), the align
  generators under `run_scheduler` otherwise, their extension jobs as
  waves into the CUDA ksw2 kernels either way (models/batch_align.py, jobs
  of at most `native_ext_max` bases on host SIMD), and the SAM/PAF text.

The routing decides which fragments take them (the environment names are
the JAX package's; cli.py maps them onto these arguments):
- "device" (default): every fragment takes the card's paths (the JAX
  runtime under MM2TPU_DEVICE_FLOW=1, share 1.0);
- "share": a fixed fraction `flow_share` of the flow-absorbable fragments
  takes the flow; the others that the host lane can take (single-segment
  and paired fragments, query length up to 5 bases an anchor of
  `native_chain_max`) are mapped whole by the native driver on the `-t`
  pool, single-segment ones in chunks of 24 (MM2TPU_FLOW_SHARE);
- "steal": the host lane drains each batch from the front while the
  device lane pulls chunks from the back (models/steal.py; MM2TPU_STEAL=1,
  which the JAX runtime takes by default once its link probe lets the
  flow on);
- "host": every batch goes to a HostRuntime over the same `-t` pool.
With `mesh_shape=(D, I)` (:136-147, :1013-1025) the fused flow runs on a
parallel/mesh.Mesh of D x I ranks, the index key-range-sharded over I
(models/device_flow.DeviceFlow(mesh=...)); the routing is "device", as
--mesh pins it in JAX, and the staged path stays on this process's device.
Left out, with the JAX lines they take: calibration and the link probe
(:884-1002), the ripeness gate and deferred init (:289-323, :363-453), the
share controller and persisted state (:468-501, :769-843), the ext lane
(:208-241, :561-569, :693-740, :857-882) and device_guard (every
`device_call`, `device_bad` and `DeviceStall`). A CUDA error raises.
Output is byte-identical to HostRuntime under every routing.
"""
from __future__ import annotations

import copy
import threading

import numpy as np
import torch

from .. import constants as C
from ..ops import chain_pack as CP
from ..ops.chain import Chains, chain_backtrack
from ..ops.chain_dp import (chain_scores_batch, count_launch, window_pairs,
                             work_mode)
from ..ops.chain_host import _v_from_fp, compact_from_fpv, split_anchors
from ..utils.trace import Tracer, active, carry
from .batch_align import CudaAlignExecutor, run_scheduler
from .device_flow import CAP_BUCKETS, M_BUCKETS, DeviceFlow, flow_mode_ok
from .pipeline import (finish_unit_gen, format_frag, host_chain,
                       map_fragment_output, prepare_frag, seed_unit)
from .replay import ReplayFinish
from .steal import BASE_NICE, HOST_CH, thread_nice

# staged chain buckets: a unit takes the smallest that holds its anchors
# (models/runtime.py:21); past the last one it chains on the host
BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
_CHAIN_FIELDS = ("xhi", "rpos", "qpos", "span", "sid", "stw")
ROUTINGS = ("device", "share", "steal", "host")
# the steal lane needs a batch of at least two of the JAX sub-round
# chunks (:324-326)
STEAL_MIN_FRAGS = 2 * 64
# the flow's minimizer bucket (~qlen/5.3 entries) binds before its anchor
# capacity at occ ~1: longer reads never take the flow (:528-531)
DEV_QLEN_MAX = min(M_BUCKETS[-1], CAP_BUCKETS[-1]) * 5
_END = object()      # map_stream's end of input


class _ChunkView:
    """Per-fragment view into a chunked host-lane future (the batched
    native call returns the whole chunk's line lists)."""
    __slots__ = ("fut", "j")

    def __init__(self, fut, j):
        self.fut, self.j = fut, j

    def result(self):
        return self.fut.result()[self.j]


class TorchRuntime:
    """Maps fragments in batches; output order == input order. Same
    surface as HostRuntime (map_batch / map_stream). `n_threads - 1`
    workers serve the host lane's native calls; the staged path runs on
    the calling thread."""

    def __init__(self, mi, opt, device="cuda", n_threads: int = 1,
                 routing: str = "device", flow_share: float | None = None,
                 native_chain_max: int = 0, native_ext_max: int = 0,
                 device_seeds: bool = False,
                 mesh_shape: tuple[int, int] | None = None,
                 mesh_devices: list | None = None):
        if routing not in ROUTINGS:
            raise ValueError(f"routing must be one of {ROUTINGS}: {routing!r}")
        self.mesh_shape = mesh_shape
        self._mesh = None
        if mesh_shape is not None:
            from ..parallel.mesh import mesh_devices as default_devices
            nd, ni = mesh_shape
            if nd < 1 or ni < 1 or CAP_BUCKETS[0] % ni != 0:
                # every capacity bucket must split evenly over the index
                # axis (they are powers of two)
                raise ValueError(
                    f"--mesh {nd}x{ni}: the index axis must divide the "
                    f"{CAP_BUCKETS[0]}-slot capacity buckets; use a power "
                    "of two")
            if routing != "device":
                raise ValueError("a mesh runs the device routing, not "
                                 f"{routing!r}")
            if mesh_devices is None:
                mesh_devices = default_devices(nd * ni, device)
        self._mesh_devices = mesh_devices
        if routing == "share" and not (flow_share is not None
                                       and 0.0 < flow_share < 1.0):
            raise ValueError("routing 'share' needs 0 < flow_share < 1")
        self.mi = mi
        self.opt = opt
        self.device = torch.device(device)
        self.routing = routing
        self.flow_share = flow_share if routing == "share" else 1.0
        self.native_chain_max = int(native_chain_max)
        self.native_ext_max = int(native_ext_max)
        self.device_seeds = bool(device_seeds)
        self.timers = Tracer()
        self._flow = None
        self._flow_lock = threading.Lock()
        # the flow's build: its own lock, so that the build, which may run
        # on a thread of its own (_start_flow_build), holds up no other
        # user of _flow_lock; set once a flow exists or its build failed
        self._build_lock = threading.Lock()
        self._flow_built = threading.Event()
        self._flow_thread = None
        self._flow_error = None
        self._flow_error_raised = False
        self._seed_collector = None
        # -t worker pool for the host lane (kt_for over fragments,
        # kthread.c:125; :198-207)
        self.n_threads = max(1, int(n_threads))
        self._pool = None
        if self.n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_threads - 1,
                thread_name_prefix="mm2tpu-worker")
        self._lane_ex = None
        self._host = None
        # the steal lane's join-tail reserve: map_stream clears it while
        # more batches are coming (:251-268)
        self._draining = True
        self._steal_state = None
        # the staged units run on a copy of opt, on which the executor
        # switches the native one-call skeleton off below its crossover
        # (the JAX _sync_native_skeleton); on the shared opt it would also
        # switch off the flow's native finish and the host lane
        self._opt_staged = copy.copy(opt)
        self.align_exec = CudaAlignExecutor(self._opt_staged,
                                            device=self.device,
                                            timers=self.timers,
                                            native_max=self.native_ext_max)
        self._replay = ReplayFinish(mi, opt, self.align_exec)

    def close(self) -> None:
        """Wait for a flow build still running on its own thread, stop the
        host lane's worker threads and tear the mesh down; the bytes its
        ranks sent each other in steps are counted as mesh_bytes (of them
        the all_gather's as mesh_allgather_bytes) and the index shards sent
        at set-up as mesh_table_bytes. Raises the exception of a failed
        build that no batch has raised."""
        if self._flow_thread is not None:
            self._flow_thread.join()
        for ex in (self._pool, self._lane_ex):
            if ex is not None:
                ex.shutdown(wait=True)
        self._pool = self._lane_ex = None
        if self._host is not None:
            self._host._pool = None
        if self._mesh is not None:
            tot = self._mesh.close()
            self._mesh = None
            if tot is not None:
                from ..parallel.mesh import STEP_KINDS
                self.timers.count("mesh_bytes",
                                  sum(tot[k] for k in STEP_KINDS))
                self.timers.count("mesh_allgather_bytes", tot["all_gather"])
                self.timers.count("mesh_table_bytes", tot["tables"])
        if self._flow_error is not None and not self._flow_error_raised:
            self._flow_error_raised = True
            raise self._flow_error

    def describe(self) -> str:
        """The routing and its settings, for the [timers] line."""
        share = f" flow_share={self.flow_share}" \
            if self.routing == "share" else ""
        mesh = "" if self.mesh_shape is None else \
            " mesh={}x{}".format(*self.mesh_shape)
        return (f"routing={self.routing}{share} "
                f"native_chain_max={self.native_chain_max} "
                f"native_ext_max={self.native_ext_max} "
                f"device_seeds={int(self.device_seeds)} "
                f"threads={self.n_threads}{mesh}")

    def _get_flow(self):
        """The fused flow, built (and the CSR tables uploaded) on first
        use, and only when the run's mode can take it."""
        if not flow_mode_ok(self.opt):
            return None
        if self._flow is None:
            with self._build_lock:
                if self._flow is None:
                    if self.mesh_shape is not None:
                        from ..parallel.mesh import Mesh
                        self._mesh = Mesh(*self.mesh_shape,
                                          devices=self._mesh_devices)
                    self._flow = DeviceFlow(self.mi, self.opt,
                                            device=self.device,
                                            mesh=self._mesh)
                    self._flow_built.set()
        return self._flow

    def _start_flow_build(self) -> None:
        """Start the flow's build on a thread of its own, once, at the
        niceness of an unproven device lane: the stealing routing's batches
        map on the host lane meanwhile and never wait on the CSR upload.
        Raises the exception of a build that failed."""
        with self._flow_lock:
            if self._flow_thread is None and self._flow is None:
                self._flow_thread = threading.Thread(
                    target=self._build_flow, daemon=True,
                    name="mm2tpu-flow-build")
                self._flow_thread.start()
        if self._flow_error is not None:
            self._flow_error_raised = True
            raise self._flow_error

    def _build_flow(self) -> None:
        thread_nice(BASE_NICE)
        try:
            self._get_flow()
        except BaseException as e:   # raised by the next batch or close()
            self._flow_error = e
        finally:
            self._flow_built.set()

    def _host_rt(self):
        """The HostRuntime of the "host" routing, sharing this runtime's
        timers and -t pool (:455-466)."""
        if self._host is None:
            with self._flow_lock:
                if self._host is None:
                    from .host_runtime import HostRuntime
                    h = HostRuntime(self.mi, self.opt, n_threads=1)
                    h.n_threads = self.n_threads
                    h._pool = self._pool
                    h.timers = self.timers
                    self._host = h
        return self._host

    def _host_lane_ex(self):
        """The -t pool, or with -t 1 a single worker of its own, so the
        host lane still overlaps the card's waits (:845-855)."""
        if self._pool is not None:
            return self._pool
        if self._lane_ex is None:
            with self._flow_lock:
                if self._lane_ex is None:
                    from concurrent.futures import ThreadPoolExecutor
                    self._lane_ex = ThreadPoolExecutor(
                        max_workers=1, thread_name_prefix="mm2tpu-hostlane")
        return self._lane_ex

    def map_stream(self, batches, rg_id: str = ""):
        """2-deep threaded pipeline over read batches (kt_pipeline step
        overlap, map.c:637): batch k+1's host work interleaves with batch
        k's device waits and native calls, which release the GIL. While
        more batches are coming the steal lane may pull up to the tail."""
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor
        self._draining = False
        try:
            with ThreadPoolExecutor(max_workers=2) as ex:
                futs = deque()
                it = iter(batches)
                while True:
                    with self.timers.time("feed_wait"):
                        batch = next(it, _END)
                    if batch is _END:
                        break
                    futs.append(ex.submit(self.map_batch, batch, rg_id))
                    if len(futs) >= 2:
                        yield futs.popleft().result()
                self._draining = True
                while futs:
                    yield futs.popleft().result()
        finally:
            self._draining = True

    def map_batch(self, frags, rg_id: str = "") -> list[list[str]]:
        """Map a batch of fragments; returns per-fragment output lines.
        The batch's spans are children of its `map_batch` span."""
        from ..native import map_unit_ok
        with self.timers.time("map_batch"):
            if self.routing == "host":
                return self._host_rt().map_batch(frags, rg_id)
            # the stealing lanes need a host lane, the one-call native
            # driver (:325-326, :353-361)
            if (self.routing == "steal" and len(frags) >= STEAL_MIN_FRAGS
                    and map_unit_ok(self.opt, self.mi)
                    and not self.device_seeds):
                from .steal import run_steal_batch
                return run_steal_batch(self, frags, rg_id)
            return self._map_batch1(frags, rg_id, self.flow_share
                                    if self.routing == "share" else 1.0)

    def _map_batch1(self, frags, rg_id: str, share: float):
        """One batch over the card's paths and, where `share` < 1 or the
        flow cannot take the mode, the host lane (:503-789)."""
        from ..native import (map_batch_text_native, map_frag_pe_native,
                              map_unit_ok, map_unit_text_chains_native,
                              map_unit_text_native)
        opt, mi = self.opt, self.mi
        flow_ok = flow_mode_ok(opt)
        unit_ok = map_unit_ok(opt, mi)
        fast_ok = unit_ok and not self.device_seeds
        ncm = self.native_chain_max
        # below the chain crossover a read would chain and extend on the
        # host anyway: it takes the host lane whole. With no flow for the
        # mode every read goes there, and reads past every flow bucket
        # too; a crossover of 0 turns the host lane off (:513-533)
        fast_qlen_max = float("inf") if ncm > 0 and not flow_ok else ncm * 5
        if not flow_ok:
            dev_fids: set = set()
        elif not fast_ok or share >= 1.0:
            dev_fids = set(range(len(frags)))
        else:
            # the flow's share is spread over flow-absorbable fragments only
            cand = [i for i, fr in enumerate(frags)
                    if len(fr.segs) == 1
                    and len(fr.segs[0].seq) <= DEV_QLEN_MAX]
            dev_fids = {cand[i] for i in range(len(cand))
                        if int((i + 1) * share) > int(i * share)}

        def fast_eligible(fi, frag):
            if not fast_ok or fi in dev_fids or len(frag.segs) > 2:
                return False
            qlen = sum(len(s.seq) for s in frag.segs)
            return qlen <= fast_qlen_max or (ncm > 0 and flow_ok
                                             and qlen > DEV_QLEN_MAX)

        def fast_one(frag):
            if len(frag.segs) == 1:
                return map_unit_text_native(mi, opt, frag.segs[0], rg_id)
            return map_frag_pe_native(mi, opt, frag.segs, rg_id)

        def fast_chunk(idxs):
            res = map_batch_text_native(
                mi, opt, [frags[i].segs[0] for i in idxs], rg_id)
            return res if res is not None else [fast_one(frags[i])
                                                for i in idxs]

        host_futs: dict = {}
        if fast_ok:
            ex = None
            se_elig = []
            for fi, frag in enumerate(frags):
                if fast_eligible(fi, frag):
                    ex = ex or self._host_lane_ex()
                    if len(frag.segs) == 1:
                        se_elig.append(fi)
                    else:
                        host_futs[fi] = ex.submit(carry(fast_one), frag)
            # chunks of single-segment reads per native call (:622)
            for st in range(0, len(se_elig), HOST_CH):
                idxs = se_elig[st:st + HOST_CH]
                fut = ex.submit(carry(fast_chunk), idxs)
                for j, fi in enumerate(idxs):
                    host_futs[fi] = _ChunkView(fut, j)

        frag_meta, units = [], []
        with self.timers.time("seed"), self.timers.time("sketch"):
            for fi, frag in enumerate(frags):
                if fi in host_futs:
                    frag_meta.append(None)
                    continue
                work, flipped, us = prepare_frag(opt, frag.segs)
                start = len(units)
                for u in us:
                    units.append((u, seed_unit(mi, opt, u,
                                               collect_hits=False)))
                frag_meta.append((frag.segs, work, flipped,
                                  slice(start, len(units))))

        flow_chains: dict[int, Chains] = {}
        if flow_ok and any(len(u) == 1 for u, _ in units):
            flow_chains = self._get_flow().run(units, self.timers)

        # native finish of flow-chained single-segment fragments; the
        # query bases it finished and the reads it declined are counted
        # once a batch
        lines: list = [None] * len(frags)
        done: set[int] = set()
        if flow_chains and unit_ok:
            fin_bases = declined = 0
            with self.timers.time("align"), \
                    self.timers.time("native_finish"):
                for fi, meta in enumerate(frag_meta):
                    if meta is None:
                        continue
                    segs, _w, _f, sl = meta
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
                    if got is None:
                        declined += 1
                        continue
                    lines[fi] = got
                    done.add(k)
                    self.timers.count("native_finish")
                    fin_bases += len(segs[0].seq)
            if fin_bases:
                self.timers.count("native_finish_bases", fin_bases)
            if declined:
                self.timers.count("native_finish_declined", declined)

        # the staged path for every other unit
        staged = [k for k in range(len(units)) if k not in done]
        regs: dict[int, list] = {}
        if staged:
            self.timers.count("staged_frags", sum(
                lines[fi] is None and meta is not None
                for fi, meta in enumerate(frag_meta)))
            pending = [units[k] for k in staged]
            with self.timers.time("seed"), self.timers.time("seed_hits"):
                self._seed_hits(pending)
            chains = self._chain_batch(pending, {
                i: flow_chains[k] for i, k in enumerate(staged)
                if k in flow_chains})
            with self.timers.time("align"), \
                    self.timers.time("staged_align"):
                regs = dict(zip(staged, self._finish_staged(pending,
                                                            chains)))
        with self.timers.time("epilogue"):
            for fi, meta in enumerate(frag_meta):
                if fi in host_futs:
                    res = host_futs[fi].result()
                    if res is None:
                        # rare contract fallback: exact synchronous host map
                        res = map_fragment_output(mi, opt, frags[fi].segs,
                                                  rg_id)
                        self.timers.count("host_fallback_frag")
                    else:
                        self.timers.count("fast_native")
                    lines[fi] = res
                elif lines[fi] is None:
                    segs, work, flipped, sl = meta
                    regss = [r for k in range(sl.start, sl.stop)
                             for r in regs[k]]
                    lines[fi] = format_frag(mi, opt, segs, work, flipped,
                                            regss, rg_id)
        return lines

    def _finish_staged(self, pending, chains) -> list:
        """Each staged unit's per-segment regions: the native finish from
        the chains where the run's options take it (models/replay.py),
        the align generators under run_scheduler for the rest. Counts
        replay_units and replay_declined."""
        out = self._replay.run(pending, chains) if self._replay.takes() \
            else [None] * len(pending)
        left = [i for i, r in enumerate(out) if r is None]
        if len(pending) > len(left):
            self.timers.count("replay_units", len(pending) - len(left))
        if left:
            self.timers.count("replay_declined", len(left))
            gens = [finish_unit_gen(self.mi, self._opt_staged,
                                    pending[i][1], chains[i]) for i in left]
            for i, r in zip(left, run_scheduler(gens, self.align_exec)):
                out[i] = r
        return out

    def _seed_hits(self, units) -> None:
        """Fill UnitInfo.sh for units the flow left without anchors: by key
        on the card with `device_seeds` (reads outside the collector's
        buckets, and the self/dual-skipping and strand-only modes, which
        need name-rank compares, map.c:146-185, on the host), else on the
        host (:1052-1091)."""
        from ..ops.seeds import collect_seed_hits
        opt, mi = self.opt, self.mi
        todo = [k for k, (_segs, info) in enumerate(units)
                if info.mv is not None and len(info.mv) and info.sh is None]
        got = [None] * len(units)
        if todo and self.device_seeds and not (
                opt.flag & (C.MM_F_NO_DIAG | C.MM_F_FOR_ONLY
                            | C.MM_F_REV_ONLY)):
            if self._seed_collector is None:
                with self._flow_lock:
                    if self._seed_collector is None:
                        from ..ops.seeds_device import DeviceSeedCollector
                        self._seed_collector = DeviceSeedCollector(
                            mi, self.device)
            res = self._seed_collector.collect_batch(
                [units[k][1].mv for k in todo], opt.mid_occ,
                [units[k][1].qlen_sum for k in todo])
            for k, sh in zip(todo, res):
                got[k] = sh
        for k in todo:
            segs, info = units[k]
            if got[k] is not None:
                info.sh = got[k]
                self.timers.count("device_seed")
            else:
                info.sh = collect_seed_hits(mi, opt.flag, opt.mid_occ,
                                            info.mv, segs[0].name,
                                            info.qlen_sum)
                self.timers.count("host_seed")

    def _chain_batch(self, pending, precomputed=None) -> list[Chains]:
        """Chains of every unit, batched on the device by (size bucket, gap
        bounds, many_segs): port of models/runtime.py:1093-1195. `pending`
        is a list of (segs, UnitInfo); `precomputed` carries Chains the
        fused flow already made. Units of at most `native_chain_max`
        anchors chain on the host (counter host_chain), and so do units
        with more anchors than the last bucket (host_chain_oversized) and,
        of the others, those whose gap-cost domain reaches the table's end
        (host_chain_bw), as in the JAX package (:1116-1121)."""
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
                self.timers.count("host_chain_oversized" if b is None
                                  else "host_chain_bw")
            elif n <= self.native_chain_max:
                host_idx.append(k)
                self.timers.count("host_chain")
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
            host = [packed[x] for x in _CHAIN_FIELDS] + [nn, w1, exc]
            with self.timers.time("kernel"):
                with self.timers.time("chain_upload"):
                    args = [torch.from_numpy(a).to(dev) for a in host]
                with self.timers.time("chain_launch"):
                    out = chain_scores_batch(
                        *args, max_n=b, max_dist_x=gr, max_dist_y=gq,
                        bw=opt.bw, max_skip=opt.max_chain_skip,
                        is_cdna=is_cdna, many_segs=many,
                        use_exc=CP.infer_use_exc(exc))
            if active():
                in_bytes = sum(a.nbytes for a in host)
                count_launch(self.timers, work_mode(is_cdna, many),
                             window_pairs(packed["stw"], nn), in_bytes, out,
                             in_bytes)
            staged.append((idxs, host_flag, out))
        for idxs, host_flag, (f, p, flag) in staged:
            with self.timers.time("kernel"), \
                    self.timers.time("device_wait"):
                f, p, flag = (f.cpu().numpy(), p.cpu().numpy(),
                              flag[:, 0].cpu().numpy())
            if active():
                self.timers.count("chain_d2h_bytes",
                                  f.nbytes + p.nbytes + flag.nbytes)
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
