"""Host batched runtime: cross-read wave scheduling without a device.

The reference pays its ksw2 cost per call but keeps the calls native SIMD
(align.c:220 -> ksw2_*_sse); a Python per-job driver pays ~0.2 ms of
marshalling per extension call instead, which dominates the host path at
~6 extension jobs per read.  This runtime reuses the device runtime's
cross-read wave scheduler (models/batch_align.py) with the device disabled:
every in-flight read's current extension wave lands in ONE native batch
call, so the ctypes/marshalling cost amortizes across the whole batch.
Never imports jax — it is the mapping path when no TPU is attached (and the
permanent fallback when the device link is marked bad, the framework-level
err_flag of map.c:933-944).

Output is bit-identical to the per-fragment host pipeline and to the device
runtime (asserted by tests/test_host_runtime.py)."""
from __future__ import annotations

from ..utils.timers import Timers


class HostRuntime:
    """Maps fragments in batches on the host; output order == input order.

    Same surface as DeviceRuntime (map_batch / map_stream) so the CLI
    drives either through the identical streaming loop."""

    def __init__(self, mi, opt, n_threads: int = 1):
        self.mi = mi
        self.opt = opt
        self.timers = Timers()
        from .batch_align import HostAlignExecutor
        self._align_exec = HostAlignExecutor(opt)
        # -t worker pool (the reference's kt_for over fragments,
        # kthread.c:125/145): the one-call native fast path releases the
        # GIL for its whole C call, so fragments fan out across real cores;
        # results are collected in submission order (step-2 ordered output,
        # like kt_pipeline). Pool size -1: map_stream's 2-deep batch
        # pipeline already keeps one extra thread busy.
        self.n_threads = max(1, int(n_threads))
        self._pool = None
        if self.n_threads > 1:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=max(1, self.n_threads - 1),
                thread_name_prefix="mm2tpu-worker")

    def close(self) -> None:
        """Stop the -t worker pool."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def map_stream(self, batches, rg_id: str = ""):
        """2-deep threaded pipeline over read batches (kt_pipeline step
        overlap, map.c:637): native batch calls release the GIL, so batch
        k+1's Python work interleaves with batch k's native scans."""
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
        opt, mi = self.opt, self.mi
        from .batch_align import run_scheduler
        from .pipeline import (finish_unit_gen, format_frag, host_chain,
                               prepare_frag, seed_unit)

        from ..native import (map_batch_pe_native, map_batch_text_native,
                              map_frag_pe_native, map_unit_ok,
                              map_unit_text_native)
        fast_ok = map_unit_ok(opt, mi)

        def _fast_one(frag):
            # whole-fragment native fast path: one C call in, finished
            # SAM/PAF lines out (the GIL is released for the whole call)
            if len(frag.segs) == 1:
                return map_unit_text_native(mi, opt, frag.segs[0], rg_id)
            return map_frag_pe_native(mi, opt, frag.segs, rg_id)

        pre_fast: list = [None] * len(frags)
        pre_done = [False] * len(frags)

        def _chunked_batch(idxs, batch_fn):
            """Fan fragment indexes across the -t pool in chunks through a
            batched native call (kt_for over fragment ranges, GIL released
            per chunk); a chunk whose batch call is unavailable falls back
            to the per-fragment native path — only that chunk."""
            def run(ch):
                got = batch_fn(ch)
                if got is None:
                    got = [_fast_one(frags[i]) for i in ch]
                return got
            if self._pool is not None and len(idxs) > 2 * self.n_threads:
                W = self.n_threads
                cuts = [round(t * len(idxs) / W) for t in range(W + 1)]
                chunks = [idxs[cuts[t]:cuts[t + 1]] for t in range(W)]
                futs = [self._pool.submit(run, c) for c in chunks[1:]]
                parts = [run(chunks[0])] + [f.result() for f in futs]
            else:
                chunks = [idxs]
                parts = [run(idxs)]
            for ch, p in zip(chunks, parts):
                for i, lines in zip(ch, p):
                    pre_fast[i] = lines
                    pre_done[i] = True

        if fast_ok:
            # whole per-read/per-pair loops run in BATCHED native calls
            # (the per-fragment Python wrapper was ~39 of 57 us/read at
            # 150 bp sr)
            se = [i for i, f in enumerate(frags) if len(f.segs) == 1]
            pe = [i for i, f in enumerate(frags) if len(f.segs) == 2]
            with self.timers.time("seed"):
                if se:
                    _chunked_batch(se, lambda ch: map_batch_text_native(
                        mi, opt, [frags[i].segs[0] for i in ch], rg_id))
                if pe:
                    _chunked_batch(pe, lambda ch: map_batch_pe_native(
                        mi, opt, [frags[i].segs for i in ch], rg_id))

        frag_meta = []
        units = []           # (unit, info) for the staged path
        fast_lines: list = []  # per-FRAG finished text, or None
        with self.timers.time("seed"):
            for fi, frag in enumerate(frags):
                if fast_ok and len(frag.segs) <= 2:
                    lines_f = pre_fast[fi] if pre_done[fi] \
                        else _fast_one(frag)
                    if lines_f is not None:
                        self.timers.count("fast_native")
                        fast_lines.append(lines_f)
                        frag_meta.append(None)
                        continue
                    self.timers.count("fast_miss")
                fast_lines.append(None)
                work, flipped, us = prepare_frag(opt, frag.segs)
                start = len(units)
                for u in us:
                    units.append((u, seed_unit(mi, opt, u)))
                frag_meta.append((frag.segs, work, flipped,
                                  slice(start, len(units))))

        with self.timers.time("chain"):
            chains = [host_chain(opt, info, len(u)) for u, info in units]

        with self.timers.time("align"):
            gens = [finish_unit_gen(mi, opt, info, ch)
                    for (u, info), ch in zip(units, chains)]
            regss_per_unit = run_scheduler(gens, self._align_exec)

        lines: list[list[str]] = []
        with self.timers.time("epilogue"):
            for fi in range(len(frags)):
                if fast_lines[fi] is not None:
                    lines.append(fast_lines[fi])
                    continue
                segs, work, flipped, sl = frag_meta[fi]
                regss = [r for unit_regs in regss_per_unit[sl]
                         for r in unit_regs]
                lines.append(format_frag(mi, opt, segs, work, flipped,
                                         regss, rg_id))
        return lines
