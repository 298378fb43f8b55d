"""Work-stealing two-lane batch mapper: the port of
minimap2_chaindp_tpu/models/steal.py.

One shared work list per batch is consumed from the FRONT by the HOST lane
(whole reads through the batched native driver, on the calling thread) and
from the BACK by the DEVICE lane (the fused collect+chain flow and the
native chains-finish, on a worker thread of lower priority): the shape of
the reference's work-stealing workers (kthread.c:59-143), where a slow
worker contributes exactly what it finishes. The device lane pulls a
chunk only when enough work remains to keep the host lane busy past the
chunk's expected completion (the join-tail rule), so a batch never waits
on a device chunk longer than the chunk saved.

The lane measures both lanes' per-read cost (the lane thread's CPU time
for the device lane, wall time for the CPU-bound host lane) and pauses
pulling while a device read costs more host CPU than GUARD of a host read;
a paused lane probes one chunk every PROBE_S seconds. The decomposition of
the lane's CPU is exported as the timers counters
steal_cpu_{prep,flowhost,finish}_ms.

What differs from the JAX module, and why:
- the tunables are module constants, not environment reads;
- nothing is persisted (`_adopt_persisted`, `_persist`, `_wkey` serve the
  JAX package's link state, which is not ported);
- there is no device-owner thread: the lane launches and waits on its own
  thread, so its `time.thread_time()` is its whole host CPU, any spin in
  the CUDA synchronisation included (steal_cpu_dispatch_ms is gone); the
  owner's niceness (`set_owner_nice`) goes with it;
- DeviceFlow.run returns only the chains and no compiled shapes exist,
  so "cold" is decided per chunk at its pull: a chunk pulled before any
  chunk of the runtime had returned (it may pay the kernel library's
  load and the allocator's warm-up, and map_stream's two batches pull
  their first chunks together) feeds no estimate (the JAX lane asks
  DeviceFlow.run per call, steal.py:341, 363);
- no exception is caught on the card's path: a failed flow build or chunk
  stops the host lane at its next chunk and is re-raised by
  run_steal_batch after the join, with no hand-back of the chunk.
Output is byte-identical to the host path: each read is mapped by exactly
one lane, and both lanes emit the same native text.
"""
from __future__ import annotations

import os
import threading
import time
from collections import deque

HOST_CH = 24                    # host-lane batched-native chunk
DEV_CH = 16                     # the device lane's first chunk
# the chunk of a lane that is not unprofitable: a device chunk's fixed cost
# (dispatch and per-bucket launches) amortizes over its reads; two sizes
# only, as in the JAX lane (there every size was a compiled shape)
DEV_CH_MAX = 64
GUARD = 0.9                     # pause while dev CPU/read > GUARD * host
PROBE_S = 20.0                  # a paused lane probes one chunk this often
CHUNK_EST_S = 4.0               # the chunk wall estimate before any chunk
# niceness of an unproven or losing lane (0 once it pays its way)
BASE_NICE = 10
# EMA weight for per-chunk cost updates: heavy enough that one probe
# chunk meaningfully refreshes a stale verdict
_ALPHA = 0.4
# the host lane's best observed cost decays upward this much per second
# (for at most HOST_BEST_MAX_S seconds between chunks), and steps down 30%
# of the way to a faster chunk
HOST_BEST_GROW = 1.02
HOST_BEST_MAX_S = 60.0


class StealState:
    """Per-runtime lane-economics state; survives across batches so later
    batches start from measured costs, not estimates."""

    def __init__(self):
        self.dev_cpu_per_read = None    # EMA, seconds of host CPU / read
        self.host_per_read = None       # EMA, seconds wall (~CPU) / read
        self.host_best = None           # best observed, slow upward decay
        self.host_best_t = 0.0          # decay is per SECOND, not per chunk
        self.chunk_wall_ema = CHUNK_EST_S
        self.dev_ch = DEV_CH            # adaptive chunk size
        self.paused_at = None           # monotonic time the guard paused
        self.returned = False           # a device chunk has returned


def _ema(prev, x):
    if prev is None:
        return x
    if x < prev / 3.0 or x > prev * 3.0:
        return x   # regime change (link/code/load shift): re-learn, don't crawl
    return (1.0 - _ALPHA) * prev + _ALPHA * x


def _unprofitable(st: StealState) -> bool:
    if st.dev_cpu_per_read is None or st.host_per_read is None:
        return False
    # reference cost = what a host-mapped read SHOULD cost, not what it
    # costs while the lane itself contends for the core: the running EMA
    # inflates under lane pressure; host_best decays upward so real
    # slowdowns still raise the bar eventually
    ref = st.host_per_read
    if st.host_best is not None:
        ref = min(ref, st.host_best * 1.2)
    return st.dev_cpu_per_read > GUARD * ref


def _host_best_update(st: StealState, r: float, now: float) -> None:
    """A host chunk's per-read cost `r` at monotonic time `now`: the EMA,
    and the fast-down/slow-up estimate of the host lane's uncontended cost
    (steal.py:413-428)."""
    st.host_per_read = _ema(st.host_per_read, r)
    if st.host_best is None:
        st.host_best = r
    else:
        grow = HOST_BEST_GROW ** min(max(now - st.host_best_t, 0.0),
                                     HOST_BEST_MAX_S)
        hb = st.host_best * grow
        st.host_best = 0.7 * hb + 0.3 * r if r < hb else hb
    st.host_best_t = now


def _host_map_frag(rt, fr, rg_id):
    """Exact per-fragment host mapping for the shapes the batched driver
    does not take (PE pairs, rare contract fallbacks, >2-seg frags)."""
    from ..native import map_frag_pe_native, map_unit_text_native
    r = None
    if len(fr.segs) == 1:
        r = map_unit_text_native(rt.mi, rt.opt, fr.segs[0], rg_id)
    elif len(fr.segs) == 2:
        r = map_frag_pe_native(rt.mi, rt.opt, fr.segs, rg_id)
    if r is None:
        from .pipeline import map_fragment_output
        r = map_fragment_output(rt.mi, rt.opt, fr.segs, rg_id)
        rt.timers.count("host_fallback_frag")
    return r


def _host_map_chunk(rt, frags, idxs, rg_id) -> dict:
    """One host-lane chunk: single-segment reads through the one-call
    batched native driver (whole per-read loop in C, GIL released);
    everything else per-fragment."""
    from ..native import map_batch_text_native
    out = {}
    se = [i for i in idxs if len(frags[i].segs) == 1]
    if se:
        res = map_batch_text_native(
            rt.mi, rt.opt, [frags[i].segs[0] for i in se], rg_id)
        if res is not None:
            for i, lines in zip(se, res):
                out[i] = lines
            rt.timers.count("fast_native", len(se))
    for i in idxs:
        if out.get(i) is None:
            out[i] = _host_map_frag(rt, frags[i], rg_id)
    return out


def _dev_map_chunk(rt, frags, idxs, rg_id) -> dict:
    """One device-lane chunk: prepare + sketch, the fused collect+chain on
    the device (DeviceFlow), then the native post-chain finish (regions ->
    align -> mapq -> text in one C call). Reads the flow rejects
    (overflow, skip flag, empty) take the full native host map (counter
    steal_dev_fallback): exact either way. Returns {index: lines}."""
    from ..native import map_unit_text_chains_native, map_unit_text_native
    from .pipeline import map_fragment_output, prepare_frag, seed_unit
    tt = time.thread_time
    t0 = tt()
    units = []
    for i in idxs:
        _work, _flipped, us = prepare_frag(rt.opt, frags[i].segs)
        units.append((us[0], seed_unit(rt.mi, rt.opt, us[0],
                                       collect_hits=False)))
    t1 = tt()
    chains = rt._get_flow().run(units, rt.timers)
    t2 = tt()
    out = {}
    for k, i in enumerate(idxs):
        info = units[k][1]
        ch = chains.get(k)
        lines = None
        if ch is not None and info.sh is not None:
            lines = map_unit_text_chains_native(
                rt.mi, rt.opt, frags[i].segs[0], rg_id, ch,
                info.sh.rep_len, info.sh.mini_pos)
            if lines is not None:
                rt.timers.count("native_finish")
        if lines is None:
            lines = map_unit_text_native(rt.mi, rt.opt, frags[i].segs[0],
                                         rg_id)
            if lines is None:
                lines = map_fragment_output(rt.mi, rt.opt, frags[i].segs,
                                            rg_id)
            rt.timers.count("steal_dev_fallback")
        out[i] = lines
    t3 = tt()
    # the decomposition of the lane's host-side CPU
    rt.timers.count("steal_cpu_prep_ms", int((t1 - t0) * 1000))
    rt.timers.count("steal_cpu_flowhost_ms", int((t2 - t1) * 1000))
    rt.timers.count("steal_cpu_finish_ms", int((t3 - t2) * 1000))
    return out


def _dev_loop(rt, st: StealState, frags, rg_id, q_any, lock, results,
              stop: threading.Event, errors: list):
    """The device lane's thread: its priority follows measured
    profitability (an unproven or losing lane yields the core to the host
    lane at BASE_NICE; a paying one competes at 0). The flow is built here,
    before the first pull: its CSR upload must not hold up the host lane.
    Any exception is kept for run_steal_batch to re-raise."""
    my_tid = threading.get_native_id()
    cur = [None]

    def lane_nice(n):
        if cur[0] == n:
            return
        cur[0] = n
        try:
            os.setpriority(os.PRIO_PROCESS, my_tid, n)
        except OSError:
            pass   # lowering niceness needs a privilege: stay where it is

    try:
        lane_nice(BASE_NICE)
        if rt._get_flow() is not None:
            _dev_loop_body(rt, st, frags, rg_id, q_any, lock, results, stop,
                           lane_nice)
    except BaseException as e:   # re-raised by run_steal_batch
        errors.append(e)


def _dev_loop_body(rt, st, frags, rg_id, q_any, lock, results, stop,
                   lane_nice):
    def apply_nice():
        measured = (st.dev_cpu_per_read is not None
                    and st.host_per_read is not None)
        lane_nice(0 if measured and not _unprofitable(st) else BASE_NICE)

    apply_nice()
    while not stop.is_set():
        probing = False
        if _unprofitable(st):
            if st.paused_at is None:
                st.paused_at = time.monotonic()
                rt.timers.count("steal_paused")
            if time.monotonic() - st.paused_at < PROBE_S:
                if stop.wait(0.25):
                    return
                continue
            # probe due: attempt ONE pull; the timer re-arms only after a
            # pull actually happens
            probing = True
            rt.timers.count("steal_probe")
        # join-tail rule: on the stream's final batch (or a standalone
        # map_batch) pull only if the host lane has more work left than
        # this chunk is expected to take; mid-stream the join overlaps the
        # next batch's host mapping and the reserve only keeps this
        # batch's host lane from a bare queue
        host_rate = (1.0 / st.host_per_read) if st.host_per_read else 600.0
        ch = st.dev_ch
        if rt._draining:
            reserve = max(2 * ch, int(st.chunk_wall_ema * host_rate))
        else:
            reserve = 2 * ch
        with lock:
            if len(q_any) < ch + reserve:
                return
            idxs = [q_any.pop() for _ in range(ch)]
        cold = not st.returned   # pulled before any chunk had returned
        if probing:
            st.paused_at = time.monotonic()   # re-arm on an actual pull
        t0w = time.monotonic()
        t0c = time.thread_time()
        out = _dev_map_chunk(rt, frags, idxs, rg_id)
        cpu = time.thread_time() - t0c
        wall = time.monotonic() - t0w
        st.returned = True
        with lock:
            results.update(out)
        rt.timers.count("steal_device_reads", len(out))
        rt.timers.count("steal_chunks")
        rt.timers.count("steal_cpu_ms", int(cpu * 1000))
        # a lane that is not unprofitable jumps to the DEV_CH_MAX rung
        if not _unprofitable(st) and st.dev_ch < DEV_CH_MAX:
            st.dev_ch = DEV_CH_MAX
        if cold:
            rt.timers.count("steal_cold_chunks")
            continue             # a cold chunk is not lane cost
        st.dev_cpu_per_read = _ema(st.dev_cpu_per_read, cpu / len(idxs))
        st.chunk_wall_ema = 0.7 * st.chunk_wall_ema + 0.3 * wall
        if st.paused_at is not None and not _unprofitable(st):
            st.paused_at = None
            rt.timers.count("steal_resumed")
        apply_nice()


def run_steal_batch(rt, frags, rg_id: str = "") -> list[list[str]]:
    """Map one batch through the two stealing lanes; output order ==
    input order, byte-identical to the host path. An exception of the
    device lane is re-raised here, after the join."""
    from .device_flow import flow_mode_ok
    from .runtime import DEV_QLEN_MAX
    st = rt._steal_state
    if st is None:
        # map_stream's two batch threads may both arrive here first
        with rt._flow_lock:
            if rt._steal_state is None:
                rt._steal_state = StealState()
        st = rt._steal_state
    q_any: deque = deque()       # either lane may take these
    q_host: deque = deque()      # host-only: PE, oversized, multi-seg
    for i, fr in enumerate(frags):
        if len(fr.segs) == 1 and len(fr.segs[0].seq) <= DEV_QLEN_MAX:
            q_any.append(i)
        else:
            q_host.append(i)
    lock = threading.Lock()
    results: dict[int, list] = {}
    stop = threading.Event()
    errors: list = []
    worker = None
    if flow_mode_ok(rt.opt):
        worker = threading.Thread(
            target=_dev_loop,
            args=(rt, st, frags, rg_id, q_any, lock, results, stop, errors),
            daemon=True, name="mm2tpu-steal")
        worker.start()
    try:
        while not errors:
            with lock:
                src = q_host if q_host else q_any
                idxs = [src.popleft()
                        for _ in range(min(HOST_CH, len(src)))]
            if not idxs:
                break
            t0 = time.monotonic()
            out = _host_map_chunk(rt, frags, idxs, rg_id)
            now = time.monotonic()
            _host_best_update(st, (now - t0) / len(idxs), now)
            with lock:
                results.update(out)
    finally:
        stop.set()
        if worker is not None:
            worker.join()        # bounded: at most one chunk in flight
    if errors:
        raise errors[0]
    return [results[i] for i in range(len(frags))]
