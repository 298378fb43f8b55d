"""What a traced run (--trace 1) records beside its window, all from the
benchmark's side of the program's entry points:

- `torch.profiler` (CUPTI) over the window: every kernel, copy and set on the
  card, the seconds in which any ran (`busy_s`), time by device operation,
  and the idle gaps between them named by the benchmark's own spans around
  the port's layer entry points (host clock intervals, taken on whichever
  thread runs the layer: the profiler records `record_function` only on the
  thread that started it; they are put on the trace's clock by the window's
  own `record_function` on the main thread);
- each chain launch's inputs and each ksw2 batch's jobs and results, taken
  around the port's wrappers where its paths call them, for the least time
  of their work (roofline.py).

The program itself is not changed: the wrappers are put in place for the
window and taken away after it.
"""
from __future__ import annotations

import contextlib
import heapq
import threading
import time
from collections import defaultdict

from . import roofline

# the benchmark's spans: (module path, attribute, span name)
SPANS = (
    ("minimap2_chaindp_tpu_torch.models.runtime", "TorchRuntime.map_batch",
     "map_batch"),
    ("minimap2_chaindp_tpu_torch.models.runtime", "seed_unit", "seed"),
    ("minimap2_chaindp_tpu_torch.models.runtime", "TorchRuntime._seed_hits",
     "seed"),
    ("minimap2_chaindp_tpu_torch.models.device_flow", "DeviceFlow.run",
     "flow"),
    ("minimap2_chaindp_tpu_torch.models.runtime",
     "TorchRuntime._chain_batch", "staged_chain"),
    ("minimap2_chaindp_tpu_torch.native", "map_unit_text_chains_native",
     "native_finish"),
    ("minimap2_chaindp_tpu_torch.models.runtime", "run_scheduler",
     "staged_align"),
    ("minimap2_chaindp_tpu_torch.models.runtime", "format_frag", "format"),
)
CHAIN_SITES = ("minimap2_chaindp_tpu_torch.models.device_flow",
               "minimap2_chaindp_tpu_torch.models.runtime",
               "minimap2_chaindp_tpu_torch.models.device_pipeline")
KSW_MODULE = "minimap2_chaindp_tpu_torch.ops.ksw2_ext"
# the kernels of each roofline, by the names the device trace gives them
CHAIN_KERNELS = ("chain_staged_kernel", "chain_warp_kernel")
KSW_KERNELS = ("ksw_forward_smem_kernel", "ksw_forward_kernel",
               "ksw_walk_kernel")
SPAN_PREFIX = "bench::"


def _resolve(modname, attr):
    import importlib
    obj = importlib.import_module(modname)
    *path, last = attr.split(".")
    for p in path:
        obj = getattr(obj, p)
    return obj, last


class Recorder:
    """The launches of the window: chain inputs and ksw2 jobs."""

    def __init__(self):
        self.chain: list = []      # (stw, nn, input bytes, mode)
        self.ksw: list = []        # (jobs, results, splice)
        self.spans: list = []      # (start ns, end ns, name), perf_counter
        self._lock = threading.Lock()

    def span(self, name: str):
        rec = self

        class _Span:
            def __enter__(self):
                self.t = time.perf_counter_ns()

            def __exit__(self, *exc):
                with rec._lock:
                    rec.spans.append((self.t, time.perf_counter_ns(), name))
        return _Span()

    def least_seconds(self) -> dict:
        """{"chain": s, "ksw": s}: the summed least time of every launch."""
        out = {"chain": 0.0, "ksw": 0.0}
        for stw, nn, nbytes, mode in self.chain:
            ops, by = roofline.chain_work(stw, nn, nbytes, mode)
            out["chain"] += roofline.least_s(by, ops)
        for jobs, res, splice in self.ksw:
            f_ops, f_by, w_ops, w_by = roofline.ksw_work(jobs, res, splice)
            out["ksw"] += roofline.least_s(f_by, f_ops) \
                + roofline.least_s(w_by, w_ops)
        return out


@contextlib.contextmanager
def instrument():
    """Spans and launch records around the port's entry points, for the
    duration of the block; yields the Recorder."""
    import importlib
    rec = Recorder()
    undo = []

    def patch(owner, name, new):
        undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    def spanned(fn, span):
        def wrapper(*a, **kw):
            with rec.span(span):
                return fn(*a, **kw)
        return wrapper

    for modname, attr, span in SPANS:
        owner, name = _resolve(modname, attr)
        patch(owner, name, spanned(getattr(owner, name), span))

    def chain_at(real):
        def chain(*a, **kw):
            nbytes = sum(t.numel() * t.element_size() for t in a[:9])
            with rec._lock:
                rec.chain.append((a[5], a[6], nbytes, roofline.chain_mode(
                    kw["is_cdna"], kw["many_segs"])))
            return real(*a, **kw)
        return chain

    for modname in CHAIN_SITES:
        m = importlib.import_module(modname)
        patch(m, "chain_scores_batch", chain_at(m.chain_scores_batch))

    ke = importlib.import_module(KSW_MODULE)

    def ksw_at(real, splice):
        def batch(jobs, *a, **kw):
            with rec.span("ext_wave"):
                res = real(jobs, *a, **kw)
            with rec._lock:
                rec.ksw.append((list(jobs), list(res), splice))
            return res
        return batch

    patch(ke, "extd2_batch", ksw_at(ke.extd2_batch, False))
    patch(ke, "exts2_batch", ksw_at(ke.exts2_batch, True))
    try:
        yield rec
    finally:
        for owner, name, old in reversed(undo):
            setattr(owner, name, old)


def _t(ev, what) -> int:
    """Start or duration of a kineto event in integer nanoseconds."""
    for unit, scale in (("ns", 1), ("us", 1000)):
        fn = getattr(ev, f"{what}_{unit}", None)
        if fn is not None:
            return int(fn()) * scale
    raise AttributeError(f"kineto event has no {what}")


def reduce_profile(prof, kernels_of: dict, spans=(), win_ns=0) -> dict:
    """From a finished torch.profiler run: {"busy_s", "window_s",
    "device_ops": [[name, s]] (top 10), "idle_gaps": [[span, s]] (top 10),
    "kernel_s": {group: s}} where kernels_of maps a group name to the
    kernel name parts it sums. The window is the benchmark's
    "bench::window" record_function; `spans` are the Recorder's, on the
    perf_counter clock, on which the window started at `win_ns`."""
    from torch.autograd import DeviceType
    evs = prof.profiler.kineto_results.events()
    dev = []
    win = None
    for e in evs:
        name = e.name()
        st, du = _t(e, "start"), _t(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            dev.append((st, st + du, name))
        elif name == SPAN_PREFIX + "window":
            win = (st, st + du)
    if win is None:
        raise RuntimeError("the traced window's span is missing")
    # every time in seconds from the window's start, from integer ns
    w0 = win[0]
    win = (0.0, (win[1] - w0) * 1e-9)
    spans = [((a - win_ns) * 1e-9, (b - win_ns) * 1e-9, n)
             for a, b, n in spans]
    dev = [(max((a - w0) * 1e-9, 0.0), min((b - w0) * 1e-9, win[1]), n)
           for a, b, n in dev if b > w0 and (a - w0) * 1e-9 < win[1]]
    by_op = defaultdict(float)
    kernel_s = dict.fromkeys(kernels_of, 0.0)
    for a, b, n in dev:
        by_op[n[:120]] += b - a
        for group, parts in kernels_of.items():
            if any(p in n for p in parts):
                kernel_s[group] += b - a
    # busy: the union of the device intervals; idle gaps between them
    busy = 0.0
    gaps = []
    cur_a = cur_b = None
    last = win[0]
    for a, b, _n in sorted(dev):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                busy += cur_b - cur_a
                last = cur_b
            gaps.append((last, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
        last = cur_b
    gaps.append((last, win[1]))
    # name each gap by the innermost benchmark span (the latest to start)
    # live at its middle: a sweep over the spans in order of their start
    spans.sort()
    idle = defaultdict(float)
    live: list = []
    i = 0
    for a, b in sorted(g for g in gaps if g[1] > g[0]):
        mid = (a + b) / 2
        while i < len(spans) and spans[i][0] <= mid:
            heapq.heappush(live, (-spans[i][0], spans[i][1], spans[i][2]))
            i += 1
        while live and live[0][1] <= mid:
            heapq.heappop(live)
        idle[live[0][2] if live else "none"] += b - a
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:10]]
    return dict(busy_s=busy, window_s=win[1] - win[0],
                device_ops=top(by_op), idle_gaps=top(idle),
                kernel_s=kernel_s, n_device=len(dev), n_spans=len(spans),
                n_gaps=len(gaps),
                spans_at=[spans[0][0], spans[-1][1]] if spans else None)
