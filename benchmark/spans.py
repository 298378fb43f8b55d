"""The program's own spans and launch work counters in a run of one cell:

    python3 -m benchmark.spans --workload NAME --seed N --seconds S \
        [--profile 0|1]

from the root of a checkout. It runs the cell as benchmark/run.py does
(`run.run_cell`, the same set-up, window and check), with the port's
interval tracer (minimap2_chaindp_tpu_torch/utils/trace.py) on for the
window: `--profile 0` an untraced run, whose `bases_per_s` is the rate with
the program's tracing on; `--profile 1` (the default) a `--trace 1` run,
with torch.profiler and benchmark/trace.py's wrappers beside it. `--ab N`
first runs N pairs of windows of --seconds each, the tracer off in one and
on in the other, in the same process (the cost of tracing, free of the
spread between runs; `[bench] tracer off/on`). It adds to run.py's result
line a "program" object and logs on stderr:

- `[bench] idle by program span`: each idle interval of the device in the
  window (no kernel, copy or set on the card), put on the host's clock, is
  charged to the innermost program span live on each batch thread (split
  equally among the batch threads that have one), else to the main
  thread's (`feed_wait`), else to `none`; seconds per "role/span";
- `[bench] launch work`: the program's launch work counters over the
  window beside the same units worked out by benchmark/roofline.py from the
  wrappers' records of every launch, and whether each pair is equal;
- `[bench] program spans`: spans recorded per batch, wall and thread CPU
  seconds per "role/span", the per-layer metrics the spans give, and the
  cost of one span with the tracer off and on (a host loop of 10^5).

The program's spans are on the perf_counter clock; the profiler's events
on its own. Two anchors map one onto the other, linearly (utils/trace
`clock_map`): a `bench::anchor0` record just before the window's drive and
a `bench::anchor1` just after it, each start paired with the midpoint of
perf_counter read before and after the record's enter (a warm-up record
first, since the first enter and exit in a process resolve the profiler's
ops and take a fraction of a millisecond). Nothing here is read by a run of
benchmark/run.py; the reader of host_offcpu_pct (benchmark/metrics) gets
the spans from here.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import roofline as RF  # noqa: E402
from benchmark import run as R  # noqa: E402
from benchmark import trace as TR  # noqa: E402

# the launch work counters of the program that the roofline units check
CHAIN_KEYS = tuple(f"chain_pairs_{m}" for m in RF.CHAIN_OPS_PER_PAIR) + (
    "chain_in_bytes", "chain_out_bytes")
KSW_KEYS = tuple(f"ksw_{what}_{kind}{cls}" for kind in ("extd2", "exts2")
                 for what, cls in (("cells", ""), ("cells", "_approx"),
                                   ("cells", "_score"), ("jobs", ""))) + (
    "walk_steps", "ksw_in_bytes")
COPY_KEYS = ("chain_h2d_bytes", "chain_d2h_bytes", "ksw_h2d_bytes",
             "ksw_d2h_bytes")
BATCH_ROLE = "batch"


def device_window(prof) -> tuple[dict, list]:
    """From a finished torch.profiler run: the benchmark's records by name
    ({"window": (start, end), "anchor0": ..., "anchor1": ...}) and every
    device operation's (start, end), in the profiler's integer ns."""
    from torch.autograd import DeviceType
    recs, dev = {}, []
    for e in prof.profiler.kineto_results.events():
        st = TR._t(e, "start")
        en = st + TR._t(e, "duration")
        if e.device_type() == DeviceType.CUDA:
            dev.append((st, en))
        elif e.name().startswith(TR.SPAN_PREFIX):
            recs[e.name()[len(TR.SPAN_PREFIX):]] = (st, en)
    if "window" not in recs:
        raise RuntimeError("the traced window's span is missing")
    return recs, sorted(dev)


def anchor(name: str) -> int:
    """A `bench::<name>` record: the perf_counter ns at its start, the
    midpoint of reads before and after its enter."""
    import torch
    rf = torch.profiler.record_function(TR.SPAN_PREFIX + name)
    a = time.perf_counter_ns()
    rf.__enter__()
    b = time.perf_counter_ns()
    rf.__exit__(None, None, None)
    return (a + b) // 2


def idle_intervals(win: tuple, dev: list) -> list[tuple]:
    """The intervals of `win` that no device operation covers."""
    gaps, last = [], win[0]
    for a, b in sorted(dev):
        if a > last:
            gaps.append((last, min(a, win[1])))
        last = max(last, b)
        if last >= win[1]:
            break
    if last < win[1]:
        gaps.append((last, win[1]))
    return [(a, b) for a, b in gaps if b > a]


def on_clock(spans, to_clock) -> list[tuple]:
    """(start, end, span) with start and end on another clock."""
    return [(to_clock(s.start_ns), to_clock(s.end_ns), s) for s in spans]


def idle_by_span(spans: list[tuple], gaps: list[tuple]) -> dict:
    """Seconds of the intervals `gaps` charged per "role/span": over every
    instant of a gap, the innermost span live on each batch thread gets an
    equal share; with none live there, the main thread's innermost span;
    else "none". `spans` are on the gaps' clock, as on_clock gives them;
    the gaps' unit is ns."""
    depth: dict = {}
    by_id = {s.id: s for _a, _b, s in spans}

    def depth_of(s):
        if s.id not in depth:
            p = by_id.get(s.parent)
            depth[s.id] = 0 if p is None else depth_of(p) + 1
        return depth[s.id]
    events = []
    for a, b, s in spans:
        if s.role in (BATCH_ROLE, "main") and b > a:
            events.append((a, 1, s))
            events.append((b, 0, s))
    events.sort(key=lambda e: (e[0], e[1]))
    points = sorted({e[0] for e in events}
                    | {t for g in gaps for t in g})
    live: dict = defaultdict(dict)     # thread -> {span id: span}
    out: dict = defaultdict(float)
    ei = gi = 0
    for t0, t1 in zip(points, points[1:]):
        while ei < len(events) and events[ei][0] <= t0:
            _t, start, s = events[ei]
            if start:
                live[s.thread][s.id] = s
            else:
                live[s.thread].pop(s.id, None)
            ei += 1
        while gi < len(gaps) and gaps[gi][1] <= t0:
            gi += 1
        if gi == len(gaps) or gaps[gi][0] > t0:
            continue
        dt = (t1 - t0) * 1e-9
        inner = [max(d.values(), key=depth_of) for d in live.values() if d]
        batch = [s for s in inner if s.role == BATCH_ROLE]
        if batch:
            for s in batch:
                out[f"{s.role}/{s.name}"] += dt / len(batch)
        elif inner:
            s = inner[0]
            out[f"{s.role}/{s.name}"] += dt
        else:
            out["none"] += dt
    return dict(out)


def span_table(spans) -> dict:
    """[wall s, thread CPU s] per "role/span"."""
    out: dict = defaultdict(lambda: [0.0, 0.0])
    for s in spans:
        row = out[f"{s.role}/{s.name}"]
        row[0] += (s.end_ns - s.start_ns) * 1e-9
        row[1] += s.cpu_ns * 1e-9
    return dict(out)


def spans_per_batch(spans) -> list[int]:
    n: dict = defaultdict(int)
    for s in spans:
        if s.batch:
            n[s.batch] += 1
    return sorted(n.values())


def roofline_units(rec) -> dict:
    """The launch work counters' units, worked out by roofline.py from the
    wrappers' records of every launch (a Recorder), and the four totals
    ksw_work gives (forward and walk operations and bytes)."""
    out: dict = defaultdict(int)
    for stw, nn, nbytes, mode in rec.chain:
        ops, by = RF.chain_work(stw, nn, nbytes, mode)
        out[f"chain_pairs_{mode}"] += ops // RF.CHAIN_OPS_PER_PAIR[mode]
        out["chain_in_bytes"] += nbytes
        out["chain_out_bytes"] += by - nbytes
    for jobs, res, splice in rec.ksw:
        kind = "exts2" if splice else "extd2"
        total = RF.ksw_work(jobs, res, splice)
        for key, v in zip(("ksw_fwd_ops", "ksw_fwd_bytes", "walk_ops",
                           "walk_bytes"), total):
            out[key] += v
        out[f"ksw_jobs_{kind}"] += len(jobs)
        for job, ez in zip(jobs, res):
            f_ops, f_by, w_ops, _ = RF.ksw_work([job], [ez], splice)
            score = job["flag"] & RF.KSW_EZ_SCORE_ONLY
            approx = job["flag"] & RF.KSW_EZ_APPROX_MAX
            per = RF.KSW_OPS_PER_CELL[splice] \
                - (RF.KSW_OPS_H_ROW if approx else 0) \
                - (RF.KSW_OPS_CIGAR[splice] if score else 0)
            cells = f_ops // per
            out[f"ksw_cells_{kind}"] += cells
            out[f"ksw_cells_{kind}_approx"] += cells if approx else 0
            out[f"ksw_cells_{kind}_score"] += cells if score else 0
            out["walk_steps"] += w_ops // RF.WALK_OPS_PER_STEP
            out["ksw_in_bytes"] += f_by - 2 * RF.JOB_BYTES \
                - (0 if score else cells)
    return dict(out)


def program_units(c: dict) -> dict:
    """The program's launch work counters, and the four ksw_work totals
    worked out from them with roofline.py's prices."""
    out = {k: c.get(k, 0) for k in CHAIN_KEYS + KSW_KEYS + COPY_KEYS}
    f_ops = f_by = jobs = 0
    for kind, splice in (("extd2", False), ("exts2", True)):
        cells = out[f"ksw_cells_{kind}"]
        f_ops += RF.KSW_OPS_PER_CELL[splice] * cells \
            - RF.KSW_OPS_H_ROW * out[f"ksw_cells_{kind}_approx"] \
            - RF.KSW_OPS_CIGAR[splice] * out[f"ksw_cells_{kind}_score"]
        f_by += cells - out[f"ksw_cells_{kind}_score"]
        jobs += out[f"ksw_jobs_{kind}"]
    steps = out["walk_steps"]
    out.update(ksw_fwd_ops=f_ops,
               ksw_fwd_bytes=f_by + out["ksw_in_bytes"]
               + 2 * RF.JOB_BYTES * jobs,
               walk_ops=steps * RF.WALK_OPS_PER_STEP,
               walk_bytes=2 * steps + 2 * RF.JOB_BYTES * jobs)
    return out


def span_cost(n: int = 100_000) -> dict:
    """ns per span of a host loop of n empty spans inside a `map_batch`
    span: the plain Timers, the tracer off, the tracer on, and on with a
    read of the thread CPU clock at every end (CPU_REUSE_NS 0: the cost of
    a span whose ends lie far apart)."""
    from minimap2_chaindp_tpu_torch.utils import trace as T
    from minimap2_chaindp_tpu_torch.utils.timers import Timers
    out = {}
    reuse = T.CPU_REUSE_NS
    for name, t, on in (("plain", Timers(), False),
                        ("off", T.Tracer(), False), ("on", T.Tracer(), True),
                        ("on_every_read", T.Tracer(), True)):
        if on:
            t.start_trace()
        if name == "on_every_read":
            T.CPU_REUSE_NS = 0
        try:
            with t.time("map_batch"):
                t0 = time.perf_counter_ns()
                for _ in range(n):
                    with t.time("x"):
                        pass
                out[f"{name}_ns"] = (time.perf_counter_ns() - t0) / n
        finally:
            T.CPU_REUSE_NS = reuse
            if on:
                t.stop_trace()
    return out


@contextlib.contextmanager
def _hooks(got: dict, ab: int = 0):
    """run_cell with the program's tracer on for its window: run.drive,
    trace.instrument and trace.reduce_profile wrapped to keep what the
    spans' analysis needs (the spans, the window's anchors, the Recorder,
    the device's intervals, the counters over the window). With `ab` > 0,
    `ab` pairs of windows of the same length come first, the tracer off in
    one and on in the other, the order turning each pair."""
    real_drive, real_instr = R.drive, TR.instrument
    real_reduce = TR.reduce_profile

    def drive(runtime, *a, **kw):
        tr = runtime.timers
        tracing = hasattr(tr, "start_trace")
        for i in range(ab if tracing else 0):
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                if on:
                    tr.start_trace()
                w = real_drive(runtime, *a, **kw)
                tr.stop_trace()
                got.setdefault("ab", []).append(
                    (on, w["tally"]["bases"] / (w["t_end"] - w["t0"])))
        got["before"] = R._timer_state(runtime)
        anchor("anchor_warm")
        got["p0"] = anchor("anchor0")
        if tracing:
            tr.start_trace()
        try:
            w = real_drive(runtime, *a, **kw)
        finally:
            got["spans"] = tr.stop_trace() if tracing else []
            got["p1"] = anchor("anchor1")
        got["after"] = R._timer_state(runtime)
        got["w"] = w
        return w

    @contextlib.contextmanager
    def instrument():
        with real_instr() as rec:
            got["rec"] = rec
            yield rec

    def reduce_profile(prof, kernels_of, spans=(), win_ns=0):
        got["recs"], got["dev"] = device_window(prof)
        return real_reduce(prof, kernels_of, spans, win_ns)

    R.drive, TR.instrument, TR.reduce_profile = drive, instrument, \
        reduce_profile
    try:
        yield got
    finally:
        R.drive, TR.instrument, TR.reduce_profile = real_drive, real_instr, \
            real_reduce


def run(cell, config, mix, seed, seconds, profile: bool,
        device: str = "cuda", ab: int = 0) -> dict:
    """One run of a cell with the program's tracer on for the window;
    run.run_cell's result with a "program" object added (see the module
    docstring), and with `ab` pairs of tracer-off and tracer-on windows
    before it (`_hooks`), their bases a second in "ab". `device` "cpu"
    serves the harness's tests."""
    import importlib
    from minimap2_chaindp_tpu_torch.utils.trace import clock_map
    got: dict = {}
    with _hooks(got, ab):
        result = R.run_cell(cell, config, mix, seed, seconds, profile,
                            device=device)
    spans = got["spans"]
    diff = R._timer_diff(got["before"], got["after"])
    bases = got["w"]["tally"]["bases"]
    record = dict(timers=diff["acc"], counters=diff["counters"],
                  bases=bases, frags=got["w"]["tally"]["frags"],
                  spans=spans)
    per_batch = spans_per_batch(spans)
    prog = dict(n_spans=len(spans),
                spans_per_batch=dict(
                    max=per_batch[-1] if per_batch else 0,
                    median=statistics.median(per_batch) if per_batch
                    else 0),
                span_s=span_table(spans), span_cost=span_cost(),
                metrics={})
    for name in ("skeleton_ms_per_mbase", "ext_host_ms_per_mbase",
                 "host_offcpu_pct"):
        v = importlib.import_module(f"benchmark.metrics.{name}").read(record)
        if v is not None:
            prog["metrics"][name] = v
    if profile:
        recs = got["recs"]
        to_trace = clock_map((got["p0"], recs["anchor0"][0]),
                             (got["p1"], recs["anchor1"][0]))
        gaps = idle_intervals(recs["window"], got["dev"])
        idle = idle_by_span(on_clock(spans, to_trace), gaps)
        prog.update(idle_s=sum(b - a for a, b in gaps) * 1e-9,
                    n_idle=len(gaps), idle_by_span=idle)
        mine = program_units(diff["counters"])
        theirs = roofline_units(got["rec"])
        keys = CHAIN_KEYS + KSW_KEYS + ("ksw_fwd_ops", "ksw_fwd_bytes",
                                        "walk_ops", "walk_bytes")
        prog["launch_work"] = dict(
            program=mine, roofline={k: theirs.get(k, 0) for k in keys},
            equal=all(mine[k] == theirs.get(k, 0) for k in keys))
        R.log("[bench] idle by program span (s): " + json.dumps(
            dict(sorted(idle.items(), key=lambda kv: -kv[1]))))
        R.log("[bench] launch work: " + json.dumps(prog["launch_work"]))
    R.log("[bench] program spans: " + json.dumps(
        {k: prog[k] for k in ("n_spans", "spans_per_batch", "metrics",
                              "span_cost", "span_s")}))
    if got.get("ab"):
        prog["ab"] = dict(off=[v for on, v in got["ab"] if not on],
                          on=[v for on, v in got["ab"] if on])
        R.log("[bench] tracer off/on, bases/s: " + json.dumps(prog["ab"]))
    got.clear()
    result["program"] = prog
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--profile", type=int, choices=(0, 1), default=1)
    ap.add_argument("--ab", type=int, default=0,
                    help="pairs of windows, tracer off and on, before the "
                    "window, in the same process")
    args = ap.parse_args(argv)
    cell, config, mix = R.load_cell(args.workload)
    R._clean_env()
    why = R.check_card(cell["chips"])
    if why is not None:
        R.log(f"[bench] {why}: this benchmark runs on the card only")
        return 1
    result = run(cell, config, mix, args.seed, args.seconds,
                 bool(args.profile), ab=args.ab)
    bad = R.forbidden_modules()
    if bad:
        R.log(f"[bench] {R.ForbiddenModules(bad)}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
