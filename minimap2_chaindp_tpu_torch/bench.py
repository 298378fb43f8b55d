"""Headline benchmark of the port: the chaining-DP kernel's throughput on
the card at the bench shape, beside the port's native host chain on one
core; then the end-to-end rows (the card's lane against the host's, in
turns) and the flow row.

    python -m minimap2_chaindp_tpu_torch.bench [--device cuda|cpu]
        [--reads N] [--no-e2e] [--no-projection] [--e2e-scale F]
        [--steady N] [--keep-inputs DIR]

Port of the device half of bench.py at the repo root:
  * the headline (`main_device`, :550-634): csrc/chain_dp.cu through
    ops/chain_dp.chain_scores_batch on `synth_batch(N, 1024, seed)` for
    seeds 0-3, packed by ops/chain_pack.pack_reads (entry.pack_example)
    and placed on the card first; max_dist 5000, bw 500, max_skip 25,
    single-segment, one use_exc for every batch (score_bound 10300 is
    passed and, as the port's wrapper says, ignored). Two warm-up calls on
    batch 0, then batches 1-3 dispatched back to back and closed by one
    torch.cuda.synchronize(), best of two such pipelines on the host clock
    (`value`, `pipeline_ms`; CUDA events around the same pipeline give
    `pipeline_device_ms`). Batch 1's f/p/flag from the timed pipeline are
    held against chain_scores_batch_ref outside the timed window;
    `fallback_flagged_reads` sums the flag column of batches 1-3;
  * the baseline: the reference's single-core chain.c (:32-78) needs the
    reference tree, so `baseline_single_core_c` is null; in its place
    `baseline_host_native_1core` times native.chain_dp_native on the
    calling thread over batch 0's first 64 reads (min_cnt 3, min_sc 40,
    best of three passes), measured in the same run as the card and never
    printed in place of its number. `vs_baseline` is against it;
  * the end-to-end rows (`_e2e_fields`, `_e2e_1kb_fields`,
    `_e2e_sr150_fields`, `_e2e_engaged_fields`): tools/e2e_bench.py
    `--device pair` as a subprocess with a timeout each, on its cached
    utils/genome_synth genome (its GENOME, named in the record): 10 kb
    map-ont, 1 kb map-ont, `-x sr` 2 x 150 bp pairs (counted in pairs),
    and the engaged 10 kb row under the stealing routing
    (MM2TPU_STEAL=1, the lane the JAX runtime engages), each printing
    `{row}_reads_per_s_{host,cuda}` and `{row}_cuda_vs_host_paired_ratio`;
    every pair of runs writes the same SAM on both lanes. The 3 Gbp map-pb
    row (`_e2e_genome_engaged_fields`) is tools/genome_scale.py's with
    `--mb`, not run here;
  * the flow row (`_flow_projection_fields`): tools/flow_projection.py at
    10 kb, 48 reads, 3 iterations.
`launches` counts the kernel launches of every part: the headline in this
process from 0, each row's and the flow's in their own processes.
`--keep-inputs DIR` has each row and the flow row write the largest input
of each kernel wrapper under DIR/<row> (utils/kernel_inputs.py), where a
check against the plain versions can read it (chip_smoke.py phase 9).

The record is one JSON line, the last on stdout, under 2000 characters,
with the card's name, count and power limit (nvidia-smi). A row that fails
or times out is null with a `{row}_error` string, and the run then exits
non-zero. `--device cuda` (the default) without a card exits non-zero and
prints no record. `--device cpu` runs the same code with the plain
versions, writes `"device": {"platform": "cpu"}` and null in every time
and rate field (a CPU run measures no device time).

Not ported: the retrying child process (:432-446) and the host record
printed under the headline's name when the device does not answer
(`host_native_fallback`, :81-110), the TPU link's state (`link_state`),
the XLA compile cache (`compile_cache`), and `_drift_fields` (:504-548),
which compared against the TPU-era BENCH_r*.json: no TPU number is read
or printed.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_READS = 8192
ANCHORS_PER_READ = 1024
MAX_DIST = 5000
BW = 500
MAX_SKIP = 25
MIN_SC = 40
SCORE_BOUND = 10300
N_TIMED = 3            # batches per timed pipeline
BASELINE_READS = 64
CHAIN_KW = dict(max_n=ANCHORS_PER_READ, max_dist_x=MAX_DIST,
                max_dist_y=MAX_DIST, bw=BW, max_skip=MAX_SKIP, is_cdna=False,
                many_segs=False)
# row -> (reads, read length, more e2e_bench arguments, timed pairs,
# environment, timeout s); the reads scale with --e2e-scale
E2E_ROWS = {
    "e2e": (400, 10000, (), 6, {}, 900),
    "e2e_1kb": (2000, 1000, (), 4, {}, 900),
    "e2e_sr150": (4000, 150, ("--pairs", "--preset", "sr", "--err",
                              "0.005"), 4, {}, 900),
    "e2e_engaged": (12000, 10000, (), 3, {"MM2TPU_STEAL": "1"}, 1800),
}
FLOW_ARGS = ("--lengths", "10000", "--reads", "48", "--iters", "3")
FLOW_TIMEOUT_S = 900


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def headline_batch(n_reads: int, seed: int, device):
    """synth_batch(n_reads, 1024, seed) packed and placed on `device`:
    (the nine kernel inputs, use_exc of the batch)."""
    import torch
    from .entry import pack_example
    from .ops.chain_pack import infer_use_exc
    packed, nn, w1, exc, _max_n = pack_example(n_reads, ANCHORS_PER_READ,
                                               seed)
    args = [torch.from_numpy(a).to(device) for a in (
        *(packed[k] for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")),
        nn, w1, exc)]
    return args, infer_use_exc(exc)


def dispatch(args, use_exc):
    from .ops.chain_dp import chain_scores_batch
    return chain_scores_batch(*args, **CHAIN_KW, use_exc=use_exc,
                              score_bound=SCORE_BOUND)


def headline(n_reads: int, device) -> dict:
    """The chain kernel's throughput at the bench shape (module docstring).
    Off the card one timed batch and one pipeline, and no time."""
    import torch
    from .ops import chain_dp as TD
    on_card = device.type == "cuda"
    n_timed = N_TIMED if on_card else 1
    batches = [headline_batch(n_reads, s, device)
               for s in range(n_timed + 1)]
    # one kernel variant across warm-up and timed batches
    use_exc = any(b[1] for b in batches)
    TD.chain_scores_batch.launches = 0
    TD.chain_scores_batch.by_form = dict.fromkeys(TD.FORMS, 0)
    for _ in range(2):
        dispatch(batches[0][0], use_exc)
    best = best_dev = None
    for _rep in range(2 if on_card else 1):
        if on_card:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
        outs = [dispatch(args, use_exc) for args, _ in batches[1:]]
        if on_card:
            end.record()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if best is None or dt < best:
                best, best_dev = dt, start.elapsed_time(end)
    launches = dict(chain=TD.chain_scores_batch.launches, ksw=0, walk=0,
                    **TD.chain_scores_batch.by_form)
    flagged = sum(int(flag[:, 0].sum()) for _f, _p, flag in outs)
    want = TD.chain_scores_batch_ref(*batches[1][0], **CHAIN_KW,
                                     use_exc=use_exc)
    for name, got, ref in zip(("f", "p", "flag"), outs[0], want):
        if not torch.equal(got, ref):
            raise RuntimeError(f"batch 1: the kernel's {name} differs from "
                               "chain_scores_batch_ref")
    anchors = n_reads * ANCHORS_PER_READ * n_timed
    return dict(
        value=None if best is None else round(anchors / best, 1),
        pipeline_ms=None if best is None else round(best * 1e3, 3),
        pipeline_device_ms=None if best_dev is None else round(best_dev, 3),
        fallback_flagged_reads=flagged, check_batch1="bit-exact",
        launches=launches)


def baseline_host_native_1core():
    """native.chain_dp_native over batch 0's first 64 reads on the calling
    thread, best of three passes: (anchors/s, {min, median, max, n})."""
    from .native import chain_dp_native
    from .utils.synth import synth_batch
    # synth_batch draws reads in order, so these are batch 0's first 64
    anchors = synth_batch(BASELINE_READS, ANCHORS_PER_READ, seed=0)
    args = (MAX_DIST, MAX_DIST, BW, MAX_SKIP, 3, MIN_SC, False, 1)
    if chain_dp_native(*args, anchors[0]) is None:
        raise RuntimeError("the native host library did not load")
    rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        for a in anchors:
            chain_dp_native(*args, a)
        rates.append(BASELINE_READS * ANCHORS_PER_READ
                     / (time.perf_counter() - t0))
    rates.sort()
    return rates[-1], {"min": round(rates[0], 1),
                       "median": round(rates[1], 1),
                       "max": round(rates[-1], 1), "n": len(rates)}


def run_tool(name, args, timeout, env=None):
    """Run `python -m minimap2_chaindp_tpu_torch.<name> args`; (stdout,
    stderr). A non-zero exit raises with the tail of stderr."""
    out = subprocess.run(
        [sys.executable, "-m", f"minimap2_chaindp_tpu_torch.{name}",
         *map(str, args)], capture_output=True, text=True, timeout=timeout,
        cwd=ROOT, env={**os.environ, **(env or {})})
    if out.returncode != 0:
        tail = out.stderr.strip().splitlines()[-20:]
        log(f"{name} {' '.join(map(str, args))} exited "
            f"{out.returncode}:\n" + "\n".join(tail))
        raise RuntimeError(f"exited {out.returncode}: "
                           f"{tail[-1] if tail else ''}")
    return out.stdout, out.stderr


def _after(text, key):
    """The first number after `key` on the line that holds it."""
    line = next(ln for ln in text.splitlines() if key in ln)
    return float(line.split(key)[1].split()[0])


def keep_args(keep, name) -> list:
    return ["--keep-inputs", os.path.join(keep, name)] if keep else []


def e2e_row(name, lane, scale, steady, on_card, launches, keep) -> dict:
    """One row through tools/e2e_bench.py --device pair (module docstring);
    adds the row's launches to `launches`."""
    reads, length, more, n_steady, env, timeout = E2E_ROWS[name]
    reads = max(1, round(reads * scale))
    out, err = run_tool("tools.e2e_bench", [
        "--reads", reads, "--len", length, *more, "--device", "pair",
        "--pair-lane", lane, "--steady", steady or n_steady,
        *keep_args(keep, name)], timeout, env)
    line = next(ln for ln in out.splitlines() if ln.startswith("launches:"))
    for tok in line.split()[1:]:
        k, v = tok.split("=")
        launches[k] += int(v)
    rate = lambda dev: _after(out, f"steady[{dev}]:") if on_card else None
    fields = {f"{name}_reads": reads,
              f"{name}_reads_per_s_host": rate("host"),
              f"{name}_reads_per_s_{lane}": rate(lane),
              f"{name}_{lane}_vs_host_paired_ratio":
                  _after(out, "paired_ratio_median:") if on_card else None,
              f"{name}_sam_identical":
                  out.split("sam_identical: ")[1].split()[0]}
    if name == "e2e_engaged":
        # the run whose stealing lane took the most reads describes it
        steal = max((dict(t.split("=") for t in ln.split()[1:])
                     for ln in err.splitlines()
                     if ln.startswith("steal") and f"[{lane}]:" in ln),
                    key=lambda d: int(d["steal_reads"]))
        n = int(steal["steal_reads"])
        fields[f"{name}_steal_reads_best_run"] = n
        fields[f"{name}_steal_cpu_ms_per_read"] = round(
            int(steal["steal_cpu_ms"]) / n, 2) if n and on_card else None
    return fields


def flow_row(lane, on_card, launches, keep) -> dict:
    """The flow row through tools/flow_projection.py (module docstring)."""
    out, _err = run_tool("tools.flow_projection",
                        [*FLOW_ARGS, "--json", "--device", lane,
                         *keep_args(keep, "flow")],
                        FLOW_TIMEOUT_S, {"MM2TPU_PROF": "1"})
    rec = json.loads(out.strip().splitlines()[-1])
    for k, v in rec["launches"].items():
        launches[k] += v
    r = rec["per_length"]["10000"]
    return {"flow_anchors_per_read": r["anchors_per_read"],
            "flow_device_ms_per_read": r["flow_device_ms_per_read"],
            "flow_host_residual_ms_per_read": r["host_residual_ms_per_read"],
            "flow_projected_reads_per_s": r["projected_reads_per_s"],
            "flow_measured_reads_per_s": r["measured_reads_per_s"]}


def null_keys(name, lane):
    """The fields a failed part writes as null."""
    if name == "flow":
        return ("flow_device_ms_per_read", "flow_projected_reads_per_s",
                "flow_measured_reads_per_s")
    return (f"{name}_reads_per_s_host", f"{name}_reads_per_s_{lane}",
            f"{name}_{lane}_vs_host_paired_ratio")


def card_desc() -> dict:
    """The card's name, count and power limit (nvidia-smi)."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    first = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        and smi.stdout.strip() else ""
    log(f"card: {first or 'nvidia-smi gave nothing'}")
    name, _, power = first.rpartition(", ")
    return {"platform": "gpu",
            "kind": name or torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "power_limit": power or None}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m minimap2_chaindp_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reads", type=int, default=N_READS,
                    help="reads per headline batch")
    ap.add_argument("--no-e2e", action="store_true")
    ap.add_argument("--no-projection", action="store_true")
    ap.add_argument("--e2e-scale", type=float, default=1.0,
                    help="scale every end-to-end row's read count")
    ap.add_argument("--steady", type=int, default=0,
                    help="timed pairs of every end-to-end row (default: "
                         "the row's own)")
    ap.add_argument("--keep-inputs", default=None, metavar="DIR",
                    help="each row's largest kernel inputs under DIR/<row>")
    ns = ap.parse_args(argv)
    import torch
    on_card = ns.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("[bench] --device cuda: no CUDA device is available; no "
              "record is printed (use --device cpu for the plain versions)",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0" if on_card else "cpu")
    lane = "cuda" if on_card else "cpu"
    dev_desc = card_desc() if on_card else {"platform": "cpu"}
    t0 = time.perf_counter()
    head = headline(ns.reads, device)
    log(f"headline: {head} ({time.perf_counter() - t0:.1f} s)")
    base = spread = None
    if on_card:
        base, spread = baseline_host_native_1core()
    rec = {"metric": "chaindp_anchors_per_s", "value": head["value"],
           "unit": "anchors/s",
           "vs_baseline": round(head["value"] / base, 3) if base else None,
           "baseline_host_native_1core": base and round(base, 1),
           "baseline_spread": spread,
           "baseline_single_core_c": None,
           "baseline_single_core_c_note": "needs the reference fork's "
           "chain.c, which no machine of the port has",
           "device": dev_desc, "reads": ns.reads,
           "anchors_per_read": ANCHORS_PER_READ,
           **{k: head[k] for k in ("fallback_flagged_reads", "pipeline_ms",
                                   "pipeline_device_ms", "check_batch1")}}
    launches = head["launches"]
    parts = []
    if not ns.no_e2e:
        from .tools.e2e_bench import GENOME
        rec["genome"] = ("utils/genome_synth {n_contigs} x {contig_len} bp, "
                         "seed {seed}").format(**GENOME)
        parts = [(name, functools.partial(e2e_row, name, lane, ns.e2e_scale,
                                          ns.steady, on_card, launches,
                                          ns.keep_inputs))
                 for name in E2E_ROWS]
    if not ns.no_projection:
        parts.append(("flow", functools.partial(flow_row, lane, on_card,
                                                launches, ns.keep_inputs)))
    failed = False
    for name, run in parts:
        t0 = time.perf_counter()
        try:
            rec.update(run())
        except (RuntimeError, subprocess.TimeoutExpired, StopIteration,
                ValueError, KeyError, IndexError) as e:
            failed = True
            rec.update(dict.fromkeys(null_keys(name, lane)))
            rec[f"{name}_error"] = f"{type(e).__name__}: {e}"[:60]
        log(f"{name}: {time.perf_counter() - t0:.1f} s")
    rec["launches"] = launches
    line = json.dumps(rec)
    if len(line) >= 2000:
        raise ValueError(f"the record has {len(line)} characters")
    print(line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
