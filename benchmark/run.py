"""Run one cell of the benchmark of minimap2_chaindp_tpu_torch, once.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout (also as `python3 -m benchmark.run`). The cell,
its configuration and its traffic mix are found by name: BENCHMARK.json's
`workloads` entry, `benchmark/configs/<config>.json` and
`benchmark/traffic/<traffic>.json`, whose "kind" names the generator
`benchmark/traffic/<kind>.py`; a per-layer metric `<name>` is read by
`benchmark/metrics/<name>.py`.

A run is one process. Set-up: the card, the genome of the configuration and a
pool of read batches from --seed (written once under TMPDIR), the index built
as the CLI builds it (host native, -t of the configuration), the runtime
built as the CLI builds it for `--device cuda` with no routing environment,
and one pass over the whole pool mapped to warm it up (every batch the window
hands in, so every launch shape it makes). The window: batches of the
pool are handed to `TorchRuntime.map_stream` in turn, read from the files
through `utils/prefetch.prefetch(read_frags(...), depth=2)` as the CLI reads
them, until --seconds have passed; the SAM lines are joined as the CLI joins
them, counted and dropped. `bases_per_s` is the query bases handed in before
the deadline over the time until the last of them came back. After the
window: a sample of the fragments mapped in it, drawn from the seed as evenly
over the pool's batches as its size allows, and the longest of them, is
mapped again by the plain reference (benchmark/reference, another process)
and compared line for line; every pass of a batch in the window is compared
with its warm-up pass. The last line of standard output is the result, one
JSON object.

Exits non-zero, printing no result, without as many CUDA cards as the cell
asks for, and if the JAX package, jax, jaxlib or flax is loaded once the
window has closed.
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque


def _process_age() -> float:
    """Seconds since this process started (Linux /proc), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            start = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
BENCH = os.path.join(ROOT, "benchmark")
# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "minimap2_chaindp_tpu")
# the reference's sample is drawn from the fragments handed in the window
SAMPLE_STREAM, GENOME_STREAM, READS_STREAM = 2, 0, 1


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_cell(name: str) -> tuple[dict, dict, dict]:
    """(workload entry, configuration, traffic mix) of a cell, by name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    with open(os.path.join(ROOT, entry["file"])) as fh:
        config = json.load(fh)
    with open(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json")) as fh:
        mix = json.load(fh)
    metrics = [m for m in bench["per_layer"]
               if name in m.get("workloads", [name])]
    return dict(cell, per_layer=metrics), config, mix


def card_state() -> dict:
    """nvidia-smi's reading of the card beside the window."""
    q = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout
    except (OSError, subprocess.TimeoutExpired):
        return {}
    rows = [r.split(", ") for r in out.strip().splitlines() if r]
    return {f"gpu{i}": dict(zip(q.split(","), r)) for i, r in enumerate(rows)}


def check_card(chips: int) -> str | None:
    """None when CUDA holds at least `chips` cards, else why not."""
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device is available"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} CUDA devices, "
                f"{torch.cuda.device_count()} are available")
    return None


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _clean_env() -> None:
    """The CLI's defaults: no routing environment; every build and kernel
    cache inside the checkout, at fixed paths."""
    for k in list(os.environ):
        if k.startswith("MM2TPU_"):
            del os.environ[k]
    cache = os.path.join(ROOT, "build", "benchmark")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))


def make_inputs(config: dict, mix: dict, seed: int, workdir: str) -> dict:
    """The genome and the read pool of one seed, written under workdir."""
    import numpy as np
    from benchmark.traffic import synth
    gen = importlib.import_module(f"benchmark.traffic.{mix['kind']}")
    genome, loci = synth.build(np.random.default_rng([seed, GENOME_STREAM]),
                               config["genome"])
    path = os.path.join(workdir, "genome.fa")
    with open(path, "wb") as fh:
        fh.write(synth.fasta_bytes(genome))
    reads = gen.make(mix, genome, loci,
                     np.random.default_rng([seed, READS_STREAM]), workdir)
    return dict(reads, genome=path)


def digest(batch_lines) -> str:
    """The SHA-1 of a batch's SAM text, its lines joined as the CLI joins
    them."""
    flat = [line for lines in batch_lines for line in lines]
    return hashlib.sha1(sam_text(flat).encode()).hexdigest()


def sam_text(flat: list) -> str:
    return "\n".join(flat) + "\n" if flat else ""


def drive(runtime, one_pass, npool: int, seconds: float, sync=None) -> dict:
    """The measured window: the batches of `one_pass()` (a fresh iterator
    over the pool each pass, prefetched 2 deep as the CLI does) handed to
    runtime.map_stream in turn until `seconds` have passed (at least one),
    each result's SAM lines joined as the CLI joins them. Returns t0 (the
    window's start), t_end (the return of the last batch handed, the
    pipeline's drain included), the tally of what was handed, each pool
    batch's lines of its first pass and the digest of every pass."""
    from minimap2_chaindp_tpu_torch.utils.prefetch import prefetch
    stop = threading.Event()

    def cyclic():
        while not stop.is_set():
            for b in one_pass():
                if stop.is_set():
                    return
                yield b

    feed = prefetch(cyclic(), depth=2)
    handed: deque = deque()
    first: dict = {}
    digests: dict = {}
    tally = dict(frags=0, bases=0, batches=0, sam_bytes=0)
    returned = []
    spans = []
    real_map = runtime.map_batch

    def timed_map(frags, rg_id=""):
        a, c = time.perf_counter(), time.thread_time()
        try:
            return real_map(frags, rg_id)
        finally:
            spans.append((a - t0, time.perf_counter() - t0,
                          time.thread_time() - c))

    runtime.map_batch = timed_map
    cpu0, steal0 = time.process_time(), _steal()
    t0 = time.perf_counter()
    deadline = t0 + seconds

    def gate():
        i = 0
        for b in feed:
            if i and time.perf_counter() >= deadline:
                break
            handed.append(i)
            tally["frags"] += len(b)
            tally["bases"] += sum(len(s.seq) for f in b for s in f.segs)
            yield b
            i += 1
        stop.set()

    for batch_lines in runtime.map_stream(gate(), ""):
        b = handed.popleft() % npool
        text = sam_text([line for lines in batch_lines for line in lines])
        tally["sam_bytes"] += len(text)
        tally["batches"] += 1
        digests.setdefault(b, []).append(
            hashlib.sha1(text.encode()).hexdigest())
        first.setdefault(b, batch_lines)
        returned.append(time.perf_counter() - t0)
    if sync is not None:
        sync()
    t_end = time.perf_counter()
    host = dict(cpu_s=time.process_time() - cpu0, steal_s=_steal() - steal0)
    runtime.map_batch = real_map
    stop.set()
    for _ in feed:     # let the prefetch thread see the stop and end
        pass
    return dict(t0=t0, t_end=t_end, tally=tally, first=first,
                digests=digests, returned=returned, batch_spans=spans,
                host=host)


def _steal() -> float:
    """Seconds of CPU stolen from this machine by its host (/proc/stat),
    summed over its CPUs; 0 where unknown."""
    try:
        with open("/proc/stat") as fh:
            f = fh.readline().split()
        return int(f[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def run_cell(cell: dict, config: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> dict:
    """One run of a cell; returns the result object (see the module
    docstring). `device` "cpu" serves the harness's tests."""
    import torch
    from minimap2_chaindp_tpu_torch import cli
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.options import set_opt
    parts = {"imports": time.perf_counter() - T_START}
    workdir = tempfile.mkdtemp(prefix="mm2bench-")
    try:
        t = time.perf_counter()
        if device == "cuda":
            torch.cuda.set_device(0)
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        parts["card"] = time.perf_counter() - t
        t = time.perf_counter()
        inputs = make_inputs(config, mix, seed, workdir)
        parts["inputs"] = time.perf_counter() - t
        io, mo = set_opt(config["preset"])
        for f in config["flags"]:
            if f != "-a":
                raise ValueError(f"flag {f!r} is not wired")
            mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
        files, frag_mode, K = (inputs["files"], inputs["frag_mode"],
                               inputs["batch_bases"])
        pool = list(read_frags(files, K, frag_mode))
        t = time.perf_counter()
        names, seqs = [], []
        for r in read_fastx(inputs["genome"]):
            names.append(r.name)
            seqs.append(C.seq_to_nt4(r.seq))
        mi = build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                         n_threads=config["threads"])
        del seqs
        mo.update(mi)
        parts["index"] = time.perf_counter() - t
        t = time.perf_counter()
        runtime = cli.make_runtime(mi, mo, device, config["threads"],
                                   cli.runtime_kwargs(), None)
        parts["runtime"] = time.perf_counter() - t
        t = time.perf_counter()
        warm = [digest(lines) for lines in runtime.map_stream(iter(pool), "")]
        if device == "cuda":
            torch.cuda.synchronize()
        parts["warmup"] = time.perf_counter() - t
        card_before = card_state() if device == "cuda" else {}
        stats0 = _timer_state(runtime)

        # ---------------------------------------------------------- window
        prof = rec = instr = win_span = None
        if trace:
            from benchmark import trace as TR
            from torch.profiler import ProfilerActivity, profile
            instr = TR.instrument()
            rec = instr.__enter__()
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if device == "cuda" else [])
            prof = profile(activities=acts)
            prof.__enter__()
            win_span = torch.profiler.record_function("bench::window")
            win_span.__enter__()
            win_ns = time.perf_counter_ns()
        sync = torch.cuda.synchronize if device == "cuda" else None
        w = drive(runtime, lambda: read_frags(files, K, frag_mode),
                  len(pool), seconds, sync)
        if win_span is not None:
            win_span.__exit__(None, None, None)
        tally, first_lines, digests = w["tally"], w["first"], w["digests"]
        setup_s = w["t0"] - T_START
        window_s = w["t_end"] - w["t0"]
        dev_rec = None
        if trace:
            prof.__exit__(None, None, None)
            instr.__exit__(None, None, None)
        stats = _timer_diff(stats0, _timer_state(runtime))
        card_after = card_state() if device == "cuda" else {}
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        if trace:
            dev_rec = TR.reduce_profile(prof, {"chain": TR.CHAIN_KERNELS,
                                               "ksw": TR.KSW_KERNELS},
                                        rec.spans, win_ns)
            dev_rec["least_s"] = rec.least_seconds()
            log("[bench] trace: " + json.dumps(
                {k: dev_rec[k] for k in ("n_device", "n_spans", "n_gaps",
                                         "spans_at", "kernel_s", "least_s",
                                         "busy_s", "window_s")}))
            prof = rec = None
        runtime.close()
        del runtime, mi
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        bad = forbidden_modules()
        if bad:
            raise ForbiddenModules(bad)
        passes = tally["batches"] / len(pool)
        log(f"[bench] window {window_s:.3f} s: {tally['batches']} batches "
            f"({passes:.2f} passes over a pool of {len(pool)}), "
            f"{tally['frags']} fragments, {tally['bases']} bases, "
            f"{tally['sam_bytes']} SAM bytes")
        log("[bench] batches returned at (s): "
            + " ".join(f"{x:.2f}" for x in w["returned"]))
        log("[bench] map_batch (start, end, thread cpu) s: " + " ".join(
            f"{a:.2f},{b:.2f},{c:.2f}" for a, b, c in w["batch_spans"]))
        log("[bench] host over the window: " + json.dumps(w["host"]))
        log("[bench] setup parts (s): " + json.dumps(
            {k: round(v, 3) for k, v in parts.items()}))
        log("[bench] card before/after the window: "
            + json.dumps([card_before, card_after]))

        # ---------------------------------------------------- correctness
        checks, failed = verify(pool, first_lines, digests, warm, config, mix,
                                seed, inputs["genome"])
        record = dict(timers=stats["acc"], counters=stats["counters"],
                      frags=tally["frags"], bases=tally["bases"],
                      window_s=window_s, device=dev_rec)
        if trace:
            metrics = {}
            for m in cell["per_layer"]:
                reader = importlib.import_module(
                    f"benchmark.metrics.{m['name']}")
                v = reader.read(record)
                if v is not None:
                    metrics[m["name"]] = dict(value=v, unit=m["unit"])
        else:
            metrics = {
                "bases_per_s": dict(value=tally["bases"] / window_s,
                                    unit="bases/s"),
                "setup_s": dict(value=setup_s, unit="s")}
        gpu = next(iter(card_before.values()), {})
        dev = dict(platform="gpu" if device == "cuda" else "cpu",
                   kind=torch.cuda.get_device_name(0) if device == "cuda"
                   else "cpu", count=cell["chips"], memory_peak_bytes=peak,
                   power_limit=gpu.get("power.limit"))
        result = dict(correct=all(v <= lim for v, lim in checks.values()),
                      attempted=tally["frags"], failed=failed,
                      metrics=metrics, device=dev)
        if trace:
            dev.update(busy_s=dev_rec["busy_s"], window_s=dev_rec["window_s"])
            result["breakdown"] = dict(device_ops=dev_rec["device_ops"],
                                       idle_gaps=dev_rec["idle_gaps"])
        result["checked"] = {k: dict(value=v, limit=lim)
                             for k, (v, lim) in checks.items()}
        return result
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__("modules loaded that a run may not load: "
                         + ", ".join(names))


def _timer_state(runtime) -> dict:
    t = runtime.timers
    with t._lock:
        return dict(acc=dict(t.acc), counters=dict(t.counters))


def _timer_diff(a: dict, b: dict) -> dict:
    return {k: {n: b[k][n] - a[k].get(n, 0) for n in b[k]} for k in b}


def sample(pool, mapped: set, n: int, seed: int) -> list[tuple[int, int]]:
    """`n` fragments (batch, index) of the batches mapped in the window,
    drawn from the seed as evenly over those batches as n allows (the
    remainder one more in batches drawn from the seed), and the longest of
    them."""
    import numpy as np
    rng = np.random.default_rng([seed, SAMPLE_STREAM])
    batches = sorted(mapped)
    each, extra = divmod(n, len(batches))
    more = set(rng.choice(len(batches), extra, replace=False).tolist())
    out = []
    for i, b in enumerate(batches):
        k = min(len(pool[b]), each + (i in more))
        out += [(b, j) for j in sorted(
            rng.choice(len(pool[b]), k, replace=False).tolist())]
    size = lambda bj: sum(len(s.seq) for s in pool[bj[0]][bj[1]].segs)
    longest = max(((b, j) for b in batches for j in range(len(pool[b]))),
                  key=size)
    if longest not in out:
        out.append(longest)
    return out


def reference(job: dict) -> dict:
    """The plain reference's lines for the sampled fragments, from its own
    process (benchmark/reference/check.py)."""
    with tempfile.TemporaryDirectory(prefix="mm2ref-") as d:
        jp, op = os.path.join(d, "job.json"), os.path.join(d, "out.json")
        with open(jp, "w") as fh:
            json.dump(job, fh)
        env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
        res = subprocess.run([sys.executable, "-m",
                              "benchmark.reference.check", jp, op],
                             cwd=ROOT, env=env, capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError("the reference failed:\n" + res.stderr[-4000:])
        with open(op) as fh:
            return json.load(fh)


def frag_job(frag) -> list[dict]:
    return [dict(name=s.name, seq=s.seq, qual=s.qual) for s in frag.segs]


def verify(pool, first_lines, digests, warm, config, mix, seed,
           genome) -> tuple:
    """The sample's reference lines (benchmark/reference), then `judge`."""
    picks = sample(pool, set(first_lines), mix["check_frags"], seed)
    t = time.perf_counter()
    out = reference(dict(genome=genome, preset=config["preset"],
                         flags=config["flags"],
                         workers=config["threads"],
                         frags=[frag_job(pool[b][j]) for b, j in picks]))
    log(f"[bench] reference: {len(picks)} fragments in "
        f"{time.perf_counter() - t:.1f} s ({json.dumps(out['seconds'])}), "
        f"mid_occ {out['mid_occ']}")
    return judge(pool, picks, lambda b, j: first_lines[b][j], out["lines"],
                 digests, warm)


def judge(pool, picks, lines_of, want, digests, warm) -> tuple:
    """The compared numbers {name: (value, limit)} and the count of
    fragments known wrong. sample_mismatch: sampled fragments (batch, index)
    whose SAM lines, lines_of(batch, index), differ from the reference's
    (`want`, in the order of `picks`); pass_mismatch: passes of a batch in
    the window (`digests`, each batch's list) whose SAM text differs from its
    warm-up pass (`warm`). The control is judged by this function too."""
    mism = [(b, j) for (b, j), w in zip(picks, want) if lines_of(b, j) != w]
    bad = {b: sum(d != warm[b] for d in ds) for b, ds in digests.items()}
    bad_frags = len(mism) + sum(len(pool[b]) for b, n in bad.items() if n)
    for b, j in mism[:3]:
        log(f"[bench] fragment {pool[b][j].segs[0].name} differs:\n  "
            f"program: {lines_of(b, j)!r:.600}\n  reference: "
            f"{want[picks.index((b, j))]!r:.600}")
    return {"sample_mismatch": (len(mism), 0),
            "pass_mismatch": (sum(bad.values()), 0)}, bad_frags


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, mix = load_cell(args.workload)
    _clean_env()
    why = check_card(cell["chips"])
    if why is not None:
        log(f"[bench] {why}: this benchmark runs on the card only")
        return 1
    try:
        result = run_cell(cell, config, mix, args.seed, args.seconds,
                          bool(args.trace))
    except ForbiddenModules as e:
        log(f"[bench] {e}")
        return 1
    bad = forbidden_modules()
    if bad:
        log(f"[bench] {ForbiddenModules(bad)}")
        return 1
    for name, c in result["checked"].items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
