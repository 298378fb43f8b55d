"""End-to-end mapping throughput of the port: simulated ONT-like reads (or
short read pairs) against a synthetic genome, `-a` SAM output, the card's
lane against the host's in one process.

Usage:
  python -m minimap2_chaindp_tpu_torch.tools.e2e_bench [--reads N]
      [--len L] [--device pair|cuda|cpu|host] [--pair-lane cuda|cpu]
      [--steady N] [--preset P] [--pairs] [--ref-fa FA] [--index IDX]
      [--profile] [--keep-inputs DIR]

Port of tools/e2e_bench.py. By default (`--device pair --pair-lane cuda
--steady 3`) it times the card's lane against the host's. `--device pair
--steady N` interleaves the `--pair-lane` lane (cuda, or cpu with the plain
versions) and the host lane run by run, the order alternating, run 0 the
warm-up of both, and prints `runN[dev]` (stderr), `steady[dev]` and
`paired_ratio_median` (host time / lane time of the runs of one iteration;
above 1 the lane is faster), each lane run's `flowN`/`stealN` telemetry
from `cli.LAST_RUN_COUNTERS` (stderr), the lane's kernel launches over all
its runs (`launches:`), and `sam_identical: K/K`. Every iteration's lane
SAM must equal the host lane's apart from `@PG`: a mismatch, or a CLI run
that fails, exits non-zero. `--device cuda|cpu|host` times one lane of the
port's CLI (`cli.main()` in this process: one warm-up run, then `--steady`
timed runs, the best printed as `steady:`; with `--steady 0`, `--repeat`
runs of the CLI as a subprocess, start-up included). `--keep-inputs DIR`
keeps the largest input of each kernel wrapper over the in-process runs
(utils/kernel_inputs.py) and writes it under DIR, for a check against the
plain versions afterwards.

With neither `--ref-fa` nor `--index`, the reference is a
utils/genome_synth genome (GENOME: 25 x 2 Mbp, seed 42) and the runs map
from its `-d` index for the preset, both made once and cached under the
temp directory (genome_synth.cache_dir()); `--ref-fa` alone maps from the
FASTA, building the index in every run, as the original does. `--pairs`
simulates `--reads` FR pairs of `--len` bp (genome_synth.simulate_pairs)
and maps them as two files.

Not ported: `await_link_verdict` (:60-96, the TPU link's probe verdict),
`--device refpair`, `--ref` and `--both` (the reference binary, which no
machine of the port has).
"""
from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..utils import kernel_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BASES = "ACGT"
GENOME = dict(n_contigs=25, contig_len=2_000_000, seed=42)   # 50 Mbp


def simulate(ref_seq, n, read_len, err, seed):
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(ref_seq) - read_len))
        en = st + read_len
        out = []
        for c in ref_seq[st:en]:
            r = rng.random()
            if r < err * 0.6:
                out.append(BASES[int(rng.integers(0, 4))])
            elif r < err * 0.8:
                pass
            elif r < err:
                out.append(c)
                out.append(BASES[int(rng.integers(0, 4))])
            else:
                out.append(c)
        strand = "+" if rng.random() < 0.5 else "-"
        s = "".join(out)
        if strand == "-":
            s = s[::-1].translate(str.maketrans("ACGT", "TGCA"))
        reads.append((f"S1_{i}!MT_human!{st}!{en}!{strand}", s))
    return reads


def write_reads(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{seq}\n")


def cached_index(ref_fa: str, preset: str) -> str:
    """The `-d` index of ref_fa under preset, built once next to the cached
    genome by the port's CLI."""
    from .. import cli
    path = f"{os.path.splitext(ref_fa)[0]}.{preset}.mm2i"
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp.mm2i"
        rc = cli.main(["-x", preset, "--device", "host", "-d", tmp, ref_fa])
        if rc != 0:
            raise SystemExit(f"[e2e_bench] the index build failed (rc {rc})")
        os.replace(tmp, path)
    return path


def make_queries(args, ref_fa, work):
    """The query files: --reads reads simulated from every contig of ref_fa
    (the original's scheme), or --reads pairs with --pairs."""
    from ..io.fastx import read_fastx
    from ..utils.genome_synth import simulate_pairs
    if args.pairs:
        q1, q2 = os.path.join(work, "r1.fq"), os.path.join(work, "r2.fq")
        simulate_pairs(ref_fa, q1, q2, args.reads, seed=7,
                       read_len=args.read_len, err=args.err)
        return [q1, q2]
    refs = list(read_fastx(ref_fa))
    rng = np.random.default_rng(11)
    if len(refs) == 1:
        reads = simulate(refs[0].seq, args.reads, args.read_len, args.err,
                         seed=7)
    else:
        reads = []
        per = [int(rng.integers(0, len(refs))) for _ in range(args.reads)]
        for ci in sorted(set(per)):
            n_c = per.count(ci)
            sub = simulate(refs[ci].seq, n_c, args.read_len, args.err,
                           seed=7 + ci)
            reads.extend((f"{nm}!{refs[ci].name}", sq) for nm, sq in sub)
    qpath = os.path.join(work, "reads.fa")
    write_reads(qpath, reads)
    return [qpath]


def sam_body(path):
    """The SAM lines of a run apart from @PG."""
    with open(path) as fh:
        return [ln for ln in fh if not ln.startswith("@PG")]


def launches() -> dict:
    """The kernel wrappers' launch counts in this process: chain, ksw
    (forward), walk, and the chain launches by form."""
    from ..ops import chain_dp, ksw2_ext
    return dict(chain=chain_dp.chain_scores_batch.launches,
                ksw=ksw2_ext.ksw_forward.launches,
                walk=ksw2_ext.ksw_walk.launches,
                **chain_dp.chain_scores_batch.by_form)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reads", type=int, default=400)
    ap.add_argument("--len", dest="read_len", type=int, default=1000)
    ap.add_argument("--device", default="pair",
                    choices=["pair", "cuda", "cpu", "host"])
    ap.add_argument("--pair-lane", default="cuda", choices=["cuda", "cpu"],
                    help="the port's lane that --device pair sets against "
                         "the host lane")
    ap.add_argument("--preset", default="map-ont",
                    help="preset for BOTH lanes (e.g. sr with --pairs)")
    ap.add_argument("--err", type=float, default=0.10,
                    help="simulated per-base error rate (use ~0.005 "
                         "for Illumina-like sr reads)")
    ap.add_argument("--pairs", action="store_true",
                    help="simulate --reads FR pairs of --len bp")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--steady", type=int, default=3, metavar="N",
                    help="in-process steady-state timing: 1 warmup + N "
                         "timed repeats, best reported (0: --repeat "
                         "subprocess runs; not with --device pair)")
    ap.add_argument("--batch", type=int, default=400)
    ap.add_argument("--repeat", type=int, default=2,
                    help="timed subprocess runs with --steady 0 (first "
                         "run includes warmup)")
    ap.add_argument("--ref-fa", default=None,
                    help="reference FASTA (default: the cached synthetic "
                         "genome); reads are simulated from ALL contigs")
    ap.add_argument("--index", default=None,
                    help="map against this prebuilt index (.mm2i) instead "
                         "of re-building from --ref-fa every run")
    ap.add_argument("--workdir", default=None,
                    help="keep the reads and the last run's SAM of each "
                         "lane (<device>.sam) here (default: a temp "
                         "directory, removed at exit)")
    ap.add_argument("--keep-inputs", default=None, metavar="DIR",
                    help="write the largest input of each kernel wrapper "
                         "over the in-process runs under DIR")
    args = ap.parse_args(argv)
    if args.device == "pair" and not args.steady:
        ap.error("--device pair requires --steady N (paired runs are an "
                 "in-process steady-state mode)")

    from ..utils.genome_synth import cached_genome
    ref_fa = args.ref_fa and os.path.abspath(args.ref_fa)
    target = args.index and os.path.abspath(args.index)
    if ref_fa is None:
        ref_fa = cached_genome(**GENOME)
        target = target or cached_index(ref_fa, args.preset)
    target = target or ref_fa
    keep = kernel_inputs.record() if args.keep_inputs \
        else contextlib.nullcontext()
    with keep as rec:
        if args.workdir:
            os.makedirs(args.workdir, exist_ok=True)
            rc = _run(args, ref_fa, target, args.workdir)
        else:
            with tempfile.TemporaryDirectory(prefix="e2e_bench_") as work:
                rc = _run(args, ref_fa, target, work)
    if rec is not None:
        names = rec.save(args.keep_inputs)
        print(f"kept_inputs: {' '.join(names) or 'none'}")
    return rc


def _run(args, ref_fa, target, work):
    queries = make_queries(args, ref_fa, work)
    opts = ["-ax", args.preset, "-K", str(args.batch * args.read_len)]

    def timed_cli_run(dev, sam):
        """One in-process cli.main() mapping run, SAM to `sam`, wall time
        returned; stdout restored even if the run raises."""
        from .. import cli
        old = sys.stdout
        try:
            with open(sam, "w") as out:
                sys.stdout = out
                t0 = time.perf_counter()
                rc = cli.main([*opts, "--device", dev, target, *queries])
                dt = time.perf_counter() - t0
        finally:
            sys.stdout = old
        if rc != 0:
            raise SystemExit(f"[e2e_bench] --device {dev}: the CLI exited "
                             f"{rc}")
        return dt

    if args.steady and args.device == "pair":
        lane = args.pair_lane
        best = {"host": None, lane: None}
        ratios = []
        n_same = 0
        for it in range(args.steady + 1):
            order = ("host", lane) if it % 2 == 0 else (lane, "host")
            pair = {}
            sams = {}
            for dev in order:
                sams[dev] = os.path.join(work, f"{dev}.sam")
                dt = timed_cli_run(dev, sams[dev])
                if it > 0:  # iteration 0 is both lanes' warmup
                    b = best[dev]
                    best[dev] = dt if b is None else min(b, dt)
                    pair[dev] = dt
                print(f"run{it}[{dev}]: {args.reads / dt:8.1f} reads/s"
                      f"  ({dt:.2f}s)", file=sys.stderr)
                if dev == lane:
                    from .. import cli as _cli
                    c = _cli.LAST_RUN_COUNTERS
                    print(f"flow{it}[{dev}]: "
                          f"device_reads={c.get('device_reads', 0)} "
                          f"staged_device_reads="
                          f"{c.get('staged_device_reads', 0)} "
                          f"fallback={c.get('fallback', 0)} "
                          f"ext_device={c.get('ext_device', 0)} "
                          f"ext_native={c.get('ext_native', 0)}",
                          file=sys.stderr)
                    print(f"steal{it}[{dev}]: "
                          f"steal_reads={c.get('steal_device_reads', 0)} "
                          f"steal_chunks={c.get('steal_chunks', 0)} "
                          f"steal_cpu_ms={c.get('steal_cpu_ms', 0)} "
                          f"steal_prep_ms={c.get('steal_cpu_prep_ms', 0)} "
                          f"steal_flowhost_ms="
                          f"{c.get('steal_cpu_flowhost_ms', 0)} "
                          f"steal_finish_ms="
                          f"{c.get('steal_cpu_finish_ms', 0)} "
                          f"steal_paused={c.get('steal_paused', 0)} "
                          f"steal_probe={c.get('steal_probe', 0)}",
                          file=sys.stderr)
            if len(pair) == 2:
                # ADJACENT-run ratio: the two runs share machine state,
                # unlike best-of-N
                ratios.append(pair["host"] / pair[lane])
            got, want = sam_body(sams[lane]), sam_body(sams["host"])
            if got != want:
                diff = next((g, w) for g, w in zip(got + [""], want + [""])
                            if g != w)
                print(f"sam{it}: --device {lane} differs from --device "
                      f"host:\n{lane}: {diff[0][:200]}\nhost: "
                      f"{diff[1][:200]}", file=sys.stderr)
                raise SystemExit(1)
            n_same += 1
        for dev in ("host", lane):
            print(f"steady[{dev}]: {args.reads / best[dev]:8.1f} reads/s"
                  f"  ({best[dev]:.2f}s)")
        ratios.sort()
        print(f"paired_ratio_median: {ratios[len(ratios) // 2]:.3f}")
        print("launches: " + " ".join(f"{k}={v}"
                                      for k, v in launches().items()))
        print(f"sam_identical: {n_same}/{args.steady + 1}")
        return 0

    sam = os.path.join(work, f"{args.device}.sam")
    if args.steady:
        # steady-state in-process timing: one warmup run (pays index load,
        # native-lib load, the kernels' load and the CSR upload) then
        # `--steady` timed repeats, best taken
        best = None
        for it in range(args.steady + 1):
            dt = timed_cli_run(args.device, sam)
            if it > 0:  # run 0 is warmup
                best = dt if best is None else min(best, dt)
            print(f"run{it}: {args.reads / dt:8.1f} reads/s  ({dt:.2f}s)",
                  file=sys.stderr)
        print(f"steady: {args.reads / best:8.1f} reads/s  ({best:.2f}s)")
        print("launches: " + " ".join(f"{k}={v}"
                                      for k, v in launches().items()))
        return 0

    if args.profile:
        import cProfile
        import pstats
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        pr.enable()
        timed_cli_run(args.device, sam)
        pr.disable()
        dt = time.perf_counter() - t0
        print(f"profiled: {args.reads / dt:8.1f} reads/s  ({dt:.2f}s)")
        pstats.Stats(pr).sort_stats("cumulative").print_stats(35)
        return 0

    cmd = [sys.executable, "-m", "minimap2_chaindp_tpu_torch.cli", *opts,
           "--device", args.device, target, *queries]
    for it in range(args.repeat):
        t0 = time.perf_counter()
        subprocess.run(cmd, stdout=subprocess.DEVNULL,
                       stderr=subprocess.DEVNULL, check=True, cwd=ROOT)
        dt = time.perf_counter() - t0
        print(f"mm2tpu[{args.device}] run{it}: {args.reads / dt:8.1f} "
              f"reads/s  ({dt:.2f}s incl. startup)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
