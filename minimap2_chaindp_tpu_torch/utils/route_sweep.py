"""The native crossovers, measured on one CUDA device: where the card
starts to beat the host's native code per read (chaining) and per job
(extension), at each batch size.

  python -m minimap2_chaindp_tpu_torch.utils.route_sweep [--genome FA]
      [--mbp N] [--reps N] [--out JSON]      (from the repo root)

- chain: reads simulated from the genome (chip_smoke.py's cached 250 Mbp
  genome when it is there, else `utils/genome_synth` at `--mbp`) at
  lengths that fill each staged bucket (256 ... 8192 anchors), seeded on
  the host; for each bucket and R in CHAIN_READS reads, the time per read
  of TorchRuntime._chain_batch on the host (`native_chain_max` past every
  bucket: `chain_dp_native`) and on the card (pack_reads, H2D, the chain
  kernel, D2H and `chain_bottom_native`), in turns, the median of `--reps`
  rounds after a warm-up; the chains must be equal.
- extension: jobs of qlen + tlen in EXT_SIZES bases (a 5%-error copy of a
  random target), extd2 under map-ont's scoring (w = 500, with a CIGAR)
  and exts2 under splice's, in waves of EXT_WAVES jobs:
  `extd2_batch_native` / `exts2_batch_native` (host SIMD) against
  `KE.extd2_batch` / `KE.exts2_batch` on the card with the walk and the
  CIGAR decode; ez scores and CIGARs must be equal.
Cells past CHAIN_ANCHORS_MAX anchors or EXT_CELLS_MAX DP cells a wave are
skipped. Each table ends with the crossover the runtime's
`native_chain_max` / `native_ext_max` would take at each batch size (the
largest size at which the host still wins), and the last line is the
whole result as JSON. Host times are wall clock on the host; both sides
run on one thread.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

CHAIN_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)
CHAIN_READS = (16, 64, 256, 1024)
CHAIN_ANCHORS_MAX = 1 << 21          # reads x bucket per cell
EXT_SIZES = (64, 256, 1024, 4096, 16384)
EXT_WAVES = (4, 64, 1024)
EXT_CELLS_MAX = 1 << 31              # DP cells per wave
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMOKE_GENOME = os.path.join(ROOT, "build", "smoke",
                            "genome_125x2000000_s42.fa")
OUT_DIR = os.path.join(ROOT, "build", "route_sweep")   # genome and reads


def log(msg: str) -> None:
    print(f"[route_sweep] {msg}", flush=True)


def in_turns(fns: dict, reps: int) -> dict:
    """Each callable once a round after a warm-up round: {name: median s}."""
    for fn in fns.values():
        fn()
    times = {k: [] for k in fns}
    for _ in range(reps):
        for k, fn in fns.items():
            t0 = time.perf_counter()
            fn()
            times[k].append(time.perf_counter() - t0)
    return {k: statistics.median(v) for k, v in times.items()}


def genome_path(args) -> str:
    if args.genome:
        return args.genome
    if os.path.exists(SMOKE_GENOME):
        return SMOKE_GENOME
    from . import genome_synth as G
    path = os.path.join(OUT_DIR, f"genome_{args.mbp}mbp_s42.fa")
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        n = max(1, args.mbp // 2)
        G.make_genome(path + ".tmp", n_contigs=n, contig_len=2_000_000,
                      seed=42)
        os.replace(path + ".tmp", path)
    return path


def bucket_units(mi, opt, ref, tmp_dir, per_bucket=32):
    """{bucket: [(segs, UnitInfo)]} of reads simulated at 5% error whose
    anchor count falls in (bucket / 2, bucket]; the read length starts at
    6 bases an anchor and is rescaled from the median count of each try
    (repeats make the count vary widely from read to read)."""
    from ..io.fastx import read_fastx
    from ..models.pipeline import seed_unit
    from . import genome_synth as G
    out = {}
    for i, b in enumerate(CHAIN_BUCKETS):
        units, length = [], b * 6
        for attempt in range(4):
            path = os.path.join(tmp_dir, f"sweep_reads_{b}_{attempt}.fa")
            G.simulate(ref, path, per_bucket, length, 0.05,
                       seed=100 + 10 * i + attempt)
            counts = []
            for r in read_fastx(path):
                info = seed_unit(mi, opt, [r])
                n = 0 if info.sh is None else len(info.sh.anchors)
                counts.append(n)
                if b // 2 < n <= b:
                    units.append(([r], info))
            if len(units) >= per_bucket // 2:
                break
            length = int(length * 0.75 * b / max(np.median(counts), 1))
        out[b] = units
        log(f"bucket {b}: {len(units)} reads of {length} bp in the bucket")
    return out


def chain_sweep(mi, opt, units_by_bucket, reps):
    import torch
    from ..models.runtime import TorchRuntime
    card = TorchRuntime(mi, opt, device="cuda")
    host = TorchRuntime(mi, opt, device="cuda", native_chain_max=1 << 30)
    rows = []
    for b, units in units_by_bucket.items():
        if not units:
            continue
        for R in CHAIN_READS:
            if R * b > CHAIN_ANCHORS_MAX:
                continue
            pending = [units[k % len(units)] for k in range(R)]
            got = {}

            def run(rt, name):
                got[name] = rt._chain_batch(pending)
                torch.cuda.synchronize()
            t = in_turns({"native": lambda: run(host, "native"),
                          "card": lambda: run(card, "card")}, reps)
            for a, w in zip(got["card"], got["native"]):
                if not (np.array_equal(a.anchors, w.anchors)
                        and np.array_equal(a.u, w.u)):
                    raise SystemExit(f"chain bucket {b} R={R}: the card's "
                                     "chains differ from the host's")
            rows.append(dict(bucket=b, reads=R,
                             native_us=t["native"] / R * 1e6,
                             card_us=t["card"] / R * 1e6))
            log("chain bucket {bucket} R={reads}: native {native_us:.1f} "
                "us/read, card {card_us:.1f} us/read".format(**rows[-1]))
    if card.timers.counters["host_chain"] or \
            host.timers.counters["staged_device_reads"]:
        raise SystemExit("chain sweep: a runtime took the other lane")
    return rows


def _ext_jobs(rng, n, size, splice, K):
    from .ksw_sweep import _mut
    jobs = []
    for _ in range(n):
        t = rng.integers(0, 4, size // 2).astype(np.uint8)
        q = _mut(rng, t, sub=0.035, ind=0.015)
        if splice:
            jobs.append(dict(qseq=q, tseq=t, zdrop=200, end_bonus=-1,
                             flag=K.KSW_EZ_SPLICE_FOR, w=-1))
        else:
            jobs.append(dict(qseq=q, tseq=t, w=500, zdrop=400,
                             end_bonus=-1, flag=0))
    return jobs


def ext_sweep(reps):
    import torch
    from .. import native
    from ..ops import ksw2 as K
    from ..ops import ksw2_ext as KE
    from ..options import set_opt
    rows = []
    for splice in (False, True):
        _, o = set_opt("splice" if splice else "map-ont")
        mat = K.gen_simple_mat(5, o.a, o.b)
        if splice:
            nat = lambda js: native.exts2_batch_native(js, mat, o.q, o.e,
                                                       o.q2, o.noncan)
            dev = lambda js: KE.exts2_batch(js, mat, o.q, o.e, o.q2,
                                            o.noncan, device="cuda")
        else:
            nat = lambda js: native.extd2_batch_native(js, mat, o.q, o.e,
                                                       o.q2, o.e2)
            dev = lambda js: KE.extd2_batch(js, mat, o.q, o.e, o.q2, o.e2,
                                            device="cuda")
        mode = "exts2" if splice else "extd2"
        for size in EXT_SIZES:
            half = size // 2
            cells = half * half if splice else half * min(half, 1001)
            for n in EXT_WAVES:
                if n * cells > EXT_CELLS_MAX:
                    continue
                jobs = _ext_jobs(np.random.default_rng(size + n), n, size,
                                 splice, K)
                got = {}

                def run(fn, name):
                    got[name] = fn(jobs)
                    torch.cuda.synchronize()
                t = in_turns({"native": lambda: run(nat, "native"),
                              "card": lambda: run(dev, "card")}, reps)
                key = lambda g: (g.score, g.max, g.zdropped, g.max_q,
                                 g.max_t, g.mqe, g.mte, list(g.cigar))
                if [key(g) for g in got["card"]] != \
                        [key(g) for g in got["native"]]:
                    raise SystemExit(f"{mode} size {size} wave {n}: the "
                                     "card's results differ from the host's")
                rows.append(dict(mode=mode, size=size, jobs=n,
                                 native_us=t["native"] / n * 1e6,
                                 card_us=t["card"] / n * 1e6))
                log("{mode} size {size} wave {jobs}: native {native_us:.1f}"
                    " us/job, card {card_us:.1f} us/job".format(**rows[-1]))
    return rows


def crossovers(rows, size_key, batch_key):
    """{batch size: the largest size at which the host still wins (0 when
    the card wins at the smallest)}, per mode where rows have one."""
    out = {}
    for r in rows:
        k = (r.get("mode", "chain"), r[batch_key])
        best = out.setdefault(k, 0)
        if r["native_us"] <= r["card_us"]:
            out[k] = max(best, r[size_key])
    return {f"{m} {n}": v for (m, n), v in sorted(out.items())}


def table(rows, size_key, batch_key, batches, sizes, label):
    lines = [f"| {label} | " + " | ".join(f"{n} native / card us" for n in
                                          batches) + " |",
             "|---" * (len(batches) + 1) + "|"]
    for s in sizes:
        cells = []
        for n in batches:
            r = next((r for r in rows if r[size_key] == s
                      and r[batch_key] == n), None)
            cells.append("-" if r is None else
                         f"{r['native_us']:.1f} / {r['card_us']:.1f}")
        lines.append(f"| {s} | " + " | ".join(cells) + " |")
    return "\n".join(lines)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--genome", help="FASTA to simulate the chain reads from")
    p.add_argument("--mbp", type=int, default=50,
                   help="size of the synthetic genome when there is none")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--out", help="also write the JSON result here")
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("[route_sweep] needs a CUDA device", file=sys.stderr)
        return 1
    import subprocess
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    log(f"card: {card}")
    res = dict(card=card)
    from .. import constants as C
    from ..index.build import build_index
    from ..io.fastx import read_fastx
    from ..options import set_opt
    ref = genome_path(args)
    t0 = time.perf_counter()
    io, opt = set_opt("map-ont")
    names, seqs = [], []
    for r in read_fastx(ref):
        names.append(r.name)
        seqs.append(C.seq_to_nt4(r.seq))
    mi = build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                     n_threads=os.cpu_count() or 1)
    del names, seqs
    opt.update(mi)
    log(f"genome {ref}: {len(mi.keys)} keys, index "
        f"{time.perf_counter() - t0:.1f} s")
    tmp = os.path.join(OUT_DIR, "reads")
    os.makedirs(tmp, exist_ok=True)
    rows = chain_sweep(mi, opt, bucket_units(mi, opt, ref, tmp),
                       args.reps)
    res["chain"] = rows
    res["chain_crossover"] = crossovers(rows, "bucket", "reads")
    print(table(rows, "bucket", "reads", CHAIN_READS, CHAIN_BUCKETS,
                "anchors (bucket)"))
    log(f"chain crossover (anchors) by reads: {res['chain_crossover']}")
    rows = ext_sweep(args.reps)
    res["ext"] = rows
    res["ext_crossover"] = crossovers(rows, "size", "jobs")
    for mode in ("extd2", "exts2"):
        print(f"{mode}:")
        print(table([r for r in rows if r["mode"] == mode], "size", "jobs",
                    EXT_WAVES, EXT_SIZES, "qlen + tlen"))
    log(f"extension crossover (bases) by wave: {res['ext_crossover']}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
