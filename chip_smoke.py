#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (minimap2_chaindp_tpu_torch) on one
NVIDIA GPU: the quickest proof that the port builds, is exact and runs its
main path on the card.

Phases, each printing its own lines:
  1. environment: the card (nvidia-smi name and power limit), nvcc, and the
     shared native host libraries (built from native/*.cc);
  2. build: csrc/*.cu with nvcc for sm_90a;
  3. kernels against their plain versions on the card, bit for bit
     (tolerance zero): the CUDA chain kernel and chain_scores_batch_ref on
     single-seg, many_segs, cdna and max_skip-flagged corpora; the ksw2
     forward and walk kernels and ksw_forward_ref / ksw_walk_ref on
     ksw_cases() (every ez column, every step code, fin (i, j, k)), whose
     last cases hold base code 4 (N, IUPAC) in queries and targets
     (ambiguous_ksw_cases); the splice-signal kernel and
     splice_signal_ref on splice_signal_waves() and a cDNA-sized wave;
  4. the fused flow end to end: a synthetic 250 Mbp genome (125 x 2 Mbp
     contigs, cached under build/smoke/), its index built once under
     map-ont with the CSR tables on the card, 1000 simulated 10 kb reads at
     10% error mapped by TorchRuntime on cuda and by HostRuntime: the SAM
     lines (-a, CIGAR on) must be byte-identical and the chain kernel must
     chain >= 90% of the reads. The kernel is then checked and timed again
     on the largest input the main path gave it;
  5. the staged path under -x splice: GENES gene loci patched into a copy
     of the genome, TRANSCRIPTS spliced reads from them; byte-identical to
     HostRuntime, >= 90% of extension jobs on the card, the chain kernel in
     cdna mode, spliced (N) alignments;
  6. the staged path for PAIRS read pairs under -x sr: byte-identical,
     extd2 and many_segs chain launches;
  7. the runtime's routings (models/runtime.py, models/steal.py) on the
     inputs of phases 4-6 at -t 3, each timed after a warm-up beside
     HostRuntime: phase 4's reads in batches of LANE_BATCH_READS under
     steal, share, host, device and device with the crossovers measured
     on the H100 (LANE_* below); phase 6's pairs under steal, share and
     device with seed collection on the card; phase 5's transcripts under
     device with the extension crossover. Byte-identical to HostRuntime, the
     stealing lane takes reads of phase 4, and the card collects the seeds
     of >= 90% of phase 6's staged units.
  8. the rest of the port: (a) the device index build (index/build_device.py)
     on the card over phase 4's genome against the native host build, both
     timed; (b) entry() on the card against the kernel's plain version; (c)
     TorchRuntime(mesh_shape=(1, 1)) on nccl over phase 4's reads, timed in
     turns with the device routing; (d) a 1 x 2 mesh with both ranks on
     cuda:0 over gloo over the same reads, the chain kernel held against
     its plain version on the largest input the mesh gave it, and every
     bucket's anchors and f/p/flag against the single-card flow step; (e)
     dryrun_multichip(2) on the card; (f) the host routing and HostRuntime
     timed in turns (ABAB, then BABA) on phase 7's batches at -t 3.
     Byte-identical to HostRuntime, >= 90% of the reads chained by the
     kernel on both meshes; at the phase's end no runtime of phases 4-8
     may still keep a -t pool thread or a mesh rank.
  9. retired: the port's bench, superseded by benchmark/run.py.
 10. the presets of the JAX package on a 50 Mbp genome, each
     through TorchRuntime on the card and HostRuntime at -t 3, byte-
     identical: sr single-end reads, map-pb reads and a cut of them under
     map10k, an all-vs-all set under ava-ont and ava-pb (PAF; a cut with
     -c), contigs under asm5, asm10 and asm20; every kernel wrapper's
     largest input of each run held against the plain version; then the
     option cases (OPTION_CASES, the list the CPU tests share) through
     the port's CLI in this process, --device cuda against --device host,
     each case's largest kernel inputs held against the plain versions
     too. The chain kernel must launch on the sr, map-pb and ava paths,
     the ksw2 kernels on the asm paths.
 11. the main path at genome scale: a 1 Gbp genome (P11_GENOME, 500 x 2
     Mbp, cut from a human genome's 3 Gbp for the time limit; made with
     its reads in a process of its own while phases 1-10 run, cached in
     build/smoke/), its index built with the minimizer pair sort on the
     card (build_index(device="cuda")), 1000 x 10 kb reads at 10%
     (P11_READS) in batches of
     LANE_BATCH_READS: HostRuntime, then TorchRuntime under the device
     routing (warmed by one batch) and under steal (cold: the index
     tables dropped from the cache, so that its flow uploads them on a
     thread of its own during the first batch), each byte-identical to
     HostRuntime; the seconds of the genome, the build and the upload,
     DeviceIndex.nbytes(), the card's peak memory, the anchors a read and
     their capacity buckets, the counters (the chain kernel's share,
     host_chain_oversized, fallback, steal_join_ms) and each run's
     largest kernel inputs held against the plain versions, the largest
     chain input's time and bound printed; the tables are freed before
     the phase ends.
 12. the inputs a human reference has: phase 4's genome masked (about
     half its bases lowercased in runs, N gaps at each contig's ends,
     inside it and short ones, IUPAC codes; utils/genome_synth) with
     phase 5's gene loci patched in, made with its reads in a process of
     its own during phases 5-11; its map-ont, sr and splice indexes built
     with the pair sort on the card; P12_READS 10 kb reads (some across
     the gaps' edges) with Ns, IUPAC codes and lowercase stretches under
     map-ont, P12_PAIRS pairs with about 0.5% N under -x sr, P12_TX
     transcripts with Ns under -x splice --MD; each under the device and
     steal routings at -t 3, byte-identical to HostRuntime, >= 90% of the
     map-ont reads chained by the kernel; each run's largest kernel
     inputs and its largest extension launch with a code-4 base held
     against the plain versions, at least one such launch required.
`plain_turns(parent)` runs main() with every ksw2 check also run through
the plain versions of another checkout, held equal to this tree's and
timed beside them (PERF.md §6).
`phase7_turns(parent)` is not run by main(): it holds the stealing
lane's repairs against another checkout of the repo (phase 7's steal runs
on phase 4's reads and phase 6's pairs, cold and warm, parent and this
tree in turns; PERF.md §5).
In phases 5 and 6 the chain kernel (on the largest input of each of its
modes) and the ksw2 kernels (on the largest launch) are checked and timed
again on the inputs the path gave them.
Each of phases 4-6, each run of phase 7, each path of phase 8 (entry(),
each timed run of the two meshes, the dry run) and each run and option
case of phase 10 and each run of phases 11 and 12 sets the launch
counters to 0 just before its run and reads them just after; the kernels
line counts phases 4, 5, 6, 8, 10, 11 and 12, with phase 10's to 12's
also apart (launches_phase10 ... launches_phase12) beside the checks of
their kept inputs (in checks_phase10 the option cases' as
opt_<case>; checks_phase11 by routing and mode; checks_phase12 by input
and routing, the code-4 launches as <input>_<routing>_code4). A mesh's other ranks
are processes of their own, but in a 1 x I mesh rank 0 runs every chain (the index-0
rank of a data row chains it, models/device_pipeline.py).
Before the last two lines, a JSON line {"timing": ...} gives each
phase's wall seconds (phase_s) and the seconds of the plain versions'
comparison runs by phase (plain_s: chain, ksw_forward, ksw_walk,
splice_signal) and
summed (plain_total_s).
The second-to-last line is the kernels' JSON record (ksw_splice_signal
replaces no TPU kernel: the JAX package packs the signal on the host; its
max_abs_err is 0, as every check of it is bit-exact or fails), the last line
{"ok": true, "device": {...}}. Any failure exits non-zero with no result.

Usage: python3 chip_smoke.py      (no arguments; the workload is fixed below)
"""
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(ROOT, "build", "smoke")
CHAIN_SOURCE = "minimap2_chaindp_tpu_torch/csrc/chain_dp.cu"
CHAIN_REPLACES = "minimap2_chaindp_tpu/ops/chain_pallas.py:116"
KSW_SOURCE = "minimap2_chaindp_tpu_torch/csrc/ksw2.cu"
KSW_REPLACES = "minimap2_chaindp_tpu/ops/ksw2_pallas.py:238"
WALK_REPLACES = "minimap2_chaindp_tpu/ops/ksw2_pallas.py:90"

# The card's peaks for the kernels' bounds: NVIDIA's H100 SXM data sheet
# gives 3.35 TB/s of device memory; the integer rate is 132 SMs x 64 INT32
# lanes x 1.98 GHz (the Hopper white paper's SM and the clock behind the
# sheet's 67 TFLOP/s of fp32: 132 x 128 x 2 x 1.98 GHz), one operation a
# lane a cycle.
HBM_BYTES_S = 3.35e12
INT32_OPS_S = 132 * 64 * 1.98e9
# Integer operations per unit of work: what the function needs, not what a
# kernel spends. A cell of the ksw2 recurrence on int8 lanes, as the
# reference's SIMD build does it (no sign extension: that is a cost of int8
# kept in int32 registers), in extd2 mode: the score of the base pair 6 (two
# compares with N, an or, a compare, two selects); a, b, a2, b2 4 sums; the
# five-way maximum with its origin 4 x (compare, select, maximum) = 12; the
# match clamp 1; u and v 2; z - q, z - q2 and the four continuation scores
# 6; each continuation (compare, select, subtract the gap open, select the
# flag, or it in) 4 x 5 = 20; the exact row H and its running maximum with
# its lane 4: 55. exts2 has no second insertion state (one sum, one way of
# the maximum, one score, one continuation: -10), no clamp (-1), and splits
# and adds the donor and acceptor signals (+3): 47. A job with the
# approximate maximum keeps no H row (-4); a score-only job keeps no origin
# and no flags (-16, exts2 -12). A walk step: the band of its row, the
# address, the state machine, i and j.
# A candidate pair (i, j) of the chaining recurrence, single-segment mode:
# dr, dq 2; dd = |dr - dq| 2; validity (j >= st, dr != 0, dq - 1 below the
# smaller distance bound unsigned: subtract and compare, dd <= bw, three
# ands) 8; min(dq, dr, span) 2; c_lin (to float, multiply, truncate, two
# exception compares and selects) 7; ilog2 (to float, maximum with 1, shift,
# subtract the bias) 4; the gap cost c_lin + (ilog2 >> 1) 2; score - cost 1;
# + f[j] 1; the running maximum with its j (compare, two selects) 3; the
# count of valid candidates above the best (count, snapshot select) 2: 34.
# The other modes test more: j >= st 1, same segment 1, same x high word 1,
# dr <= max_dist_x 1, same and dr == 0 2, dq <= 0 1, same and dq >
# max_dist_y 2, dq > max_dist_x 1, same and dd > bw 2, six ands: 18 in
# place of 8 (+10); many-segment mode also same and dr > max_dist_y and its
# and (+3). Both keep a second cost (dd >= 2048, min(c_lin, ilog2), select)
# 3, the score less it 1 and the score + 1 for dr == 0 across segments 1,
# and choose among the three: cdna (not same and dr == 0, dr > dq or not
# same, two selects) 6, many-segment (dr == 0, two selects) 3. cdna 34 +
# 10 + 5 + 6 = 55, many-segment 34 + 13 + 5 + 3 = 55. The count is of the
# recurrence, whatever kernel computes it, and does not change with the
# implementation; until it was itemised the bound took 40 in every mode.
KSW_OPS_PER_CELL = {False: 55, True: 47}      # extd2, exts2
KSW_OPS_H_ROW = 4
KSW_OPS_CIGAR = {False: 16, True: 12}
WALK_OPS_PER_STEP = 24
CHAIN_OPS_PER_PAIR = {"single": 34, "many_segs": 55, "cdna": 55}
# the chain kernel's throughput shape (phase 3), under map-ont's parameters
BENCH_READS, BENCH_ANCHORS = 8192, 1024

# the end-to-end workloads: one human chromosome's worth of reference,
# 1000 ONT-like reads (phase 4), 2000 spliced cDNA reads from gene loci
# patched into a copy of it (phase 5) and 5000 short read pairs (phase 6),
# mapped with -t 3 on both sides. A cut forced by the time limit is made
# here and recorded in PERF.md.
CONTIGS, CONTIG_LEN = 125, 2_000_000       # 250 Mbp
READS, READ_LEN = 1000, 10_000
THREADS = 3
GENES, TRANSCRIPTS, SPLICE_ERR = 1000, 2000, 0.05
EXONS, EXON_LEN, INTRON_LEN = (4, 11), (80, 301), (100, 8001)  # [lo, hi)
# every LONG_INTRON_EVERY-th gene has one intron of LONG_INTRON_LEN bp in
# place of one drawn from INTRON_LEN, so that phases 5 and 12 give the ksw2
# kernels spliced fills past 16384 target bases (the cdna cell's introns
# reach 30 kb, its fills 155 kb)
LONG_INTRON_EVERY, LONG_INTRON_LEN = 10, (16400, 40001)
PAIRS, PAIR_LEN, FRAG_LEN = 5000, 150, (250, 500)
# phase 7: phase 4's reads in batches of this many (so that the stream
# has batches after the first and the stealing lane pulls); the share of
# the flow under the "share" routing, with the JAX runtime's chain
# crossover, whose host lane (5 bases an anchor) takes 10 kb reads; and the
# crossovers measured on the H100 (`git show 1a3adb2:PERF.md`).
# The runtime's defaults stay at 0
LANE_BATCH_READS = 250
LANE_SHARE = 0.5
LANE_SHARE_CHAIN_MAX = 2048     # anchors
LANE_CHAIN_MAX = 1024           # anchors
LANE_EXT_MAX = 256              # bases of query plus target
# phase 8: the host routing and HostRuntime in turns, ABAB then BABA
HOST_GAP_ORDER = "ABABBABA"


class SmokeFailure(Exception):
    pass


# the phase running, each phase's wall seconds, and the seconds of the
# plain versions' comparison runs (compare_kernel's plain_ms, compare_ksw's
# plain_ms and walk_plain_ms) by phase: the timing line before the kernels
# line
TIMING = {"phase": "setup", "phase_s": {}, "plain_s": {}}


def run_phase(label, fn, *args):
    """fn(*args) as phase `label`, its wall seconds kept in TIMING."""
    TIMING["phase"] = label
    t = time.perf_counter()
    try:
        return fn(*args)
    finally:
        TIMING["phase_s"][label] = time.perf_counter() - t


def _plain_took(kind, ms):
    by = TIMING["plain_s"].setdefault(TIMING["phase"], {})
    by[kind] = by.get(kind, 0.0) + ms / 1e3


# the plain ksw2 versions (ops/ksw2_ext.py) of another checkout of the
# repo, which every ksw2 check also runs and holds against this tree's
# (set by plain_turns; None when the smoke runs as the script)
PLAIN_PARENT = None


def plain_turns(parent: str) -> int:
    """The smoke (main()) with every ksw2 check also run through the plain
    forward and walk of `parent`, another checkout of the repo, on the
    same card tensors right after this tree's: their p bytes, ez rows,
    step codes and fin (i, j, k) must be equal, and both times go into
    the timing line (ksw_forward_parent, ksw_walk_parent). The parent's
    module is loaded beside this tree's, its imports resolved in this
    tree's package."""
    global PLAIN_PARENT
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "minimap2_chaindp_tpu_torch.ops._parent_ksw2_ext",
        os.path.join(os.path.abspath(parent), "minimap2_chaindp_tpu_torch",
                     "ops", "ksw2_ext.py"))
    PLAIN_PARENT = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(PLAIN_PARENT)
    return main()


def timing_record(total_s):
    """The timing line: each phase's wall seconds, and the plain checks'
    seconds by phase and summed by kind and over this tree's kinds."""
    kinds = {}
    for by in TIMING["plain_s"].values():
        for kind, sec in by.items():
            kinds[kind] = kinds.get(kind, 0.0) + sec
    mine = sum(v for k, v in kinds.items() if not k.endswith("_parent"))
    return {"timing": {"total_s": total_s, "phase_s": TIMING["phase_s"],
                       "plain_s": TIMING["plain_s"],
                       "plain_total_s": dict(kinds, all=mine)}}


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------- phase 1
def phase_env():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip()
    print(card, flush=True)
    from minimap2_chaindp_tpu_torch.ops import _build
    nv = subprocess.run([_build.nvcc_path(), "--version"],
                        capture_output=True, text=True, timeout=60)
    log(f"phase 1 environment: torch {torch.__version__} cuda "
        f"{torch.version.cuda}; device {torch.cuda.get_device_name(0)} x"
        f"{torch.cuda.device_count()}; nvcc: "
        f"{nv.stdout.strip().splitlines()[-1] if nv.stdout else 'n/a'}")
    from minimap2_chaindp_tpu_torch import native
    t0 = time.perf_counter()
    ksw = native.load_ksw() is not None
    epi = native.available()
    log(f"phase 1 native host libraries: ksw2/align driver "
        f"{'loaded' if ksw else 'MISSING'}, chain epilogue "
        f"{'loaded' if epi else 'MISSING'} "
        f"({time.perf_counter() - t0:.1f} s incl. build)")
    check(ksw and epi, "native host libraries did not build or load")
    return card


# ---------------------------------------------------------------- phase 2
def phase_build():
    from minimap2_chaindp_tpu_torch.ops import _build
    t0 = time.perf_counter()
    info = _build.build()
    _build.load()
    dt = time.perf_counter() - t0
    log(f"phase 2 build: {' '.join(_build.NVCC_FLAGS)} -> {info['path']} "
        f"in {dt:.2f} s (nvcc {info['seconds']:.2f} s, "
        f"cached={info['cached']})")
    for line in info.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")
    return dt


# ---------------------------------------------------------------- phase 3
def _anchors(rng, n, *, read_len=3000, seg_split=None, big_gaps=False,
             noise=None):
    """Sorted (x, y) anchors: random windows (tests/test_chain_pallas.py
    style), optionally two segments, cdna-like big gaps, or a diagonal in
    dense off-diagonal noise (noise = fraction of noise anchors)."""
    if noise is not None:
        n_noise = int(n * noise)
        qp_d = np.sort(rng.choice(read_len, n - n_noise, replace=False))
        jit = 30 if noise else 1
        rp_d = qp_d + rng.integers(-jit + 1, jit, n - n_noise) + 100
        rp = np.maximum(np.concatenate(
            [rp_d, rng.integers(0, read_len + 200, n_noise)]), 0)
        qp = np.concatenate([qp_d, rng.integers(0, read_len, n_noise)])
        span = np.full(n, 15)
    else:
        rp = np.sort(rng.integers(0, 60000 if big_gaps else read_len, n))
        qp = np.maximum(rp // (30 if big_gaps else 1)
                        + rng.integers(-200, 200, n), 0)
        span = rng.integers(13, 20, n)
    y = span.astype(np.uint64) << np.uint64(32) | qp.astype(np.uint64)
    if seg_split is not None:
        y |= (np.arange(n) >= seg_split).astype(np.uint64) << np.uint64(48)
    a = np.stack([rp.astype(np.uint64), y], axis=1)
    return a[np.argsort(a[:, 0], kind="stable")]


def kernel_cases():
    """(name, numpy inputs, kwargs) for the listed kernel checks."""
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils.chain_corpus import pack_batch
    from minimap2_chaindp_tpu_torch.utils.synth import synth_batch
    _, ont = set_opt("map-ont")
    _, sr = set_opt("sr")
    _, spl = set_opt("splice")
    single = dict(max_dist_x=ont.max_gap, max_dist_y=ont.max_gap, bw=ont.bw,
                  max_skip=ont.max_chain_skip, is_cdna=False,
                  many_segs=False)
    cases = []
    for max_n, seed in ((1024, 1), (4096, 2)):
        arrs = pack_batch(synth_batch(64, max_n - 100, seed=seed), max_n,
                          single["max_dist_x"])
        cases.append((f"single R=64 max_n={max_n} exc=off", arrs,
                      dict(single, max_n=max_n, use_exc=False)))
        patched = [a.copy() for a in arrs]
        patched[-1][0::2, 0:4] = (3, 7, 11, 0)   # patches that bite
        cases.append((f"single R=64 max_n={max_n} exc=on", patched,
                      dict(single, max_n=max_n, use_exc=True)))
    rng = np.random.default_rng(4)
    batch = []
    for _ in range(16):
        n = int(rng.integers(200, 500))
        batch.append(_anchors(rng, n, seg_split=n // 2))
    cases.append(("many_segs R=16 max_n=512", pack_batch(batch, 512, 800),
                  dict(max_n=512, max_dist_x=800, max_dist_y=600, bw=sr.bw,
                       max_skip=sr.max_chain_skip, is_cdna=False,
                       many_segs=True, use_exc=True)))
    rng = np.random.default_rng(3)
    batch = [_anchors(rng, int(rng.integers(200, 500)), big_gaps=True)
             for _ in range(16)]
    cases.append(("is_cdna R=16 max_n=512", pack_batch(batch, 512, 200000),
                  dict(max_n=512, max_dist_x=200000, max_dist_y=2000,
                       bw=spl.bw, max_skip=spl.max_chain_skip, is_cdna=True,
                       many_segs=False, use_exc=True)))
    rng = np.random.default_rng(11)
    batch = [_anchors(rng, int(rng.integers(150, 500)),
                      noise=0.5 if r % 2 else 0.0) for r in range(16)]
    cases.append(("flagged R=16 max_n=512 max_skip=2",
                  pack_batch(batch, 512, single["max_dist_x"]),
                  dict(single, max_n=512, max_skip=2, use_exc=True)))
    # max_n beyond the largest bucket of the runtimes
    cases.append(("single R=8 max_n=9216 (past the largest bucket)",
                  pack_batch(synth_batch(8, 9000, seed=5), 9216,
                             single["max_dist_x"]),
                  dict(single, max_n=9216, use_exc=True)))
    return cases


def _time_ms(fn, reps: int, warm: bool = True) -> float:
    import torch
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _bound(n_bytes, n_ops):
    """(bound ms, what sets it): the larger of the bytes over the memory
    rate and the operations over the integer rate."""
    t_b, t_o = n_bytes / HBM_BYTES_S * 1e3, n_ops / INT32_OPS_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def chain_bound(ts, kw):
    """The chain kernel's bound on these inputs: every input read once, f,
    p and flag written once; one unit of work per candidate pair (j in
    [stw[i], i) for each anchor i < n: the kernel scores the whole
    window). Returns (bound ms, by, pairs, anchors of the longest read)."""
    import torch
    stw, nn = ts[5], ts[6][:, 0].long()
    max_n = stw.shape[1]
    i = torch.arange(max_n, device=stw.device)[None, :]
    live = i < nn[:, None]
    pairs = int(((i - stw.clamp(min=0)) * live).sum())
    n_bytes = sum(t.numel() * t.element_size() for t in ts) \
        + 2 * stw.numel() * 4 + ts[6].numel() * 4
    mode = "cdna" if kw["is_cdna"] else (
        "many_segs" if kw["many_segs"] else "single")
    ms, by = _bound(n_bytes, pairs * CHAIN_OPS_PER_PAIR[mode])
    return ms, by, pairs, int(nn.max())


def compare_kernel(name, ts, kw, reps=20, phase=3):
    """Kernel vs plain version on the same card tensors: bit-exact f, p and
    flag in the form the wrapper plans and in every form forced, then
    CUDA-event times (the planned launch and the forced forms in turns,
    `reps` rounds; the plain version on one run) and the bound on these
    inputs. Returns dict(err, ms, plain_ms, n_flag, bound_ms, bound_by,
    step_ns, form, variant_ms, anchors)."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    fn = TD.chain_scores_batch
    before = (fn.launches, dict(fn.by_form))
    got = fn(*ts, **kw)
    torch.cuda.synchronize()
    planned = [f for f in TD.FORMS if fn.by_form[f] == before[1][f] + 1]
    check(fn.launches == before[0] + 1 and len(planned) == 1,
          f"{name}: the launch counters did not move with the launch")
    want, plain_ms = _timed(lambda: TD.chain_scores_batch_ref(*ts, **kw))
    _plain_took("chain", plain_ms)

    def same(out, what):
        err = max(int((g.long() - w.long()).abs().max())
                  for g, w in zip(out, want))
        for label, g, w in zip(("f", "p", "flag"), out, want):
            check(g.shape == w.shape and torch.equal(g, w),
                  f"{name}: kernel {label} ({what}) differs from the plain "
                  f"version (max abs err {err})")
        return err

    def forced(form):
        fn.force = form
        try:
            return fn(*ts, **kw)
        finally:
            fn.force = None
    err = same(got, "as planned")
    runs = {"planned": lambda: fn(*ts, **kw)}
    for form in TD.FORMS:
        err = max(err, same(forced(form), f"{form} forced"))
        runs[form] = lambda form=form: forced(form)
    variant_ms = _in_turns(runs, reps)
    ms = variant_ms.pop("planned")
    n_flag = int(got[2][:, 0].sum())
    bound_ms, by, pairs, longest = chain_bound(ts, kw)
    anchors = int(ts[6][:, 0].sum())
    step_ns = ms * 1e6 / max(longest, 1)
    log(f"phase {phase} {name}: bit-exact (f, p, flag; {n_flag} flagged) as "
        f"planned ({planned[0]}) and forced {sorted(variant_ms)}; kernel "
        f"{ms:.3f} ms (plain {plain_ms:.1f} ms; forced, in turns with it, "
        + ", ".join(f"{v} {t:.3f}" for v, t in variant_ms.items())
        + f" ms); bound {bound_ms:.4f} ms by {by} ({pairs} candidate pairs "
        f"of {anchors} anchors), share {bound_ms / ms:.1%}; longest read "
        f"{longest} anchors, {step_ns:.1f} ns per anchor")
    return dict(err=err, ms=ms, plain_ms=plain_ms, n_flag=n_flag,
                bound_ms=bound_ms, bound_by=by, step_ns=step_ns,
                form=planned[0], variant_ms=variant_ms, anchors=anchors)


def _mutate_codes(rng, seq, sub=0.08, ind=0.04):
    """Substitutions and 1-11 bp insertions/deletions on base codes (the
    corpus style of tests/test_ksw2_pallas.py)."""
    out = []
    for c in seq:
        r = rng.random()
        if r < sub:
            out.append(int(rng.integers(0, 4)))
        elif r < sub + ind / 2:
            pass
        elif r < sub + ind:
            out.append(int(c))
            out.extend(rng.integers(0, 4, int(rng.integers(1, 12))).tolist())
        else:
            out.append(int(c))
    return np.array(out or [0], dtype=np.uint8)


def _ext_jobs(rng, n, tlen_rng, ws=(25, 100, 751), zdrops=(100, 400)):
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    flags = (0, K.KSW_EZ_APPROX_MAX, K.KSW_EZ_EXTZ_ONLY,
             K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT,
             K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR,
             K.KSW_EZ_APPROX_MAX | K.KSW_EZ_APPROX_DROP)
    jobs = []
    for _ in range(n):
        t = rng.integers(0, 4, int(rng.integers(*tlen_rng))).astype(np.uint8)
        flag = int(rng.choice(flags))
        eb = int(rng.choice([-1, 10])) if flag & K.KSW_EZ_EXTZ_ONLY else -1
        jobs.append(dict(qseq=_mutate_codes(rng, t), tseq=t,
                         w=int(rng.choice(ws)), zdrop=int(rng.choice(zdrops)),
                         end_bonus=eb, flag=flag))
    return jobs


def _spliced_job(rng, flag, n_exons, exon=60, intron=120, err=0.05,
                 n_at=None):
    """A cDNA/genome pair with GT..AG introns (the corpus style of
    tests/test_ksw2_splice_pallas.py). `n_at` puts code 4 (N) on the
    genome at every intron's "donor" G, its "acceptor" G, or inside each
    "intron" and "exon"."""
    genome, cdna = [], []
    for i in range(n_exons):
        ex = rng.integers(0, 4, exon + int(rng.integers(0, exon // 2))).tolist()
        if n_at == "exon":
            ex[int(rng.integers(0, len(ex)))] = 4
        genome.extend(ex)
        cdna.extend(c for c in ex if rng.random() > err * 0.5)
        if i != n_exons - 1:
            ilen = intron + int(rng.integers(0, intron // 2))
            body = rng.integers(0, 4, ilen - 4).tolist()
            if n_at == "intron":
                body[len(body) // 2] = 4
            genome.extend([4 if n_at == "donor" else 2, 3] + body
                          + [0, 4 if n_at == "acceptor" else 2])
    return dict(qseq=np.array(cdna, dtype=np.uint8),
                tseq=np.array(genome, dtype=np.uint8),
                zdrop=int(rng.choice([200, 400])), end_bonus=-1, flag=flag,
                w=-1)


def _put_n(rng, seq, single=0.02, runs=1, run_len=(3, 20)):
    """A copy of base codes `seq` with code 4 (an N, or an IUPAC code as
    seq_nt4_table reads it) at about `single` of its bases and `runs`
    runs of 4."""
    out = seq.copy()
    out[rng.random(len(out)) < single] = 4
    for _ in range(runs):
        n = min(int(rng.integers(*run_len)), len(out))
        p = int(rng.integers(0, len(out) - n + 1))
        out[p:p + n] = 4
    return out


def ambiguous_ksw_cases(max_len=300, n_ext=18, n_flags=4):
    """(name, jobs, scoring, splice) whose sequences hold code 4: single
    Ns and N runs in the query, the target or both on n_ext extd2 jobs of
    ksw_cases' kind (targets of 20 to max_len bases) under map-ont and sr;
    an N run inserted where it puts the path on the band's edge; all-N
    queries and targets; spliced jobs (n_flags splice flags) with N at
    every intron's donor or acceptor G, inside its introns and in its
    exons. A few hundred bases a job at most, so that the plain versions
    stay quick on the CPU (the Pallas kernel in interpret mode takes about
    10 ms a row a job there: its tests take max_len 60)."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.options import set_opt

    def gaps(preset, splice=False):
        _, o = set_opt(preset)
        return (o.q, o.e, o.q2, o.noncan if splice else o.e2, o.a, o.b)
    cases = []
    for seed, preset in ((11, "map-ont"), (12, "sr")):
        rng = np.random.default_rng(seed)
        jobs = _ext_jobs(rng, n_ext, (20, max_len))
        for i, j in enumerate(jobs):
            if i % 3 != 1:
                j["qseq"] = _put_n(rng, j["qseq"])
            if i % 3 != 0:
                j["tseq"] = _put_n(rng, j["tseq"])
        half = max_len // 3
        for w in (10, 25):
            # an N run of w - 2 bases inserted into the query: the path
            # runs along the band's edge over the Ns
            t = rng.integers(0, 4, 2 * half).astype(np.uint8)
            q = np.concatenate([t[:half], np.full(w - 2, 4, np.uint8),
                                t[half:]])
            jobs.append(dict(qseq=q, tseq=t, w=w, zdrop=400, end_bonus=-1,
                             flag=0))
            # the Ns on the target, the path on the other edge
            jobs.append(dict(qseq=t.copy(), tseq=q, w=w, zdrop=400,
                             end_bonus=-1, flag=K.KSW_EZ_RIGHT))
        for ql, tl in ((max_len // 8, max_len // 5), (1, 30)):
            jobs.append(dict(qseq=np.full(ql, 4, np.uint8),
                             tseq=rng.integers(0, 4, tl).astype(np.uint8),
                             w=-1, zdrop=-1, end_bonus=0, flag=0))
            jobs.append(dict(qseq=rng.integers(0, 4, tl).astype(np.uint8),
                             tseq=np.full(ql + 5, 4, np.uint8), w=-1,
                             zdrop=100, end_bonus=-1,
                             flag=K.KSW_EZ_EXTZ_ONLY))
        cases.append((f"extd2 {preset} with N", jobs, gaps(preset), False))
    rng = np.random.default_rng(13)
    sflags = (K.KSW_EZ_SPLICE_FOR,
              K.KSW_EZ_SPLICE_REV,
              K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_FLANK,
              K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_RIGHT)[:n_flags]
    jobs = [_spliced_job(rng, f, int(rng.integers(2, 4)), exon=max_len // 5,
                         intron=2 * max_len // 5, n_at=where)
            for where in ("donor", "acceptor", "intron", "exon")
            for f in sflags]
    for j in jobs[::3]:
        j["qseq"] = _put_n(rng, j["qseq"], runs=0)
    cases.append(("exts2 with N at donors, acceptors, introns, exons", jobs,
                  gaps("splice", splice=True), True))
    return cases


def splice_signal_waves(seed=0):
    """(name, jobs, noncan) of mixed exts2 waves for the splice-signal
    kernel, under noncan 0, 9 and 15: each target of 1 to 40 bases, at a
    multiple of 16 and one either side (47 to 129), GT/AG-rich of 3000
    bases (with code 4), under every splice flag set (none, FOR, REV, both,
    each with and without FLANK, and FLANK alone), beside RIGHT,
    score-only, extz-only, reversed-CIGAR and approximate-maximum jobs."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    rng = np.random.default_rng(seed)
    F, R, L = K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_REV, \
        K.KSW_EZ_SPLICE_FLANK
    flags = [s | fl for s in (0, F, R, F | R) for fl in (0, L)]
    other = (0, K.KSW_EZ_RIGHT, K.KSW_EZ_SCORE_ONLY,
             K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_REV_CIGAR, K.KSW_EZ_APPROX_MAX)
    lens = list(range(1, 41)) + [16 * k + d for k in range(3, 9)
                                 for d in (-1, 0, 1)]
    targets = [rng.integers(0, 4, n).astype(np.uint8) for n in lens]
    targets += [rng.choice(np.arange(5, dtype=np.uint8), 3000,
                           p=[0.3, 0.18, 0.3, 0.18, 0.04]) for _ in range(3)]
    waves = []
    for noncan in (0, 9, 15):
        jobs = [dict(qseq=rng.integers(0, 4, int(rng.integers(1, 60)))
                     .astype(np.uint8), tseq=t, zdrop=200, end_bonus=-1,
                     w=-1, flag=f | other[(i + k) % len(other)])
                for i, t in enumerate(targets) for k, f in enumerate(flags)]
        waves.append((f"signal wave, noncan {noncan}", jobs, noncan))
    return waves


def splice_signal_cdna_wave(seed=0, n_jobs=2400):
    """(name, jobs, noncan): an exts2 wave of cDNA size (2400 jobs,
    targets log-normal about 860 bases, up to 16384, GT/AG-rich), every
    job under FOR|REV, as -x splice gives them."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    rng = np.random.default_rng(seed)
    lens = np.clip(rng.lognormal(6.5, 0.9, n_jobs), 1, 16384).astype(int)
    lens[:4] = (16384, 16383, 16369, 1)
    jobs = [dict(qseq=rng.integers(0, 4, int(rng.integers(50, 400)))
                 .astype(np.uint8),
                 tseq=rng.choice(np.arange(4, dtype=np.uint8), int(n),
                                 p=[0.3, 0.2, 0.3, 0.2]),
                 zdrop=200, end_bonus=-1, w=-1,
                 flag=K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV)
            for n in lens]
    return f"cdna-sized signal wave, {n_jobs} jobs", jobs, 9


# target lengths at and past the old limits of the shared-memory forward's
# scan key (a lane index below 2^15) and of the executor (16384 bases a
# side), up to the longest spliced fill the cdna cell gave (155 kb)
LONG_TARGETS = (16385, 32767, 32768, 32769, 65536, 155_000)


def _long_spliced_job(rng, tlen, flag, n_introns=1, junk=0, zdrop=200):
    """A spliced job whose target has `tlen` bases: exons of 100-199
    bases around `n_introns` introns of equal share of the rest, GT..AG
    (CT..AC where `flag` has the reverse signal alone), the query those
    exons at 5% error followed by `junk` unrelated bases (where z-drop
    fires)."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    rev = flag & K.KSW_EZ_SPLICE_REV and not flag & K.KSW_EZ_SPLICE_FOR
    exons = [rng.integers(0, 4, int(rng.integers(100, 200))).astype(np.uint8)
             for _ in range(n_introns + 1)]
    left = tlen - sum(map(len, exons))
    cuts = [left * i // n_introns for i in range(n_introns + 1)]
    genome = [exons[0]]
    for i in range(n_introns):
        intron = rng.integers(0, 4, cuts[i + 1] - cuts[i]).astype(np.uint8)
        intron[:2] = (1, 3) if rev else (2, 3)       # CT or GT
        intron[-2:] = (0, 1) if rev else (0, 2)      # AC or AG
        genome += [intron, exons[i + 1]]
    query = [_mutate_codes(rng, ex, 0.04, 0.01) for ex in exons]
    query.append(rng.integers(0, 4, junk).astype(np.uint8))
    return dict(qseq=np.concatenate(query).astype(np.uint8),
                tseq=np.concatenate(genome).astype(np.uint8), zdrop=zdrop,
                end_bonus=-1, flag=flag, w=-1)


def long_splice_wave(seed=0):
    """(name, jobs, noncan): an exts2 wave of 24 short spliced jobs and
    one job for each of LONG_TARGETS, GT..AG or CT..AC introns under the
    forward, the reverse and both splice flags in turn (two introns past
    60 kb), and one z-dropped job over 32769 bases (400 unrelated bases
    end its query)."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    rng = np.random.default_rng(seed)
    F, R = K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_REV
    jobs = [_spliced_job(rng, F | R, int(rng.integers(2, 5)))
            for _ in range(24)]
    for k, tlen in enumerate(LONG_TARGETS):
        jobs.append(_long_spliced_job(rng, tlen, (F, R, F | R)[k % 3],
                                      n_introns=1 + (tlen > 60000)))
    jobs.append(_long_spliced_job(rng, 32769, F, junk=400, zdrop=100))
    return "long-target spliced wave", jobs, 9


def long_extd2_jobs(seed=0):
    """Twelve short extd2 jobs and two banded ones whose targets pass 2^15
    bases (40000 at w 500, 70000 at w 200): the query the target at 5%
    substitutions with a 7-base deletion and, 10 kb on, a 7-base
    insertion, so that the alignment stays inside the band to the end."""
    rng = np.random.default_rng(seed)
    jobs = _ext_jobs(rng, 12, (50, 400))
    for tlen, w in ((40000, 500), (70000, 200)):
        t = rng.integers(0, 4, tlen).astype(np.uint8)
        q = _mutate_codes(rng, t, 0.05, 0.0)
        q = np.concatenate([q[:20000], q[20007:30000],
                            rng.integers(0, 4, 7), q[30000:]])
        jobs.append(dict(qseq=q.astype(np.uint8), tseq=t, w=w, zdrop=400,
                         end_bonus=-1, flag=0))
    return jobs


def compare_splice_signal(name, jobs, noncan, reps=11, phase=3):
    """The splice-signal kernel against its plain version
    (ksw2_pack.donor_acceptor job by job): bit-exact; its CUDA-event time
    and bound. Returns dict(ms, plain_ms, bound_ms, bound_by, jobs,
    positions)."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    pk = KPK.pack_jobs(jobs, splice=True, noncan=noncan)
    ts = KE.device_inputs(pk, "cuda", splice=True)
    sig = lambda: KE.splice_signal(ts["tseq"], ts["meta"],
                                   t_total=pk["t_total"], noncan=noncan)
    want, plain_ms = _timed(lambda: KE.splice_signal_ref(
        ts["tseq"], ts["meta"], t_total=pk["t_total"], noncan=noncan))
    _plain_took("splice_signal", plain_ms)
    check(torch.equal(ts["dac"], want), f"{name}: the splice signal "
          "kernel differs from the plain version")
    ms = _time_ms(sig, reps)
    # each target base read once, two bytes written a position of its slot
    n_bytes = sum(len(j["tseq"]) for j in jobs) + 2 * pk["t_total"]
    bound_ms = n_bytes / HBM_BYTES_S * 1e3
    log(f"phase {phase} {name}: {len(jobs)} jobs, {pk['t_total']} target "
        f"positions, bit-exact against the plain version; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms by "
        f"hbm ({n_bytes} B), share {bound_ms / ms:.1%}")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="hbm",
                jobs=len(jobs), positions=pk["t_total"])


def ksw_cases():
    """(name, jobs, scoring, splice) for the ksw kernel checks; scoring is
    (q, e, q2, e2 or noncan, a, b) from the presets. The last cases are
    ambiguous_ksw_cases()."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.options import set_opt

    def gaps(preset, splice=False):
        _, o = set_opt(preset)
        return (o.q, o.e, o.q2, o.noncan if splice else o.e2, o.a, o.b)
    ont = gaps("map-ont")
    cases = []
    for seed, preset in enumerate(("map-ont", "sr", "asm5")):
        cases.append((f"extd2 {preset} 24 jobs", _ext_jobs(
            np.random.default_rng(seed), 24, (20, 300)), gaps(preset), False))
    rng = np.random.default_rng(3)
    cases.append(("extd2 mixed sizes", _ext_jobs(rng, 8, (10, 60))
                  + _ext_jobs(rng, 8, (300, 600)), ont, False))
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(4):   # unrelated sequences: z-drop fires early
        jobs.append(dict(qseq=rng.integers(0, 4, 380).astype(np.uint8),
                         tseq=rng.integers(0, 4, 400).astype(np.uint8),
                         w=100, zdrop=100, end_bonus=-1,
                         flag=K.KSW_EZ_EXTZ_ONLY))
    for tlen in (135, 200, 16, 17):   # width-1 bands, unbanded
        jobs.append(dict(qseq=rng.integers(0, 4, 1).astype(np.uint8),
                         tseq=rng.integers(0, 4, tlen).astype(np.uint8),
                         w=-1, zdrop=-1, end_bonus=0, flag=0))
    t = rng.integers(0, 4, 200).astype(np.uint8)   # long gaps: 30I and 30D
    ins = rng.integers(0, 4, 30).astype(np.uint8)
    jobs.append(dict(qseq=np.concatenate([t[:90], ins, t[90:150], t[180:]]),
                     tseq=t, w=80, zdrop=400, end_bonus=-1, flag=0))
    cases.append(("extd2 z-drop, width-1 bands, long gaps", jobs, ont, False))
    spl = gaps("splice", splice=True)
    sflags = (K.KSW_EZ_SPLICE_FOR,
              K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_FLANK,
              K.KSW_EZ_SPLICE_REV,
              K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_RIGHT,
              K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_APPROX_MAX,
              K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_REV_CIGAR)
    rng = np.random.default_rng(7)
    jobs = [_spliced_job(rng, f, int(rng.integers(2, 5)))
            for f in sflags for _ in range(4)]
    jobs.append(dict(qseq=rng.integers(0, 4, 280).astype(np.uint8),
                     tseq=rng.integers(0, 4, 300).astype(np.uint8),
                     zdrop=100, end_bonus=-1, flag=K.KSW_EZ_SPLICE_FOR, w=-1))
    cases.append(("exts2 every splice flag", jobs, spl, True))
    # ONT-like end extensions: 64 jobs of about 10 kb at w=500
    rng = np.random.default_rng(9)
    jobs = []
    for i in range(64):
        t = rng.integers(0, 4, 10_000).astype(np.uint8)
        flag = K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT
        if i % 2:
            flag |= K.KSW_EZ_REV_CIGAR
        jobs.append(dict(qseq=_mutate_codes(rng, t, 0.06, 0.04), tseq=t,
                         w=500, zdrop=400, end_bonus=-1, flag=flag))
    cases.append(("extd2 64 x 10 kb w=500", jobs, ont, False))
    # code 4 (N, IUPAC) in queries and targets: the score of N
    return cases + ambiguous_ksw_cases()


def ksw_inputs(jobs, scoring, splice, device):
    """pack_jobs' arrays as tensors on `device` plus the forward wrapper's
    keywords (the launch groups of ksw2_pack.launch_plan among them)."""
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    q, e, q2, e2n, a, b = scoring
    gaps = KPK.gap_params(q, e, q2, 0 if splice else e2n, splice)
    mat = K.gen_simple_mat(5, a, b)
    return packed_ksw_inputs(
        jobs, KE.forward_scoring(mat, gaps, splice=splice), splice,
        e2n if splice else 0, device)


def packed_ksw_inputs(jobs, fwd_scoring, splice, noncan, device):
    """ksw_inputs for jobs whose forward wrapper's `scoring` is known (as
    utils/kernel_inputs.py keeps it). On a card the splice signal comes
    from its kernel, checked here against the plain version."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    pk = KPK.pack_jobs(jobs, splice=splice, noncan=noncan)
    ts = KE.device_inputs(pk, device, splice=splice)
    if splice and ts["meta"].device.type == "cuda":
        want = KE.splice_signal_ref(ts["tseq"], ts["meta"],
                                    t_total=pk["t_total"], noncan=noncan)
        check(torch.equal(ts["dac"], want), f"the splice signal kernel "
              f"differs from the plain version on {len(jobs)} jobs")
    kw = dict(groups=pk["groups"], scoring=tuple(fwd_scoring),
              splice=splice, p_bytes=pk["p_bytes"], t_total=pk["t_total"],
              band_max=pk["band_max"], rows_max=pk["rows_max"])
    return pk, ts, kw


def _timed(fn):
    """fn() once between CUDA events: (result, ms)."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def ksw_bounds(pk, ez_h, splice):
    """The forward and walk kernels' bounds on these inputs. Forward work:
    the cells of the live band [st0, en0] of every row a job computes (all
    its rows, or the rows up to its maximum where it z-dropped: the least
    it can have computed), each at the operations its job's mode needs;
    bytes: every input once, one backtrack byte per cell of a job with a
    CIGAR, the ez rows. Walk: one byte of p in and one code out per step.
    Returns ((fwd ms, by, cells), (walk ms, by, steps), steps of the
    longest walk)."""
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    meta = pk["meta"]
    cells = n_ops = p_out = 0
    for j in range(len(meta)):
        ql, tl, w = (int(meta[j, c]) for c in
                     (KPK.M_QLEN, KPK.M_TLEN, KPK.M_W))
        rows = ql + tl - 1
        if ez_h[j, KPK.C_ZDROP]:
            rows = min(rows, max(int(ez_h[j, KPK.C_MAX_T])
                                 + int(ez_h[j, KPK.C_MAX_Q]) + 1, 1))
        r = np.arange(rows, dtype=np.int64)
        st0 = np.maximum(0, r - ql + 1)
        en0 = np.minimum(tl - 1, r)
        if not splice:
            st0 = np.maximum(st0, (r - w + 1) >> 1)
            en0 = np.minimum(en0, (r + w) >> 1)
        n = int(np.maximum(en0 - st0 + 1, 0).sum())
        per_cell = KSW_OPS_PER_CELL[splice]
        if meta[j, KPK.M_APPROX]:
            per_cell -= KSW_OPS_H_ROW
        if meta[j, KPK.M_NCOL]:
            p_out += n
        else:
            per_cell -= KSW_OPS_CIGAR[splice]
        cells += n
        n_ops += n * per_cell
    # the uploaded arrays, and the splice signal the forward reads
    n_in = sum(pk[k].nbytes for k in ("tseq", "qrev", "meta", "poff",
                                      "order")) + (2 * pk["t_total"]
                                                   if splice else 0)
    fwd = _bound(n_in + p_out + ez_h.nbytes, n_ops)
    steps = ez_h[:, KPK.C_FIN_K].astype(np.int64)
    walk = _bound(2 * int(steps.sum()) + meta.nbytes + ez_h.nbytes,
                  int(steps.sum()) * WALK_OPS_PER_STEP)
    return fwd + (cells,), walk + (int(steps.sum()),), int(steps.max())


def compare_ksw_native(name, jobs, scoring, splice, reps=5, phase=3):
    """The ksw2 batch call on the card against the native host library
    (the reference's SIMD build): every Ez field and CIGAR equal; then the
    forward kernel as planned and the walk kernel timed with CUDA events
    beside their bounds. For launches whose longest job has too many rows
    for the plain versions' comparison (about a millisecond a row on the
    card). Returns the card's results, a K.Ez a job."""
    from minimap2_chaindp_tpu_torch import native
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    q, e, q2, e2n, a, b = scoring
    mat = K.gen_simple_mat(5, a, b)
    batch, host = ((KE.exts2_batch, native.exts2_batch_native) if splice
                   else (KE.extd2_batch, native.extd2_batch_native))
    got = batch(jobs, mat, q, e, q2, e2n, device="cuda")
    want = host(jobs, mat, q, e, q2, e2n)
    check(want is not None, f"{name}: the native host library is missing")
    key = lambda g: (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe,
                     g.mqe_t, g.mte, g.mte_q, g.reach_end, list(g.cigar))
    n_diff = sum(key(x) != key(y) for x, y in zip(got, want))
    check(n_diff == 0, f"{name}: {n_diff} jobs' Ez or CIGAR differ from "
          "the native host library")
    pk, ts, kw = ksw_inputs(jobs, scoring, splice, "cuda")
    args = [ts[k] for k in KE.FORWARD_KEYS]
    wkw = dict(splice=splice, ops_total=pk["ops_total"])
    p, ez = KE.ksw_forward(*args, **kw)
    ez_w = ez.clone()
    KE.ksw_walk(p, ts["poff"], ts["meta"], ts["order"], ez_w, **wkw)
    ms = _time_ms(lambda: KE.ksw_forward(*args, **kw), reps)
    walk_ms = _time_ms(lambda: KE.ksw_walk(
        p, ts["poff"], ts["meta"], ts["order"], ez.clone(), **wkw), reps)
    (b_ms, b_by, cells), (wb_ms, wb_by, n_steps), longest = ksw_bounds(
        pk, ez_w.cpu().numpy(), splice)
    rows = pk["rows_max"]
    log(f"phase {phase} ksw {name}: {len(jobs)} jobs in launches "
        f"{[(g['variant'], g['ring'], g['threads'], g['count']) for g in kw['groups']]}"
        f", equal to the native host library (Ez, CIGAR); forward "
        f"{ms:.3f} ms, bound {b_ms:.4f} ms by {b_by} ({cells} live cells), "
        f"share {b_ms / ms:.1%}, longest job {rows} rows, "
        f"{ms * 1e6 / rows:.1f} ns per row; walk {walk_ms:.3f} ms, bound "
        f"{wb_ms:.5f} ms by {wb_by} ({n_steps} steps), share "
        f"{wb_ms / walk_ms:.1%}, longest walk {longest} steps, "
        f"{walk_ms * 1e6 / longest:.1f} ns per step")
    return got


def _check_walk(name, pk, ez_w, ops, ez_wr, ops_ref):
    """Walk outputs against the plain version's: fin (i, j, k) and every
    step code. Returns the worst difference (0)."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    fin = slice(KPK.C_FIN_I, KPK.C_FIN_K + 1)
    err = int((ez_w[:, fin].long() - ez_wr[:, fin].long()).abs().max())
    check(torch.equal(ez_w, ez_wr), f"{name}: walk fin (i, j, k) differs "
          f"from the plain version (max abs err {err})")
    ops_h, ops_rh = ops.cpu().numpy(), ops_ref.cpu().numpy()
    ez_h = ez_w.cpu().numpy()
    for j, o in enumerate(pk["meta"][:, KPK.M_OPOFF]):
        k = int(ez_h[j, KPK.C_FIN_K])
        a, b = ops_h[o:o + k].astype(int), ops_rh[o:o + k].astype(int)
        if not (a == b).all():
            check(False, f"{name}: job {j} walk step codes differ from the "
                  f"plain version (max abs err {int(abs(a - b).max())})")
    return err


def _in_turns(fns, rounds):
    """Every callable of `fns` (name -> callable) once a round, in turn,
    for `rounds` rounds after a warm-up round, each call between CUDA
    events of its own: {name: median ms}. Versions timed this way share
    whatever else the card and the host do during the run."""
    import statistics
    for fn in fns.values():
        fn()
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            times[name].append(_timed(fn)[1])
    return {name: statistics.median(t) for name, t in times.items()}


def compare_ksw(name, pk, ts, kw, reps=5, phase=3):
    """The ksw forward kernel (as the wrapper plans its launches, and then
    every variant that holds all these jobs, forced) and the walk kernel
    against their plain versions on the same card tensors: bit-exact ez
    rows, step codes and fin (i, j, k); CUDA-event times (the planned
    launches and the forced variants in turns, `reps` rounds, 11 where a
    call takes under 5 ms; the plain versions on their one comparison run)
    and the bounds. Returns a dict: err, ms, plain_ms, walk_ms,
    walk_plain_ms, variant_ms, bound_ms, bound_by, step_ns, walk_bound_ms,
    walk_bound_by, walk_step_ns."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    args = [ts[k] for k in KE.FORWARD_KEYS]
    wkw = dict(splice=kw["splice"], ops_total=pk["ops_total"])
    planned = [g["variant"] for g in kw["groups"]]
    before = (dict(KE.ksw_forward.by_variant), KE.ksw_walk.launches)
    p, ez = KE.ksw_forward(*args, **kw)
    ez_w = ez.clone()
    ops = KE.ksw_walk(p, ts["poff"], ts["meta"], ts["order"], ez_w, **wkw)
    torch.cuda.synchronize()
    check(all(KE.ksw_forward.by_variant[v] == before[0][v]
              + planned.count(v) for v in KPK.VARIANTS)
          and KE.ksw_walk.launches == before[1] + 1,
          f"{name}: the launch counters did not move with the launches")
    (p_ref, ez_ref), plain_ms = _timed(
        lambda: KE.ksw_forward_ref(*args[:5], **{
            k: v for k, v in kw.items() if k != "groups"}))
    ez_wr = ez.clone()
    ops_ref, walk_plain = _timed(lambda: KE.ksw_walk_ref(
        p, ts["poff"], ts["meta"], ez_wr, **wkw))
    _plain_took("ksw_forward", plain_ms)
    _plain_took("ksw_walk", walk_plain)
    if PLAIN_PARENT is not None:
        PK = PLAIN_PARENT
        # a parent may read the signal in extd2 too: a zero one there
        par_args = [torch.zeros(pk["t_total"], dtype=torch.int16,
                                device=ts["meta"].device)
                    if a is None else a for a in args[:5]]
        (p_par, ez_par), par_ms = _timed(lambda: PK.ksw_forward_ref(
            *par_args, **{k: v for k, v in kw.items() if k != "groups"}))
        ez_parw = ez.clone()
        ops_par, par_walk = _timed(lambda: PK.ksw_walk_ref(
            p, ts["poff"], ts["meta"], ez_parw, **wkw))
        check(torch.equal(p_par, p_ref) and torch.equal(ez_par, ez_ref)
              and torch.equal(ez_parw, ez_wr)
              and torch.equal(ops_par, ops_ref),
              f"{name}: the plain versions of {PK.__file__} and of this "
              "tree differ")
        _plain_took("ksw_forward_parent", par_ms)
        _plain_took("ksw_walk_parent", par_walk)
        log(f"phase {phase} ksw {name}: plain forward {plain_ms:.1f} ms, "
            f"walk {walk_plain:.1f} ms; {PK.__file__}'s {par_ms:.1f} and "
            f"{par_walk:.1f} ms, equal p, ez, step codes and fin")
    err = int((ez.long() - ez_ref.long()).abs().max())
    check(torch.equal(ez, ez_ref), f"{name}: kernel ez rows differ from "
          f"the plain version (max abs err {err})")
    err = max(err, _check_walk(name, pk, ez_w, ops, ez_wr, ops_ref))
    walk_ms = _time_ms(lambda: KE.ksw_walk(
        p, ts["poff"], ts["meta"], ts["order"], ez.clone(), **wkw), reps)
    # every variant that can hold the whole launch, forced
    runs = {"planned": lambda: KE.ksw_forward(*args, **kw)}
    for v in KPK.VARIANTS:
        try:
            order, groups = KPK.launch_plan(pk["meta"], force=v)
        except ValueError:
            continue      # a job's rows do not fit this variant
        order_t = torch.from_numpy(order).to(ts["meta"].device)
        fkw = dict(kw, groups=groups)
        n0 = KE.ksw_forward.by_variant[v]
        p_v, ez_v = KE.ksw_forward(*args[:5], order_t, **fkw)
        ez_vw = ez_v.clone()
        ops_v = KE.ksw_walk(p_v, ts["poff"], ts["meta"], ts["order"], ez_vw,
                            **wkw)
        torch.cuda.synchronize()
        check(KE.ksw_forward.by_variant[v] == n0 + 1,
              f"{name}: the {v} variant's counter did not move")
        e_v = int((ez_v.long() - ez_ref.long()).abs().max())
        check(torch.equal(ez_v, ez_ref), f"{name}: the {v} variant's ez "
              f"rows differ from the plain version (max abs err {e_v})")
        err = max(err, e_v,
                  _check_walk(f"{name} [{v}]", pk, ez_vw, ops_v, ez_wr,
                              ops_ref))
        runs[v] = (lambda o=order_t, k=fkw:
                   KE.ksw_forward(*args[:5], o, **k))
        del p_v
    quick = _timed(runs["planned"])[1] < 5
    variant_ms = _in_turns(runs, 11 if quick and reps >= 3 else reps)
    ms = variant_ms.pop("planned")
    ez_h = ez_w.cpu().numpy()
    (b_ms, b_by, cells), (wb_ms, wb_by, n_steps), longest = ksw_bounds(
        pk, ez_h, kw["splice"])
    step_ns = ms * 1e6 / max(pk["rows_max"], 1)
    walk_step_ns = walk_ms * 1e6 / max(longest, 1)
    log(f"phase {phase} ksw {name}: {len(pk['meta'])} jobs in launches "
        f"{[(g['variant'], g['ring'], g['threads'], g['count']) for g in kw['groups']]}"
        f", bit-exact (ez, step codes, fin) as planned and forced "
        f"{sorted(variant_ms)}; forward {ms:.3f} ms (plain {plain_ms:.1f} "
        f"ms; forced, in turns with it, " + ", ".join(
            f"{v} {t:.3f}" for v, t in variant_ms.items())
        + f" ms), bound {b_ms:.4f} ms by {b_by} ({cells} live cells), "
        f"share {b_ms / ms:.1%}, longest job {pk['rows_max']} rows, "
        f"{step_ns:.1f} ns per row; walk {walk_ms:.3f} ms (plain "
        f"{walk_plain:.1f} ms), bound {wb_ms:.5f} ms by {wb_by} ({n_steps} "
        f"steps), share {wb_ms / walk_ms:.1%}, longest walk {longest} "
        f"steps, {walk_step_ns:.1f} ns per step; "
        f"{pk['p_bytes']} p bytes, band {kw['band_max']}")
    return dict(err=err, ms=ms, plain_ms=plain_ms, walk_ms=walk_ms,
                walk_plain_ms=walk_plain, variant_ms=variant_ms,
                bound_ms=b_ms, bound_by=b_by, step_ns=step_ns,
                walk_bound_ms=wb_ms, walk_bound_by=wb_by,
                walk_step_ns=walk_step_ns)


def phase_kernels():
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    worst, flagged = 0, 0
    for name, arrs, kw in kernel_cases():
        ts = [torch.from_numpy(a).cuda() for a in arrs]
        res = compare_kernel(name, ts, kw)
        worst = max(worst, res["err"])
        if "flagged" in name:
            flagged = res["n_flag"]
    check(flagged > 0, "the flagged corpus flagged no read")
    # the boundary corpus (sizes, exact windows, ties, the skip count at
    # max_skip and one over, exception patches; a window past one stage)
    from minimap2_chaindp_tpu_torch.utils.chain_corpus import (
        boundary_cases, pack_batch)
    for case in boundary_cases(wide_n=3000):
        ts = [torch.from_numpy(a).cuda() for a in case["arrays"]]
        res = compare_kernel("boundary " + case["name"], ts, case["kw"],
                             reps=3)
        worst = max(worst, res["err"])
        if "flagged" in case:
            check((res["n_flag"] > 0) == case["flagged"], "boundary "
                  f"{case['name']}: {res['n_flag']} reads flagged")
    # the throughput shape: BENCH_READS x BENCH_ANCHORS under map-ont
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils.synth import synth_batch
    _, ont = set_opt("map-ont")
    ts = [torch.from_numpy(a).cuda() for a in pack_batch(
        synth_batch(BENCH_READS, BENCH_ANCHORS, seed=0), BENCH_ANCHORS,
        ont.max_gap)]
    bench = compare_kernel(
        f"throughput shape R={BENCH_READS} max_n={BENCH_ANCHORS}", ts,
        dict(max_n=BENCH_ANCHORS, max_dist_x=ont.max_gap,
             max_dist_y=ont.max_gap, bw=ont.bw, max_skip=ont.max_chain_skip,
             is_cdna=False, many_segs=False, use_exc=True), reps=5)
    log(f"phase 3 throughput shape: {bench['anchors'] / bench['ms'] / 1e3:.1f}"
        f" M anchors/s in the {bench['form']} form")
    worst = max(worst, bench["err"])
    del ts
    forced = set()
    for name, jobs, scoring, splice in ksw_cases():
        pk, ts, kw = ksw_inputs(jobs, scoring, splice, "cuda")
        res = compare_ksw(name, pk, ts, kw)
        worst = max(worst, res["err"])
        forced |= set(res["variant_ms"])
    check(forced == set(KPK.VARIANTS), "phase 3 did not launch every "
          f"forward variant: {sorted(forced)}")
    # targets past 16384 and 32768 bases, against the native host library
    _, o = set_opt("splice")
    name, jobs, noncan = long_splice_wave()
    compare_ksw_native(name, jobs, (o.q, o.e, o.q2, noncan, o.a, o.b), True)
    _, o = set_opt("map-ont")
    compare_ksw_native("long-target extd2 jobs", long_extd2_jobs(),
                       (o.q, o.e, o.q2, o.e2, o.a, o.b), False)
    # the signal kernel; the cDNA-sized wave, last, is its record
    for name, jobs, noncan in [*splice_signal_waves(),
                               splice_signal_cdna_wave()]:
        sig = compare_splice_signal(name, jobs, noncan)
    return worst, bench, sig


# ---------------------------------------------------------------- phase 4
def _reset_launches():
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    TD.chain_scores_batch.launches = 0
    TD.chain_scores_batch.by_form = dict.fromkeys(TD.FORMS, 0)
    KE.ksw_forward.launches = KE.ksw_walk.launches = 0
    KE.splice_signal.launches = 0
    KE.ksw_forward.by_variant = dict.fromkeys(KE.ksw_forward.by_variant, 0)


def _read_launches():
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    return dict(chain=TD.chain_scores_batch.launches,
                ksw=KE.ksw_forward.launches, walk=KE.ksw_walk.launches,
                signal=KE.splice_signal.launches)


def _cached(path, make, *more):
    """Make `path` (and the companion files `more`) unless they exist:
    make() writes temporary names that are renamed when it returns."""
    paths = (path, *more)
    if not all(os.path.exists(p) for p in paths):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmps = [f"{p}.{os.getpid()}.tmp" for p in paths]
        make(*tmps)
        for tmp, p in zip(tmps, paths):
            os.replace(tmp, p)
    return path


def phase_e2e():
    import torch
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    from minimap2_chaindp_tpu_torch.models import device_flow as DF
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD

    t0 = time.perf_counter()
    mbp = CONTIGS * CONTIG_LEN / 1e6
    ref = _cached(os.path.join(
        SMOKE_DIR, f"genome_{CONTIGS}x{CONTIG_LEN}_s42.fa"),
        lambda p: G.make_genome(p, n_contigs=CONTIGS,
                                contig_len=CONTIG_LEN, seed=42))
    reads = _cached(os.path.join(
        SMOKE_DIR, f"reads_{READS}x{READ_LEN}_s5.fa"),
        lambda p: G.simulate(ref, p, READS, READ_LEN, 0.10,
                             seed=5))
    log(f"phase 4 inputs: {mbp:.0f} Mbp genome, {READS} x "
        f"{READ_LEN} bp reads at 10% error "
        f"({time.perf_counter() - t0:.1f} s)")

    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR          # -a
    t0 = time.perf_counter()
    names, seqs = [], []
    for r in read_fastx(ref):
        names.append(r.name)
        seqs.append(C.seq_to_nt4(r.seq))
    mi = build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                     n_threads=os.cpu_count() or 1)
    del names, seqs
    mo.update(mi)
    log(f"phase 4 index: {len(mi.keys)} keys, {len(mi.values)} positions, "
        f"mid_occ {mo.mid_occ} ({time.perf_counter() - t0:.1f} s)")
    batches = list(read_frags([reads], mo.mini_batch_size, False))
    frags = [f for b in batches for f in b]
    n_reads = len(frags)
    warm = frags[:16]

    host = HostRuntime(mi, mo, n_threads=THREADS)
    host.map_batch(warm)
    t0 = time.perf_counter()
    host_lines = [ls for b in host.map_stream(batches) for ls in b]
    t_host = time.perf_counter() - t0
    host.close()

    t0 = time.perf_counter()
    warm_rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS)
    warm_rt.map_batch(warm)       # uploads the index, warms the allocator
    torch.cuda.synchronize()
    warm_rt.close()
    t_up = time.perf_counter() - t0
    dx = DF.device_index_cached(mi, "cuda")
    rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS)

    # keep the largest chain input the main path launches, to check and
    # time the kernel on it afterwards
    biggest = {}
    real = DF.chain_scores_batch

    def record(*a, **kw):
        size = a[1].numel()
        if size > biggest.get("size", 0):
            biggest.update(size=size, args=a, kw=dict(kw))
        return real(*a, **kw)

    DF.chain_scores_batch = record
    TD.chain_scores_batch.launches = 0
    TD.chain_scores_batch.by_form = dict.fromkeys(TD.FORMS, 0)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        port_lines = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    finally:
        DF.chain_scores_batch = real
    launches = TD.chain_scores_batch.launches
    by_form = dict(TD.chain_scores_batch.by_form)
    peak = torch.cuda.max_memory_allocated()
    rt.close()

    c = rt.timers.counters
    check(len(port_lines) == len(host_lines) == n_reads,
          "line lists do not cover every read")
    check(all(ls and all(len(ln.split("\t")) >= 11 for ln in ls)
              for ls in port_lines), "a read has no SAM record")
    n_diff = sum(a != b for a, b in zip(port_lines, host_lines))
    check(n_diff == 0, f"{n_diff} reads' SAM lines differ from HostRuntime")
    log(f"phase 4 SAM: {sum(map(len, port_lines))} records for {n_reads} "
        "reads, byte-identical to HostRuntime")
    log(f"phase 4 reads/s: port (cuda) {n_reads / t_port:.1f} "
        f"({t_port:.2f} s), host {n_reads / t_host:.1f} ({t_host:.2f} s), "
        f"-t {THREADS}")
    log(f"phase 4 counters: device_reads={c['device_reads']} "
        f"fallback={c['fallback']} native_finish={c['native_finish']} "
        f"staged_frags={c['staged_frags']} chain kernel launches="
        f"{launches} {by_form}")
    log(f"phase 4 port stages (host wall clock): {rt.timers.summary()}")
    log(f"phase 4 device memory: index tables {dx.nbytes()} B "
        f"(upload + warm-up {t_up:.1f} s), max_memory_allocated {peak} B")
    check(launches > 0, "the main path launched no chain kernel")
    check(c["device_reads"] >= 0.9 * n_reads,
          f"only {c['device_reads']} of {n_reads} reads chained on the card")
    res = compare_kernel(
        "main-path input R={} max_n={}".format(
            biggest["args"][1].shape[0], biggest["kw"]["max_n"]),
        biggest["args"], biggest["kw"], reps=11, phase=4)
    return dict(res, launches=launches, by_form=by_form, ref=ref, mi=mi,
                mo=mo, reads=reads, batches=batches, host_lines=host_lines,
                rate=n_reads / t_port)


# ------------------------------------------------------------- phases 5, 6
def _mutate(rng, s: str, err: float) -> str:
    """ONT/cDNA-like errors at rate `err`: 55% substitutions, 25%
    deletions, 20% insertions (tools/genome_scale.simulate's mix)."""
    b = np.frombuffer(s.encode(), dtype=np.uint8)
    r = rng.random(len(b))
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    sub = r < err * 0.55
    keep = ~((r >= err * 0.55) & (r < err * 0.8))
    ins = (r >= err * 0.8) & (r < err)
    out = b.copy()
    out[sub] = acgt[rng.integers(0, 4, int(sub.sum()))]
    rep = np.where(ins, 2, 1) * keep
    res = np.repeat(out, rep)
    # the second copy of each inserted base becomes a random base
    ins_at = np.cumsum(rep)[ins & keep] - 1
    res[ins_at] = acgt[rng.integers(0, 4, len(ins_at))]
    return res.tobytes().decode()


def _write_spliced(ref, out_ref, out_reads, seed=7, genes=GENES,
                   transcripts=TRANSCRIPTS, intron_len=INTRON_LEN,
                   long_every=LONG_INTRON_EVERY):
    """A copy of `ref` with `genes` gene loci patched in (EXONS exons of
    EXON_LEN bp, intron_len bp introns with GT..AG at their edges, one of
    them LONG_INTRON_LEN bp in every `long_every`-th gene) and
    `transcripts` cDNA reads from them (each gene's full transcript and one
    that skips an internal exon) at SPLICE_ERR error, half reverse
    complemented (case, N and IUPAC codes complemented as the reference
    does). The tools/diff_sweep.py:86-120 idea at genome scale."""
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.utils.genome_synth import COMP
    rng = np.random.default_rng(seed)
    recs = [(r.name, bytearray(r.seq.encode())) for r in read_fastx(ref)]
    per = -(-genes // len(recs))
    loci = []
    for g in range(genes):
        ci = g % len(recs)
        seq = recs[ci][1]
        slot = len(seq) // per
        n_ex = int(rng.integers(*EXONS))
        exl = rng.integers(*EXON_LEN, n_ex)
        inl = rng.integers(*intron_len, n_ex - 1)
        if g % long_every == long_every - 1:
            inl[int(rng.integers(0, n_ex - 1))] = rng.integers(
                *LONG_INTRON_LEN)
        pos = (g // len(recs)) * slot + int(
            rng.integers(0, slot - int(exl.sum() + inl.sum())))
        exons = []
        for i in range(n_ex):
            exons.append((pos, pos + int(exl[i])))
            pos += int(exl[i])
            if i < n_ex - 1:
                il = int(inl[i])
                seq[pos:pos + 2] = b"GT"
                seq[pos + il - 2:pos + il] = b"AG"
                pos += il
        loci.append((ci, exons))
    with open(out_ref, "w") as f:
        for name, seq in recs:
            f.write(f">{name}\n")
            for i in range(0, len(seq), 80):
                f.write(seq[i:i + 80].decode() + "\n")
    with open(out_reads, "w") as f:
        for t in range(transcripts):
            ci, exons = loci[t % genes]
            if t >= genes:   # the second transcript skips an internal exon
                drop = int(rng.integers(1, len(exons) - 1))
                exons = exons[:drop] + exons[drop + 1:]
            seq = recs[ci][1]
            s = _mutate(rng, b"".join(seq[a:b] for a, b in exons).decode(),
                        SPLICE_ERR)
            if rng.random() < 0.5:
                s = s[::-1].translate(COMP)
            f.write(f">tx{t}!{recs[ci][0]}!{exons[0][0]}\n{s}\n")


def _write_pairs(ref, out1, out2, seed=11):
    """PAIRS read pairs of PAIR_LEN bp in FR orientation from fragments of
    FRAG_LEN bp, at 1% substitutions and indels."""
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.utils.genome_synth import COMP
    rng = np.random.default_rng(seed)
    recs = [(r.name, r.seq) for r in read_fastx(ref)]
    with open(out1, "w") as f1, open(out2, "w") as f2:
        for i in range(PAIRS):
            name, seq = recs[int(rng.integers(0, len(recs)))]
            fl = int(rng.integers(*FRAG_LEN))
            st = int(rng.integers(0, len(seq) - fl))
            fr = seq[st:st + fl]
            r1 = _mutate(rng, fr[:PAIR_LEN], 0.01)
            r2 = _mutate(rng, fr[-PAIR_LEN:], 0.01)[::-1].translate(COMP)
            f1.write(f">pr{i}!{name}!{st}\n{r1}\n")
            f2.write(f">pr{i}!{name}!{st}\n{r2}\n")


def _index(ref, preset):
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.options import set_opt
    io, mo = set_opt(preset)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR          # -a
    names, seqs = [], []
    for r in read_fastx(ref):
        names.append(r.name)
        seqs.append(C.seq_to_nt4(r.seq))
    mi = build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                     n_threads=os.cpu_count() or 1)
    mo.update(mi)
    return mi, mo


def _staged_run(phase, mi, mo, batches):
    """HostRuntime and then TorchRuntime on cuda over the same batches,
    the port's kernel counters zeroed just before its run and read just
    after. Returns (host lines, port lines, runtime, record) where record
    holds the launch counts, the chain kernel's modes and the largest
    input of each, the largest ksw launch input, the times and the peak
    device memory."""
    import torch
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models import runtime as RT
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    frags = [f for b in batches for f in b]
    warm = frags[:16]
    host = HostRuntime(mi, mo, n_threads=THREADS)
    host.map_batch(warm)
    t0 = time.perf_counter()
    host_lines = [ls for b in host.map_stream(batches) for ls in b]
    t_host = time.perf_counter() - t0
    host.close()
    warm_rt = RT.TorchRuntime(mi, mo, device="cuda", n_threads=THREADS)
    warm_rt.map_batch(warm)
    torch.cuda.synchronize()
    warm_rt.close()
    rt = RT.TorchRuntime(mi, mo, device="cuda", n_threads=THREADS)
    rec = dict(modes={}, chain_in={}, biggest=None, cells=-1,
               planned=set())
    real_chain, real_pack = RT.chain_scores_batch, KE.pack_jobs

    def chain(*a, **kw):
        key = "cdna" if kw["is_cdna"] else (
            "many_segs" if kw["many_segs"] else "single")
        rec["modes"][key] = rec["modes"].get(key, 0) + 1
        size = a[1].numel()
        if size > rec["chain_in"].get(key, (0,))[0]:
            rec["chain_in"][key] = (size, a, dict(kw))
        return real_chain(*a, **kw)

    def pack(jobs, *, splice, noncan=0):
        pk = real_pack(jobs, splice=splice, noncan=noncan)
        cells = int((pk["meta"][:, 0].astype(np.int64)
                     * pk["meta"][:, 1]).sum())
        if cells > rec["cells"]:
            rec.update(cells=cells, biggest=(jobs, splice))
        rec["planned"] |= {g["variant"] for g in pk["groups"]}
        return pk
    RT.chain_scores_batch, KE.pack_jobs = chain, pack
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        port_lines = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    finally:
        RT.chain_scores_batch, KE.pack_jobs = real_chain, real_pack
    rt.close()
    rec.update(chain=TD.chain_scores_batch.launches,
               chain_by_form=dict(TD.chain_scores_batch.by_form),
               ksw=KE.ksw_forward.launches, walk=KE.ksw_walk.launches,
               signal=KE.splice_signal.launches,
               by_variant=dict(KE.ksw_forward.by_variant),
               peak=torch.cuda.max_memory_allocated(), t_host=t_host,
               t_port=t_port)
    n = len(frags)
    check(len(port_lines) == len(host_lines) == n,
          f"phase {phase}: line lists do not cover every fragment")
    n_diff = sum(a != b for a, b in zip(port_lines, host_lines))
    check(n_diff == 0, f"phase {phase}: {n_diff} fragments' SAM lines "
          "differ from HostRuntime")
    ex = rt.align_exec
    n_jobs = ex.n_device + ex.n_native + ex.n_host
    log(f"phase {phase} SAM: {sum(map(len, port_lines))} records for {n} "
        "fragments, byte-identical to HostRuntime")
    log(f"phase {phase} reads/s: port (cuda) {n / t_port:.1f} "
        f"({t_port:.2f} s), host {n / t_host:.1f} ({t_host:.2f} s), "
        f"-t {THREADS} (fragments/s)")
    log(f"phase {phase} extension jobs: {ex.n_device} on the card "
        f"({ex.n_long_device} with a side past 16384 bases), "
        f"{ex.n_native} native, {ex.n_host} numpy model; ksw forward "
        f"launches {rec['ksw']} {rec['by_variant']}, walk launches "
        f"{rec['walk']}, splice signal launches {rec['signal']} (p budget "
        f"{KE.P_BUDGET} B per launch); chain kernel launches "
        f"{rec['chain']} {rec['modes']} {rec['chain_by_form']}")
    log(f"phase {phase} port stages (host wall clock): "
        f"{rt.timers.summary()}")
    log(f"phase {phase} device memory: max_memory_allocated {rec['peak']} B")
    check(rec["ksw"] > 0 and rec["walk"] > 0,
          f"phase {phase}: the ksw kernels were not launched")
    check((rec["signal"] > 0) == bool(mo.flag & C.MM_F_SPLICE),
          f"phase {phase}: {rec['signal']} splice signal launches")
    for v in sorted(rec["planned"]):
        check(rec["by_variant"][v] > 0, f"phase {phase}: the waves held "
              f"jobs for the {v} forward variant, which never launched")
    rec.update(jobs=n_jobs, jobs_device=ex.n_device,
               jobs_long_device=ex.n_long_device, mi=mi, mo=mo,
               batches=batches, host_lines=host_lines)
    return host_lines, port_lines, rt, rec


def _main_path_kernels(phase, rec, scoring):
    """Check and time the chain kernel on the largest input of each mode
    the path ran, and the ksw kernels on the largest launch the path
    made. Returns rec with the chain's worst error, compare_kernel's
    numbers by mode (chain_res) and compare_ksw's numbers."""
    chain_err, chain_res = 0, {}
    for mode, (_size, args, kw) in sorted(rec["chain_in"].items()):
        chain_res[mode] = compare_kernel(
            f"main-path {mode} input R={args[1].shape[0]} "
            f"max_n={kw['max_n']}", args, kw, reps=11, phase=phase)
        chain_err = max(chain_err, chain_res[mode]["err"])
    jobs, splice = rec["biggest"]
    pk, ts, kw = ksw_inputs(jobs, scoring, splice, "cuda")
    n_long = sum(max(len(j["qseq"]), len(j["tseq"])) > 16384 for j in jobs)
    res = compare_ksw(f"main-path input ({len(jobs)} jobs, {n_long} with "
                      "a side past 16384 bases)", pk, ts, kw, reps=3,
                      phase=phase)
    return dict(rec, **res, chain_err=chain_err, chain_res=chain_res)


def phase_splice(ref):
    t0 = time.perf_counter()
    sref = os.path.join(SMOKE_DIR, f"genome_{CONTIGS}x{CONTIG_LEN}_s42"
                        f"_genes{GENES}_s7.fa")
    reads = os.path.join(SMOKE_DIR, f"transcripts_{TRANSCRIPTS}_s7.fa")
    _cached(sref, lambda p, q: _write_spliced(ref, p, q), reads)
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    mi, mo = _index(sref, "splice")
    log(f"phase 5 inputs: {GENES} gene loci patched into the genome, "
        f"{TRANSCRIPTS} transcripts at {SPLICE_ERR:.0%} error; splice "
        f"index {len(mi.keys)} keys ({time.perf_counter() - t0:.1f} s)")
    batches = list(read_frags([reads], mo.mini_batch_size, False))
    _host, port, _rt, rec = _staged_run(5, mi, mo, batches)
    check(rec["jobs"] and rec["jobs_device"] >= 0.9 * rec["jobs"],
          f"phase 5: only {rec['jobs_device']} of {rec['jobs']} extension "
          "jobs ran on the card")
    check(rec["jobs_long_device"] > 0, "phase 5: no extension job past "
          "16384 bases ran on the card")
    check(rec["modes"].get("cdna", 0) > 0,
          "phase 5: the chain kernel never ran in cdna mode")
    n_spliced = sum(1 for ls in port for ln in ls
                    if "N" in ln.split("\t")[5])
    log(f"phase 5: {n_spliced} alignments carry an N operation")
    check(n_spliced > 0, "phase 5: no spliced (N) alignment")
    return _main_path_kernels(
        5, rec, (mo.q, mo.e, mo.q2, mo.noncan, mo.a, mo.b))


def phase_paired(ref):
    t0 = time.perf_counter()
    r1 = os.path.join(SMOKE_DIR, f"pairs_{PAIRS}_s11_1.fa")
    r2 = os.path.join(SMOKE_DIR, f"pairs_{PAIRS}_s11_2.fa")
    _cached(r1, lambda p, q: _write_pairs(ref, p, q), r2)
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    mi, mo = _index(ref, "sr")
    log(f"phase 6 inputs: {PAIRS} pairs of 2 x {PAIR_LEN} bp; sr index "
        f"{len(mi.keys)} keys ({time.perf_counter() - t0:.1f} s)")
    batches = list(read_frags([r1, r2], mo.mini_batch_size, True))
    check(all(len(f.segs) == 2 for b in batches for f in b),
          "phase 6: the inputs did not pair up")
    _host, _port, _rt, rec = _staged_run(6, mi, mo, batches)
    check(rec["modes"].get("many_segs", 0) > 0,
          "phase 6: the chain kernel never ran in many_segs mode")
    return _main_path_kernels(
        6, rec, (mo.q, mo.e, mo.q2, mo.e2, mo.a, mo.b))


# ---------------------------------------------------------------- phase 7
LANE_COUNTERS = ("steal_device_reads", "steal_chunks", "steal_paused",
                 "steal_dev_fallback", "steal_join_ms", "fast_native",
                 "native_finish", "staged_frags", "host_chain",
                 "device_seed", "host_seed", "ext_device", "ext_native")


def _lane_run(label, mi, mo, batches, host_lines, t_host, **kw):
    """One routing over `batches` at -t THREADS: a warm-up batch, then the
    counters (the runtime's and the kernels' launches) set to 0, the timed
    map_stream and the counters read. Checks the lines against
    HostRuntime's. Returns a dict of the run's numbers."""
    import torch
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    frags = [f for b in batches for f in b]
    rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS, **kw)
    rt.map_batch(frags[:16])
    torch.cuda.synchronize()
    for d in (rt.timers.acc, rt.timers.n, rt.timers.counters):
        d.clear()
    ex = rt.align_exec
    ex.n_device = ex.n_native = ex.n_host = 0
    _reset_launches()
    t0 = time.perf_counter()
    lines = [ls for b in rt.map_stream(batches) for ls in b]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rt.close()
    launches = _read_launches()
    n_diff = sum(a != b for a, b in zip(lines, host_lines))
    check(len(lines) == len(host_lines) and n_diff == 0,
          f"phase 7 {label}: {n_diff} fragments' SAM lines differ from "
          "HostRuntime")
    c = dict(rt.timers.counters)
    n = len(frags)
    cpu = {k: v for k, v in sorted(c.items()) if k.startswith("steal_cpu")}
    log(f"phase 7 {label} ({rt.describe()}): byte-identical; "
        f"{n / dt:.1f} fragments/s ({dt:.2f} s) against HostRuntime "
        f"{n / t_host:.1f} (-t {THREADS}); "
        + " ".join(f"{k}={c.get(k, 0)}" for k in LANE_COUNTERS)
        + f"; launches chain {launches['chain']}, ksw2 {launches['ksw']}, "
        f"walk {launches['walk']}, signal {launches['signal']}; lane CPU "
        f"{cpu}")
    log(f"phase 7 {label} stages (host wall clock): {rt.timers.summary()}")
    return dict(label=label, rate=n / dt, host_rate=n / t_host, seconds=dt,
                counters=c, launches=launches)


def phase_lanes(e2e, spl, pe):
    import copy
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    runs = []
    # phase 4's reads in batches of LANE_BATCH_READS
    mo = copy.copy(e2e["mo"])
    mo.mini_batch_size = LANE_BATCH_READS * READ_LEN
    batches = list(read_frags([e2e["reads"]], mo.mini_batch_size, False))
    mi = e2e["mi"]
    host = HostRuntime(mi, mo, n_threads=THREADS)
    host.map_batch(batches[0][:16])
    t0 = time.perf_counter()
    host_lines = [ls for b in host.map_stream(batches) for ls in b]
    t_host = time.perf_counter() - t0
    host.close()
    log(f"phase 7 inputs: phase 4's {len(host_lines)} reads in "
        f"{len(batches)} batches of {[len(b) for b in batches]} reads")
    lane = dict(mi=mi, mo=mo, batches=batches, host_lines=host_lines,
                t_host=t_host)
    runs.append(_lane_run("phase 4 steal", routing="steal", **lane))
    check(runs[-1]["counters"].get("steal_device_reads", 0) > 0,
          "phase 7: the stealing lane took no read of phase 4")
    runs.append(_lane_run(f"phase 4 share {LANE_SHARE}", routing="share",
                          flow_share=LANE_SHARE,
                          native_chain_max=LANE_SHARE_CHAIN_MAX, **lane))
    runs.append(_lane_run("phase 4 host", routing="host", **lane))
    runs.append(_lane_run("phase 4 device", **lane))
    runs.append(_lane_run("phase 4 device crossovers",
                          native_chain_max=LANE_CHAIN_MAX,
                          native_ext_max=LANE_EXT_MAX, **lane))
    # phase 6's pairs and phase 5's transcripts, in their own batches
    pairs = dict(mi=pe["mi"], mo=pe["mo"], batches=pe["batches"],
                 host_lines=pe["host_lines"], t_host=pe["t_host"])
    runs.append(_lane_run("phase 6 steal", routing="steal", **pairs))
    runs.append(_lane_run(f"phase 6 share {LANE_SHARE}", routing="share",
                          flow_share=LANE_SHARE,
                          native_chain_max=LANE_SHARE_CHAIN_MAX, **pairs))
    runs.append(_lane_run("phase 6 device seeds", device_seeds=True,
                          **pairs))
    c = runs[-1]["counters"]
    n_dev, n_host = c.get("device_seed", 0), c.get("host_seed", 0)
    check(n_dev + n_host > 0 and n_dev >= 0.9 * (n_dev + n_host),
          f"phase 7: the card collected the seeds of {n_dev} of "
          f"{n_dev + n_host} staged units of phase 6")
    tx = dict(mi=spl["mi"], mo=spl["mo"], batches=spl["batches"],
              host_lines=spl["host_lines"], t_host=spl["t_host"])
    runs.append(_lane_run("phase 5 device ext crossover",
                          native_ext_max=LANE_EXT_MAX, **tx))
    return runs


# ---------------------------------------------------------------- phase 8
def _sketch_genome(ref, io):
    """Phase 4's genome's minimizers, sketched by the native library on
    all cores in contig chunks (as index/build.py does)."""
    from concurrent.futures import ThreadPoolExecutor
    from minimap2_chaindp_tpu_torch.constants import seq_to_nt4
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.native import sketch_batch_cat_native
    seqs = [seq_to_nt4(r.seq) for r in read_fastx(ref)]
    n = len(seqs)
    nch = min(os.cpu_count() or 1, n)
    cuts = [round(i * n / nch) for i in range(nch + 1)]

    def chunk(i):
        part = seqs[cuts[i]:cuts[i + 1]]
        offs = np.concatenate([[0], np.cumsum([len(s) for s in part])])
        return sketch_batch_cat_native(
            np.concatenate(part), offs.astype(np.int64),
            np.arange(cuts[i], cuts[i + 1]), io.w, io.k, bool(io.flag & 1))
    with ThreadPoolExecutor(nch) as ex:
        return [m for part in ex.map(chunk, range(nch)) for m in part
                if len(m)]


def _phase8_index(e2e):
    """(a): the device pair sort against the native one, on the same
    minimizers, each timed with its copies (H2D and D2H included)."""
    import torch
    from minimap2_chaindp_tpu_torch.index.build_device import \
        build_csr_device
    from minimap2_chaindp_tpu_torch.native import build_csr_native
    from minimap2_chaindp_tpu_torch.options import set_opt
    io, _mo = set_opt("map-ont")
    t0 = time.perf_counter()
    mvs = _sketch_genome(e2e["ref"], io)
    t_sk = time.perf_counter() - t0
    mi = e2e["mi"]
    times = {"host": [], "cuda": []}
    for who in ("cuda", "host", "host", "cuda"):     # in turns
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        csr = build_csr_device(mvs, "cuda") if who == "cuda" \
            else build_csr_native(mvs)
        times[who].append(time.perf_counter() - t0)
        for a, b, what in zip(csr, (mi.keys, mi.starts, mi.values),
                              ("keys", "starts", "values")):
            check(a.dtype == b.dtype and np.array_equal(a, b),
                  f"phase 8 index: the {who} build's {what} differ from "
                  "phase 4's index")
        del csr
    n_pairs = sum(len(m) for m in mvs)
    log(f"phase 8 (a) index build: {n_pairs} minimizer pairs, "
        f"{len(mi.keys)} keys (sketch {t_sk:.2f} s); pair sort + run starts "
        f"on cuda {', '.join(f'{t:.3f}' for t in times['cuda'])} s "
        "(upload and read-back included), native host "
        f"{', '.join(f'{t:.3f}' for t in times['host'])} s; keys, starts "
        "and values equal the host's")
    return dict(pairs=n_pairs, cuda_s=times["cuda"], host_s=times["host"])


def _chain_counts(fn):
    """Run `fn` with the chain wrapper's counts set to 0 just before it;
    returns (fn's result, its launches, by form), read just after."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    TD.chain_scores_batch.launches = 0
    TD.chain_scores_batch.by_form = dict.fromkeys(TD.FORMS, 0)
    out = fn()
    torch.cuda.synchronize()
    return (out, TD.chain_scores_batch.launches,
            dict(TD.chain_scores_batch.by_form))


def _phase8_entry():
    """(b): entry() on the card, f against the plain version. Returns the
    launches and by form of entry()'s call."""
    from minimap2_chaindp_tpu_torch.entry import CHAIN_KW, entry
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    fn, args = entry()
    f, launches, by_form = _chain_counts(lambda: fn(*args))
    check(launches == 1 and f.is_cuda,
          "phase 8 entry() did not launch the chain kernel")
    want = TD.chain_scores_batch_ref(*args, max_n=f.shape[1], **CHAIN_KW)[0]
    err = int((f.long() - want.long()).abs().max())
    check(err == 0, f"phase 8 entry(): f differs from the plain version "
          f"by {err}")
    log(f"phase 8 (b) entry(): f {tuple(f.shape)} on {f.device} from the "
        "CUDA kernel, equal to chain_scores_batch_ref")
    return launches, by_form


def check_mesh_bucket(mi, single, q, kw, out) -> int:
    """One bucket of a mesh flow (the arrays `q`, arguments `kw` and
    outputs `out` of its DeviceFlow._launch) against the single-device
    flow `single` on the same reads, their CSR key positions looked up in
    `mi`: each read's anchors and f/p over its n anchors, and its flag,
    must be equal. Returns the reads checked."""
    import torch
    rows = int((q["nmv"][:, 0] > 0).sum())
    qs = {k: v for k, v in q.items() if k not in ("qhi", "qlo", "nmv")}
    qs["qposidx"] = np.full(q["qhi"].shape, -1, np.int32)
    for r in range(rows):
        m = int(q["nmv"][r, 0])
        key = ((q["qhi"][r, :m].astype(np.int64) + 0x80000000)
               .astype(np.uint64) << np.uint64(32)) \
            | (q["qlo"][r, :m].astype(np.int64) + 0x80000000) \
            .astype(np.uint64)
        pos = np.minimum(np.searchsorted(mi.keys, key), len(mi.keys) - 1)
        qs["qposidx"][r, :m] = np.where(mi.keys[pos] == key, pos, -1)
    ref = [o.cpu() for o in single._launch(qs, **kw)]
    out = [o.cpu() for o in out]
    for r in range(rows):
        a = int(q["nn"][r, 0])
        for i, name in enumerate(("xhi", "xlo", "yhi", "ylo", "f", "p")):
            check(torch.equal(out[i][r, :a], ref[i][r, :a]),
                  f"mesh bucket row {r}: {name} differs from the "
                  "single-device flow")
        check(int(out[6][r, 0]) == int(ref[6][r, 0]),
              f"mesh bucket row {r}: the flag differs")
    return rows


def _timed_stream(rt, batches, host_lines, label):
    """One timed map_stream of `rt` over `batches`, its stage timers and
    counters and the chain wrapper's counts set to 0 first; the lines are
    checked against HostRuntime's and >= 90% of the reads must be chained
    by the kernel. Returns (reads a second, stage timers summary,
    counters, chain launches, by form)."""
    for d in (rt.timers.acc, rt.timers.n, rt.timers.counters):
        d.clear()
    t0 = time.perf_counter()
    lines, launches, by_form = _chain_counts(
        lambda: [ls for b in rt.map_stream(batches) for ls in b])
    dt = time.perf_counter() - t0
    n_diff = sum(a != b for a, b in zip(lines, host_lines))
    check(len(lines) == len(host_lines) and n_diff == 0,
          f"phase 8 {label}: {n_diff} reads' SAM lines differ from "
          "HostRuntime")
    c = dict(rt.timers.counters)
    check(c.get("device_reads", 0) >= 0.9 * len(lines),
          f"phase 8 {label}: only {c.get('device_reads', 0)} of "
          f"{len(lines)} reads chained by the kernel")
    check(launches > 0, f"phase 8 {label}: no chain kernel launched")
    return len(lines) / dt, rt.timers.summary(), c, launches, by_form


def _phase8_meshes(e2e):
    """(c) the 1 x 1 nccl mesh in turns with the device routing, both
    runtimes warmed by one untimed pass; (d) the 1 x 2 mesh on one card
    over gloo, the chain kernel held against its plain version on the
    largest input the mesh gave it and every bucket against the
    single-card flow step. The chain launches counted are the 1 x 1
    mesh's timed runs and the 1 x 2 mesh's (rank 0 runs every chain of
    a 1 x I mesh)."""
    from minimap2_chaindp_tpu_torch.models import device_flow as DF
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    batches, host_lines = e2e["batches"], e2e["host_lines"]
    n = len(host_lines)
    rts = {"device": TorchRuntime(e2e["mi"], e2e["mo"], device="cuda",
                                  n_threads=THREADS),
           "mesh 1x1": TorchRuntime(e2e["mi"], e2e["mo"], device="cuda",
                                    n_threads=THREADS, mesh_shape=(1, 1))}
    try:
        for label, rt in rts.items():
            _timed_stream(rt, batches, host_lines, label)       # warm-up
        check(rts["mesh 1x1"]._mesh.backend == "nccl",
              "the 1x1 mesh is not on nccl")
        turns = []
        launches11, by_form11 = 0, {}
        for label in ("device", "mesh 1x1", "mesh 1x1", "device",
                      "device", "mesh 1x1", "mesh 1x1", "device"):
            rate, summary, c, nl, bf = _timed_stream(rts[label], batches,
                                                     host_lines, label)
            turns.append((label, rate))
            if label == "mesh 1x1":
                launches11 += nl
                by_form11 = {f: by_form11.get(f, 0) + bf[f] for f in bf}
            log(f"phase 8 (c) {label}: {rate:.1f} reads/s; stages (host "
                f"wall clock) {summary}")
    finally:
        for rt in rts.values():
            rt.close()
    mesh11 = dict(rts["mesh 1x1"].timers.counters)
    rates = {k: [r for lab, r in turns if lab == k] for k in rts}
    log(f"phase 8 (c) mesh 1x1 (nccl): byte-identical, "
        f"{mesh11['device_reads']} of {n} reads chained by the kernel; "
        "reads/s in turns: " + ", ".join(f"{lab} {r:.1f}"
                                         for lab, r in turns)
        + f"; mesh/device {np.mean(rates['mesh 1x1']) / np.mean(rates['device']):.3f}"
        f"; mesh_bytes {mesh11.get('mesh_bytes', 0)} (one rank sends "
        f"nothing to another); chain kernel launches in its 4 timed runs "
        f"{launches11} {by_form11}")

    # (d) two ranks on cuda:0, the index in two shards, over gloo
    launched = []
    biggest = {}
    real_chain = DF.chain_scores_batch

    def record_chain(*a, **kw):
        size = a[1].numel()
        if size > biggest.get("size", 0):
            biggest.update(size=size, args=a, kw=dict(kw))
        return real_chain(*a, **kw)
    frags = [f for b in batches for f in b]
    rt = TorchRuntime(e2e["mi"], e2e["mo"], device="cuda",
                      n_threads=THREADS, mesh_shape=(1, 2),
                      mesh_devices=["cuda:0", "cuda:0"])
    try:
        t0 = time.perf_counter()
        rt.map_batch(frags[:16])
        t_setup = time.perf_counter() - t0
        flow = rt._flow
        real = flow._launch

        def record(q, **kw):
            out = real(q, **kw)
            launched.append((q, kw, [o.cpu() for o in out]))
            return out
        flow._launch = record
        DF.chain_scores_batch = record_chain
        try:
            rate12, summary, c, launches12, by_form12 = _timed_stream(
                rt, batches, host_lines, "mesh 1x2")
        finally:
            DF.chain_scores_batch = real_chain
        check(rt._mesh.backend == "gloo", "the 1x2 mesh is not on gloo")
    finally:
        rt.close()
    c = rt.timers.counters
    n_mesh = n + 16       # the mesh's byte counts cover the warm-up batch
    # the kernel against its plain version on the mesh's largest input,
    # then every bucket against the single-card step on the same reads
    res = compare_kernel(
        "mesh 1x2 input R={} max_n={}".format(
            biggest["args"][1].shape[0], biggest["kw"]["max_n"]),
        biggest["args"], biggest["kw"], reps=11, phase=8)
    single = DF.DeviceFlow(e2e["mi"], e2e["mo"], device="cuda")
    n_rows = sum(check_mesh_bucket(e2e["mi"], single, *b) for b in launched)
    log(f"phase 8 (d) mesh 1x2 (gloo, both ranks on cuda:0): "
        f"byte-identical, {c['device_reads']} of {n} reads chained by the "
        f"kernel ({launches12} launches {by_form12}), {len(launched)} "
        f"buckets ({n_rows} reads) with anchors and f/p/flag equal to the "
        f"single-card flow; {rate12:.1f} reads/s (set-up with the first 16 "
        f"reads {t_setup:.1f} s); over its {n_mesh} reads mesh_bytes "
        f"{c['mesh_bytes'] / n_mesh:.1f} a read, of them all_gather "
        f"{c['mesh_allgather_bytes'] / n_mesh:.1f}; index shard to rank 1 "
        f"{c['mesh_table_bytes']} B; stages (host wall clock) {summary}")
    return dict(rates=rates, mesh11=mesh11, rate12=rate12,
                bytes12=c["mesh_bytes"] / n_mesh, res=res,
                launches=launches11 + launches12,
                by_form={f: by_form11.get(f, 0) + by_form12[f]
                         for f in by_form12})


def _phase8_host_gap(e2e):
    """(f): the host routing and HostRuntime on phase 7's batches at -t
    THREADS, warm, in turns ABAB then BABA."""
    import copy
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    mo = copy.copy(e2e["mo"])
    mo.mini_batch_size = LANE_BATCH_READS * READ_LEN
    batches = list(read_frags([e2e["reads"]], mo.mini_batch_size, False))
    n = sum(len(b) for b in batches)
    runs = {"A": TorchRuntime(e2e["mi"], mo, device="cuda",
                              n_threads=THREADS, routing="host"),
            "B": HostRuntime(e2e["mi"], mo, n_threads=THREADS)}
    for rt in runs.values():
        rt.map_batch(batches[0][:16])
    rates = {"A": [], "B": []}
    want = None
    for who in HOST_GAP_ORDER:
        t0 = time.perf_counter()
        lines = [ls for b in runs[who].map_stream(batches) for ls in b]
        rates[who].append(n / (time.perf_counter() - t0))
        want = want or lines
        check(lines == want, "phase 8 (f): the two runtimes' lines differ")
    for rt in runs.values():
        rt.close()
    gap = [a / b - 1 for a, b in zip(rates["A"], rates["B"])]
    log(f"phase 8 (f) host routing (A) against HostRuntime (B), -t "
        f"{THREADS}, {HOST_GAP_ORDER}: A "
        f"{', '.join(f'{r:.1f}' for r in rates['A'])}; B "
        f"{', '.join(f'{r:.1f}' for r in rates['B'])} reads/s; A/B - 1 by "
        f"pair: {', '.join(f'{100 * g:+.1f}%' for g in gap)}")
    return dict(A=rates["A"], B=rates["B"])


def phase_rest(e2e):
    """Phase 8: the device index build, entry(), the meshes, the dry run
    and the host routing's gap. Returns the chain launches of its paths,
    each counted from 0 just before the path's run and read just after:
    entry(), the meshes' timed runs, the dry run."""
    from minimap2_chaindp_tpu_torch.entry import dryrun_multichip
    t0 = time.perf_counter()
    idx = _phase8_index(e2e)
    per_path = {"entry": _phase8_entry()}
    meshes = _phase8_meshes(e2e)
    per_path["meshes"] = (meshes["launches"], meshes["by_form"])
    t1 = time.perf_counter()
    line, nl, bf = _chain_counts(lambda: dryrun_multichip(2, "cuda"))
    check(nl > 0, "the dry run launched no chain kernel")
    per_path["dryrun"] = (nl, bf)
    log(f"phase 8 (e) {line} ({time.perf_counter() - t1:.1f} s; chain "
        f"kernel launches {nl} {bf})")
    gap = _phase8_host_gap(e2e)
    launches = sum(nl for nl, _bf in per_path.values())
    by_form = {f: sum(bf[f] for _nl, bf in per_path.values())
               for f in per_path["entry"][1]}
    log(f"phase 8 done in {time.perf_counter() - t0:.1f} s; chain kernel "
        "launches by path (rank 0's process runs every chain of these "
        "paths): " + ", ".join(f"{k} {nl} {bf}"
                               for k, (nl, bf) in per_path.items())
        + f"; {launches} in all")
    # every runtime of phases 4-8 was closed where it was used: none may
    # still hold a -t pool thread or a mesh rank
    import multiprocessing
    import threading
    left = sorted(t.name for t in [*threading.enumerate(),
                                   *multiprocessing.active_children()]
                  if t.name.startswith("mm2tpu-"))
    check(not left, f"phase 8: runtimes still running: {left}")
    return dict(launches=launches, by_form=by_form, index=idx,
                meshes=meshes, gap=gap)


# --------------------------------------------------------------- phase 10
# the presets of the JAX package (options.py:110-170) on a 50 Mbp genome
# (made by the phase's first run, then cached): sr single-end reads,
# map-pb reads of 10 kb (map10k is the same option set: a cut of them), an
# all-vs-all set of about 20x over the genome's first 200 kb under ava-ont
# and ava-pb (PAF; one cut with -c), and contigs of 20 kb at each asm preset's
# divergence. Each TorchRuntime run on the card at -t THREADS against
# HostRuntime, and the option cases of tests/test_torch_options.py through
# the port's CLI on a small genome, --device cuda against --device host.
P10_GENOME = (25, 2_000_000, 42)
P10_SR = (5000, 150, 0.01)                  # reads, length, error
P10_PB = (500, 10_000, 0.10)
P10_MAP10K_READS = 100
P10_AVA = (200_000, 800, 5000, 0.10)        # region, reads, length, error
P10_AVA_C_READS = 100
P10_ASM = {"asm5": 0.001, "asm10": 0.01, "asm20": 0.05}
P10_ASM_CONTIGS = (200, 20_000)
P10_COUNTERS = ("device_reads", "staged_device_reads", "host_chain",
                "host_chain_oversized", "host_chain_bw", "fallback",
                "native_finish", "staged_frags", "ext_device", "ext_native")
# The option matrix, one list for the card and for the CPU tests
# (tests/test_torch_options.py, _options_output.py, _options_presets.py):
# (id, options, queries). Each run makes queries of these kinds, the
# tests at a smaller size: "r" reads of the genome, "sr" short reads of
# it, "ovl" reads that overlap each other (mapped against themselves),
# "asm" contigs of low divergence from the genome, "splice" the splice
# fixtures of tests/data.
OPTION_CASES = [
    ("for-only", ["--for-only", "-c"], "r"),
    ("rev-only", ["--rev-only", "-c"], "r"),
    ("ava-X-M", ["-X", "-M", "0.3"], "ovl"),
    ("pri-ratio-bestn", ["-p", "0.5", "-N", "10", "-c"], "ovl"),
    ("secondary-no", ["--secondary=no", "-a"], "r"),
    ("long-cigar-L", ["-L", "-a"], "r"),
    ("small-bw", ["-r", "100", "-a"], "r"),
    ("max-gap", ["-g", "1000", "-c"], "r"),
    ("mid-occ-frac", ["-f", "0.001", "-c"], "r"),
    # batches of about 1 kb, so that map_stream takes several (-K 20k on
    # the reference tests' larger q-inv.fa)
    ("tiny-K", ["-K", "1k", "-c"], "r"),
    ("multipart-I", ["-I", "100k", "-a"], "r"),
    ("paf", [], "r"),
    ("paf-cigar", ["-c"], "r"),
    ("cs", ["-c", "--cs"], "r"),
    ("md", ["-c", "--MD"], "r"),
    ("intron-G", ["-G", "5k", "-ax", "splice"], "splice"),
    ("preset-ava-pb", ["-x", "ava-pb"], "ovl"),
    ("preset-asm5", ["-x", "asm5", "-c"], "asm"),
    ("preset-sr", ["-x", "sr", "-a"], "sr"),
    # the input edges of a human reference (tests/test_input_edges.py's
    # four cases on synthetic input): a lowercase (soft-masked) query,
    # IUPAC codes, a read with more output lines than the native text
    # buffers' first 258 (-N 300 on a tandem repeat; its 6600 anchors
    # keep it in the fused flow, so the native finish grows its buffers)
    # and --MD on spliced alignments
    ("lowercase-query", ["-a"], "lower"),
    ("iupac-query", ["-a"], "iupac"),
    ("many-lines-N300", ["-a", "-N", "300", "-p", "0.1"], "tandem"),
    ("splice-MD", ["-ax", "splice", "--MD"], "splice"),
]
# the tandem repeat: a unit of 60 random bases (seed 7), 300 copies in the
# reference, the query two copies
TANDEM_UNIT, TANDEM_COPIES, TANDEM_QUERY = 60, 300, 2


def edge_queries(reads, d):
    """The edge cases' inputs in directory `d`: {"lower": the reads at
    `reads` lowercased, "iupac": the reads with an IUPAC code (RYSWKMBDHV
    in turn) at 2% of their bases (seed 3), "iupac_n": the same with N at
    those bases, "tandem": [the tandem reference, its query]}."""
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    recs = list(read_fastx(reads))
    out = {k: os.path.join(d, f"edge_{k}.fa")
           for k in ("lower", "iupac", "iupac_n", "tref", "tq")}
    rng = np.random.default_rng(3)
    with open(out["lower"], "w") as lo, open(out["iupac"], "w") as iu, \
            open(out["iupac_n"], "w") as nn:
        for r in recs:
            lo.write(f">{r.name}\n{r.seq.lower()}\n")
            si, sn = list(r.seq), list(r.seq)
            for i, p in enumerate(np.flatnonzero(
                    rng.random(len(r.seq)) < 0.02)):
                si[p], sn[p] = "RYSWKMBDHV"[i % 10], "N"
            iu.write(f">{r.name}\n{''.join(si)}\n")
            nn.write(f">{r.name}\n{''.join(sn)}\n")
    rng = np.random.default_rng(7)
    unit = "".join("ACGT"[b] for b in rng.integers(0, 4, TANDEM_UNIT))
    with open(out["tref"], "w") as f:
        f.write(f">tand\n{unit * TANDEM_COPIES}\n")
    with open(out["tq"], "w") as f:
        f.write(f">q1\n{unit * TANDEM_QUERY}\n")
    out["tandem"] = [out.pop("tref"), out.pop("tq")]
    return out


def _p10_inputs():
    """The phase's reads and contigs, cached in SMOKE_DIR."""
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    ref = G.cached_genome(*P10_GENOME)
    tag = "g{}x{}s{}".format(*P10_GENOME)
    path = lambda name: os.path.join(SMOKE_DIR, f"p10_{tag}_{name}.fa")
    out = {"ref": ref}
    n, ln, err = P10_SR
    out["sr"] = _cached(path(f"sr{n}"),
                        lambda p: G.simulate(ref, p, n, ln, err, seed=101))
    n, ln, err = P10_PB
    out["map-pb"] = _cached(path(f"pb{n}"),
                            lambda p: G.simulate(ref, p, n, ln, err,
                                                 seed=103))
    region, n, ln, err = P10_AVA

    def ava(p):
        first = next(iter(read_fastx(ref)))
        src = p + ".src"
        with open(src, "w") as f:
            f.write(f">{first.name}\n{first.seq[:region]}\n")
        G.simulate(src, p, n, ln, err, seed=105)
        os.remove(src)
    out["ava"] = _cached(path(f"ava{n}"), ava)
    n, ln = P10_ASM_CONTIGS
    for i, (preset, err) in enumerate(P10_ASM.items()):
        out[preset] = _cached(path(f"{preset}_{n}"), lambda p, e=err, s=i:
                              G.simulate(ref, p, n, ln, e, seed=107 + s))
    return out


def _p10_run(label, mi, mo, batches):
    """HostRuntime, then TorchRuntime on the card, -t THREADS, over
    `batches`: a warm-up batch each, then the card's counters, stage
    timers and launch counts set to 0, the timed map_stream with every
    kernel wrapper's largest input kept (utils/kernel_inputs.py), and the
    counts read. The lines must be equal. Returns the run's numbers and
    the kept inputs."""
    import torch
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.utils import kernel_inputs as KI
    frags = [f for b in batches for f in b]
    host = HostRuntime(mi, mo, n_threads=THREADS)
    host.map_batch(frags[:16])
    t0 = time.perf_counter()
    want = [ls for b in host.map_stream(batches) for ls in b]
    t_host = time.perf_counter() - t0
    host.close()
    rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS)
    rt.map_batch(frags[:16])
    torch.cuda.synchronize()
    for d in (rt.timers.acc, rt.timers.n, rt.timers.counters):
        d.clear()
    ex = rt.align_exec
    ex.n_device = ex.n_native = ex.n_host = 0
    _reset_launches()
    with KI.record() as kept:
        t0 = time.perf_counter()
        got = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    launches = _read_launches()
    rt.close()
    n_diff = sum(a != b for a, b in zip(got, want))
    check(len(got) == len(want) == len(frags) and n_diff == 0,
          f"phase 10 {label}: {n_diff} fragments' lines differ from "
          "HostRuntime")
    c = dict(rt.timers.counters)
    n = len(frags)
    log(f"phase 10 {label}: {sum(map(len, got))} records for {n} "
        f"fragments, byte-identical to HostRuntime; {n / t_port:.1f} "
        f"fragments/s on the card ({t_port:.2f} s) against HostRuntime "
        f"{n / t_host:.1f} ({t_host:.2f} s), -t {THREADS}; "
        + " ".join(f"{k}={c.get(k, 0)}" for k in P10_COUNTERS)
        + f"; launches chain {launches['chain']}, ksw2 {launches['ksw']}, "
        f"walk {launches['walk']}, signal {launches['signal']}")
    log(f"phase 10 {label} stages (host wall clock): {rt.timers.summary()}")
    return dict(rate=n / t_port, host_rate=n / t_host, frags=n,
                counters={k: c.get(k, 0) for k in P10_COUNTERS},
                launches=launches, kept=kept)


def _digest(obj, h=None) -> str:
    """A hash of a kept input: tensors and arrays by dtype, shape and
    bytes, containers by their items, anything else by repr."""
    import hashlib
    import torch
    h = h or hashlib.sha256()
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        h.update(f"{obj.dtype}{obj.shape}".encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            h.update(repr(k).encode())
            _digest(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        h.update(f"{type(obj).__name__}{len(obj)}".encode())
        for x in obj:
            _digest(x, h)
    else:
        h.update(repr(obj).encode())
    return h.hexdigest()


def _p10_check_kept(label, kept, seen=None, phase=10):
    """Every kept input against the plain version (comparison launches,
    not counted): the chain kernel by mode, the ksw2 forward and walk
    kernels on the launch with the most DP cells. With `seen` (digest ->
    (label, check)), an input already checked under another label keeps
    that check, so that the plain versions run once an input."""
    def once(what, inp, run):
        if seen is None:
            return run()
        d = _digest(inp)
        if d in seen:
            log(f"phase {phase} {label} {what}: the same input as "
                f"{seen[d][0]}, whose check stands")
        else:
            seen[d] = (label, run())
        return seen[d][1]
    chain, ksw = {}, None
    for mode, (_slots, args, kw) in sorted(kept.chain.items()):
        chain[mode] = once(mode, (args, kw), lambda: compare_kernel(
            f"{label} {mode} input R={args[1].shape[0]} "
            f"max_n={kw['max_n']}", args, kw, reps=3, phase=phase))
    if kept.ksw is not None:
        _cells, jobs, splice, noncan = kept.ksw

        def run():
            pk, ts, kw = packed_ksw_inputs(jobs, kept.scoring[splice],
                                           splice, noncan, "cuda")
            return compare_ksw(f"{label} input ({len(jobs)} jobs)", pk, ts,
                               kw, reps=3, phase=phase)
        ksw = once("ksw2", (jobs, kept.scoring[splice], splice, noncan), run)
    return chain, ksw


def _p10_options():
    """Each case of OPTION_CASES through the port's CLI in this process,
    --device cuda against --device host: the lines equal apart from @PG;
    the card's launches counted from 0 before each --device cuda run, its
    kernel inputs kept and then held against the plain versions. Returns
    the launches in all, each case's numbers and the checks of the kept
    inputs by case."""
    import contextlib
    import io as _io
    from minimap2_chaindp_tpu_torch import cli
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    from minimap2_chaindp_tpu_torch.utils import kernel_inputs as KI
    g = _cached(os.path.join(SMOKE_DIR, "p10_opt_g.fa"),
                lambda p: G.make_genome(p, n_contigs=2, contig_len=200_000,
                                        seed=81))
    r = _cached(os.path.join(SMOKE_DIR, "p10_opt_r1k.fa"),
                lambda p: G.simulate(g, p, 200, 1000, 0.10, seed=85))
    sr = _cached(os.path.join(SMOKE_DIR, "p10_opt_sr.fa"),
                 lambda p: G.simulate(g, p, 500, 150, 0.01, seed=91))
    asm = _cached(os.path.join(SMOKE_DIR, "p10_opt_asm.fa"),
                  lambda p: G.simulate(g, p, 10, 20_000, 0.001, seed=89))

    def ovl(p):
        seq = next(iter(read_fastx(g))).seq
        src = p + ".src"
        with open(src, "w") as f:
            f.write(f">head\n{seq[60_000:80_000]}\n")
        G.simulate(src, p, 40, 2000, 0.05, seed=87)
        os.remove(src)
    o = _cached(os.path.join(SMOKE_DIR, "p10_opt_ovl.fa"), ovl)
    spl = [os.path.join(ROOT, "tests", "data", f)
           for f in ("splice_genome.fa", "splice_cdna.fa")]
    edge = edge_queries(r, SMOKE_DIR)
    files = {"r": [g, r], "sr": [g, sr], "ovl": [o, o], "asm": [g, asm],
             "splice": spl, "lower": [g, edge["lower"]],
             "iupac": [g, edge["iupac"]], "tandem": edge["tandem"]}

    def run(args):
        out, err = _io.StringIO(), _io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(args)
        check(rc == 0, f"phase 10 CLI {' '.join(args)} exited {rc}: "
              f"{err.getvalue()[-2000:]}")
        return [ln for ln in out.getvalue().split("\n")
                if not ln.startswith("@PG")], err.getvalue()
    tot = dict(chain=0, ksw=0, walk=0, signal=0)
    res, checks, seen = {}, {}, {}
    for name, opts, q in OPTION_CASES:
        host, _e = run(["--device", "host", *opts, *files[q]])
        _reset_launches()
        with KI.record() as kept:
            card, err = run(["--device", "cuda", *opts, *files[q]])
        n = _read_launches()
        check(card == host, f"phase 10 option case {name}: the card's "
              "lines differ from --device host")
        check(sum(1 for ln in card if ln and ln[0] != "@") > 0,
              f"phase 10 option case {name}: no record")
        for k in tot:
            tot[k] += n[k]
        c = cli.LAST_RUN_COUNTERS
        res[name] = dict(n, records=sum(1 for ln in card
                                        if ln and ln[0] != "@"))
        log(f"phase 10 option {name} ({' '.join(opts)}): "
            f"{res[name]['records']} records, equal to --device host; "
            f"launches chain {n['chain']}, ksw2 {n['ksw']}, walk "
            f"{n['walk']}, signal {n['signal']}; "
            + " ".join(f"{k}={c.get(k, 0)}" for k in P10_COUNTERS))
        chain, ksw = checks[f"opt_{name}"] = _p10_check_kept(
            f"option {name}", kept, seen)
        check(bool(chain) == (n["chain"] > 0)
              and (ksw is not None) == (n["ksw"] > 0),
              f"phase 10 option case {name}: the kept inputs {sorted(chain)}"
              f", ksw2 {ksw is not None} do not match the launches {n}")
    check(tot["chain"] > 0, "phase 10: the option cases launched no chain "
          "kernel")
    return tot, res, checks


def phase_presets():
    """Phase 10: every preset and the option matrix on the card. Returns
    the launches by path and in all, each preset's numbers and the kept
    inputs' checks."""
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.options import set_opt
    t0 = time.perf_counter()
    inp = _p10_inputs()
    log(f"phase 10 inputs: {P10_GENOME[0] * P10_GENOME[1] / 1e6:.0f} Mbp "
        f"genome; sr {P10_SR}, map-pb {P10_PB}, ava {P10_AVA}, asm "
        f"{P10_ASM_CONTIGS} at {P10_ASM} "
        f"({time.perf_counter() - t0:.1f} s)")
    indexes = {}

    def index(preset, ref):
        io, mo = set_opt(preset)
        key = (ref, io.k, io.w, io.flag)
        if key not in indexes:
            t1 = time.perf_counter()
            names, seqs = [], []
            for r in read_fastx(ref):
                names.append(r.name)
                seqs.append(C.seq_to_nt4(r.seq))
            indexes.clear()         # one index of 50 Mbp at a time
            indexes[key] = build_index(names, seqs, io.w, io.k, io.flag,
                                       io.bucket_bits,
                                       n_threads=os.cpu_count() or 1)
            log(f"phase 10 index k={io.k} w={io.w} hpc="
                f"{int(bool(io.flag & C.MM_I_HPC))} over "
                f"{os.path.basename(ref)}: {len(indexes[key].keys)} keys "
                f"({time.perf_counter() - t1:.1f} s)")
        mi = indexes[key]
        mo.update(mi)
        return mi, mo

    runs, checks = {}, {}
    plan = [("sr", "sr", inp["ref"], inp["sr"], 0),
            ("map-pb", "map-pb", inp["ref"], inp["map-pb"], 0),
            ("map10k", "map10k", inp["ref"], inp["map-pb"],
             P10_MAP10K_READS),
            ("ava-ont", "ava-ont", inp["ava"], inp["ava"], 0),
            ("ava-pb", "ava-pb", inp["ava"], inp["ava"], 0),
            ("ava-pb -c", "ava-pb", inp["ava"], inp["ava"], P10_AVA_C_READS)]
    plan += [(p, p, inp["ref"], inp[p], 0) for p in P10_ASM]
    for label, preset, ref, qry, cut in plan:
        mi, mo = index(preset, ref)
        if preset.startswith("ava"):
            # PAF as the ava users run it; the cut with -c (cg:Z:)
            if cut:
                mo.flag |= C.MM_F_OUT_CG | C.MM_F_CIGAR
        else:
            mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR        # -a
        batches = list(read_frags([qry], mo.mini_batch_size, False))
        if cut:
            batches = [[f for b in batches for f in b][:cut]]
        runs[label] = _p10_run(label, mi, mo, batches)
        checks[label] = _p10_check_kept(label, runs[label].pop("kept"))
    indexes.clear()
    for label in ("sr", "map-pb", "ava-ont", "ava-pb"):
        check(runs[label]["launches"]["chain"] > 0,
              f"phase 10 {label}: the chain kernel never launched")
    for label in P10_ASM:
        n = runs[label]["launches"]
        check(n["ksw"] > 0 and n["walk"] > 0,
              f"phase 10 {label}: the ksw2 kernels never launched")
    check(runs["ava-pb -c"]["launches"]["ksw"] > 0,
          "phase 10 ava-pb -c: the ksw2 kernels never launched")
    t1 = time.perf_counter()
    opt_launches, opt_res, opt_checks = _p10_options()
    checks.update(opt_checks)
    log(f"phase 10 option cases: {len(opt_res)} equal to --device host "
        f"({time.perf_counter() - t1:.1f} s); launches {opt_launches}")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                + opt_launches[k] for k in opt_launches}
    secs = time.perf_counter() - t0
    log(f"phase 10 done in {secs:.1f} s; launches by path "
        + ", ".join(f"{k} {r['launches']}" for k, r in runs.items())
        + f", options {opt_launches}; {launches} in all")
    return dict(launches=launches, runs=runs, checks=checks,
                options=opt_res, secs=secs)


# ---------------------------------------------------------------- phase 11
# the main path at genome scale: 2 Mbp contigs (make_genome, seed 42,
# cached in SMOKE_DIR like phase 4's) indexed under map-ont with the
# minimizer pair sort on the card, and phase 4's workload (1000 x 10 kb
# reads at 10%, seed 5) in batches of LANE_BATCH_READS under the device
# and steal routings. Cut from a human genome's 3 Gbp (GENOME_3G, 1500
# contigs) to 1 Gbp: at 3 Gbp the phase took 170.8 s and the smoke 1095.6
# s of its 1200 (PERF.md §4); tools/genome_scale.py --mb 3000 and
# phase7_turns run the 3 Gbp genome. Its inputs are made in a process of
# their own while phases 1-10 run (_p11_start)
GENOME_3G = (1500, 2_000_000, 42)             # contigs, length, seed
P11_GENOME = (500, 2_000_000, 42)
P11_READS = (1000, 10_000, 0.10, 5)           # reads, length, error, seed
P11_COUNTERS = ("device_reads", "staged_device_reads", "staged_frags",
                "native_finish", "fallback", "host_chain_oversized",
                "host_chain_bw", "ext_device", "ext_long_device",
                "ext_native", "steal_device_reads",
                "steal_chunks", "steal_cold_chunks", "steal_join_ms",
                "steal_dev_fallback", "fast_native")


def _p11_inputs(genome=None, report=False):
    """The genome `genome` (default P11_GENOME) and phase 11's reads of
    it, cached in SMOKE_DIR: (genome path, reads path, seconds to make
    each); with `report` a line with the seconds."""
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    n_ctg, ctg_len, seed = genome or P11_GENOME
    n_reads, read_len, err, rseed = P11_READS
    t0 = time.perf_counter()
    ref = _cached(os.path.join(
        SMOKE_DIR, f"genome_{n_ctg}x{ctg_len}_s{seed}.fa"),
        lambda p: G.make_genome(p, n_contigs=n_ctg, contig_len=ctg_len,
                                seed=seed))
    t1 = time.perf_counter()
    reads = _cached(os.path.join(
        SMOKE_DIR, f"p11_reads_{n_ctg}x{ctg_len}_{n_reads}x{read_len}"
        f"_s{rseed}.fa"),
        lambda p: G.simulate(ref, p, n_reads, read_len, err, seed=rseed))
    t2 = time.perf_counter()
    if report:
        log(f"phase 11 inputs made: {n_ctg * ctg_len / 1e6:.0f} Mbp genome "
            f"{t1 - t0:.1f} s, {n_reads} reads {t2 - t1:.1f} s")
    return ref, reads, t1 - t0, t2 - t1


def _p11_start():
    """Start making phase 11's inputs in a process of its own (spawn),
    to overlap phases 1-10; phase_genome joins it, main() stops it."""
    import multiprocessing as mp
    p = mp.get_context("spawn").Process(
        target=_p11_inputs, kwargs=dict(report=True), name="smoke-p11")
    p.start()
    return p


def _p11_index(ref):
    """The map-ont index of `ref` with the pair sort on the card, at -t of
    every core: (index, FASTA read seconds, build seconds)."""
    import torch
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.options import set_opt
    io, _mo = set_opt("map-ont")
    t0 = time.perf_counter()
    names, seqs = [], []
    for r in read_fastx(ref):
        names.append(r.name)
        seqs.append(C.seq_to_nt4(r.seq))
    t_read = time.perf_counter() - t0
    t0 = time.perf_counter()
    mi = build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                     n_threads=os.cpu_count() or 1, device="cuda")
    torch.cuda.synchronize()
    return mi, t_read, time.perf_counter() - t0


def phase_genome(inputs=None):
    """Phase 11: the genome of P11_GENOME and its index built on the card,
    HostRuntime and then TorchRuntime under the device routing (warmed by
    one batch) and under steal (cold: its index tables dropped from the
    cache first, so that its first batch runs while its flow uploads them
    on a thread of its own), each byte-identical to HostRuntime, each
    run's launches counted from 0 and its largest kernel inputs held
    against the plain versions. Frees the tables before it returns.
    `inputs` is the process of _p11_start, joined first."""
    import copy
    import gc
    import resource
    import torch
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import seeds_device as SD
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.tools.genome_scale import anchor_stats
    from minimap2_chaindp_tpu_torch.utils import kernel_inputs as KI
    t_phase = time.perf_counter()
    n_ctg, ctg_len, _seed = P11_GENOME
    n_reads, read_len, err, _rseed = P11_READS
    mbp = n_ctg * ctg_len / 1e6
    rss_gb = lambda: resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss / 2**20
    t0 = time.perf_counter()
    if inputs is not None:
        inputs.join()
        check(inputs.exitcode == 0, "phase 11: making the inputs failed "
              f"(exit code {inputs.exitcode})")
    ref, reads = _p11_inputs()[:2]
    log(f"phase 11 inputs: {mbp:.0f} Mbp genome ({n_ctg} x {ctg_len} bp), "
        f"{n_reads} x {read_len} bp reads at {err:.0%} error "
        f"({time.perf_counter() - t0:.1f} s in this phase)")

    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR          # -a
    torch.cuda.reset_peak_memory_stats()
    mi, t_read, t_build = _p11_index(ref)
    build_peak = torch.cuda.max_memory_allocated()
    mo.update(mi)
    occ = np.diff(mi.starts)
    log(f"phase 11 index: {len(mi.keys)} keys, {len(mi.values)} positions "
        f"(occurrences mean {occ.mean():.2f}, p99 "
        f"{int(np.percentile(occ, 99))}, max {int(occ.max())}), mid_occ "
        f"{mo.mid_occ}; FASTA read {t_read:.1f} s, build with the pair sort "
        f"on the card {t_build:.1f} s (-t {os.cpu_count()}), its "
        f"max_memory_allocated {build_peak} B; peak RSS so far "
        f"{rss_gb():.1f} GiB")
    del occ

    mo = copy.copy(mo)
    mo.mini_batch_size = LANE_BATCH_READS * read_len
    batches = list(read_frags([reads], mo.mini_batch_size, False))
    frags = [f for b in batches for f in b]
    n = len(frags)
    t0 = time.perf_counter()
    st = anchor_stats(mi, mo, frags)
    log(f"phase 11 anchors a read: mean {st['mean']:.1f}, p99 {st['p99']}, "
        f"max {st['max']} over {st['reads']} reads; capacity buckets "
        f"{st['buckets']} ({time.perf_counter() - t0:.1f} s)")

    host = HostRuntime(mi, mo, n_threads=THREADS)
    host.map_batch(frags[:16])
    t0 = time.perf_counter()
    want = [ls for b in host.map_stream(batches) for ls in b]
    t_host = time.perf_counter() - t0
    host.close()

    t0 = time.perf_counter()
    dx = SD.device_index_cached(mi, "cuda")
    torch.cuda.synchronize()
    t_up = time.perf_counter() - t0
    nbytes = dx.nbytes()
    del dx
    log(f"phase 11 upload: DeviceIndex {nbytes} B in {t_up:.2f} s")

    runs, checks, seen = {}, {}, {}
    for routing in ("device", "steal"):
        if routing == "steal":
            SD.release_device_index(mi, "cuda")
            gc.collect()
            torch.cuda.empty_cache()
        rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS,
                          routing=routing)
        if routing == "device":
            rt.map_batch(frags[:16])
            torch.cuda.synchronize()
            for d in (rt.timers.acc, rt.timers.n, rt.timers.counters):
                d.clear()
            rt.align_exec.n_device = rt.align_exec.n_native = 0
            rt.align_exec.n_host = 0
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        with KI.record() as kept:
            t0 = time.perf_counter()
            got = [ls for b in rt.map_stream(batches) for ls in b]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = _read_launches()
        peak = torch.cuda.max_memory_allocated()
        rt.close()
        n_diff = sum(a != b for a, b in zip(got, want))
        check(len(got) == len(want) == n and n_diff == 0,
              f"phase 11 {routing}: {n_diff} reads' SAM lines differ from "
              "HostRuntime")
        c = {k: rt.timers.counters.get(k, 0) for k in P11_COUNTERS}
        share = (c["device_reads"] + c["staged_device_reads"]) / n
        log(f"phase 11 {routing}: {sum(map(len, got))} records for {n} "
            f"reads, byte-identical to HostRuntime; {n / dt:.1f} reads/s "
            f"({dt:.2f} s) against HostRuntime {n / t_host:.1f} "
            f"({t_host:.2f} s), -t {THREADS}; chain device share "
            f"{share:.1%}; " + " ".join(f"{k}={v}" for k, v in c.items())
            + f"; launches chain {launches['chain']}, ksw2 "
            f"{launches['ksw']}, walk {launches['walk']}, signal "
            f"{launches['signal']}; max_memory_allocated {peak} B")
        log(f"phase 11 {routing} stages (host wall clock): "
            f"{rt.timers.summary()}")
        runs[routing] = dict(rate=n / dt, host_rate=n / t_host,
                             counters=c, share=share, launches=launches,
                             peak=peak)
        checks[routing] = _p10_check_kept(routing, kept, seen, phase=11)
        del rt, kept
    check(runs["device"]["launches"]["chain"] > 0,
          "phase 11: the device routing launched no chain kernel")
    # the largest chain input of the phase: its time and bound
    big = max((r for ch, _k in checks.values() for r in ch.values()),
              key=lambda r: r["anchors"])
    log(f"phase 11 largest chain input: {big['anchors']} anchors, kernel "
        f"{big['ms']:.3f} ms ({big['form']}), bound {big['bound_ms']:.4f} "
        f"ms by {big['bound_by']}, share {big['bound_ms'] / big['ms']:.1%}, "
        f"{big['step_ns']:.1f} ns per anchor of the longest read")

    SD.release_device_index(mi, "cuda")
    del mi, frags, batches, got, want
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("chain", "ksw", "walk", "signal")}
    secs = time.perf_counter() - t_phase
    log(f"phase 11 done in {secs:.1f} s; launches {launches}; the "
        f"{mbp:.0f} Mbp tables freed (memory_allocated "
        f"{torch.cuda.memory_allocated()} B); peak RSS {rss_gb():.1f} GiB")
    return dict(launches=launches, runs=runs, checks=checks, big=big,
                secs=secs, anchors=st, build_s=t_build, upload_s=t_up,
                nbytes=nbytes)


# --------------------------------------------------------------- phase 12
# the inputs a human reference has (PERF.md §4): phase 4's 250 Mbp genome
# masked (utils/genome_synth.mask_genome: about half its bases lowercased in
# runs, 10 kb N gaps at each contig's ends, 50 kb inside it, three of 100
# bp, eight IUPAC codes a contig) with phase 5's GENES gene loci patched in;
# P12_READS reads of 10 kb at 10% (P12_EDGE_READS of them across the gaps'
# edges) with single Ns, IUPAC codes, N runs and lowercase stretches
# (P12_READ_EDGES, transform_reads) under map-ont; P12_PAIRS pairs with
# about 0.5% N under -x sr; P12_TX transcripts of the masked loci with
# Ns under -x splice --MD. Made by a process of its own during phases
# 5-11 (_p12_start).
P12_MASK_SEED = 12
P12_READS = (1000, 10_000, 0.10, 25)       # reads, length, error, seed
P12_EDGE_READS = 100
P12_READ_EDGES = dict(n_rate=0.001, iupac_rate=0.0002, run_rate=0.1,
                      lower_rate=0.3)
P12_PAIRS = (5000, 0.005, 27)              # pairs, N rate, seed
# one full transcript a gene, cut from phase 5's 2000 (the phase took
# 259.3 s with them, 180.5 s with 1000). Most of it is the check of the
# splice run's largest extension launch against the plain version (127.5
# s: its longest job has 15322 rows); with 500 transcripts that launch
# is the same 2945 jobs
P12_TX = (1000, 0.001, 29)                 # transcripts, N rate, seed


def _p12_inputs(ref, report=False):
    """Phase 12's genome and reads from phase 4's genome `ref`, cached in
    SMOKE_DIR: {"ref": the masked genome with the gene loci, "ont": reads,
    "pairs": [read 1, read 2], "tx": transcripts}."""
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    t0 = time.perf_counter()
    path = lambda name: os.path.join(SMOKE_DIR, f"p12_{name}")
    base = os.path.basename(ref).rsplit(".", 1)[0]
    masked = _cached(path(f"{base}_m{P12_MASK_SEED}.fa"),
                     lambda p: G.mask_genome(ref, p, seed=P12_MASK_SEED))
    n_tx, tx_n, tx_seed = P12_TX
    g12, tx0 = path(f"{base}_m{P12_MASK_SEED}_genes.fa"), path(f"tx{n_tx}.fa")
    _cached(g12, lambda p, q: _write_spliced(masked, p, q,
                                             transcripts=n_tx), tx0)
    tx = _cached(path(f"tx{n_tx}_n.fa"), lambda p: G.transform_reads(
        tx0, p, tx_seed, n_rate=tx_n))
    n, ln, err, seed = P12_READS

    def ont(p):
        G.simulate(g12, p + ".sim", n - P12_EDGE_READS, ln, err, seed=seed)
        G.edge_reads(g12, p + ".edge", ln, err, seed + 1, n=P12_EDGE_READS)
        with open(p + ".all", "w") as f:
            for part in (".sim", ".edge"):
                with open(p + part) as g:
                    f.write(g.read())
                os.remove(p + part)
        G.transform_reads(p + ".all", p, seed + 2, **P12_READ_EDGES)
        os.remove(p + ".all")
    reads = _cached(path(f"ont{n}x{ln}.fa"), ont)
    n_pe, pe_n, pe_seed = P12_PAIRS

    def pairs(p1, p2):
        G.simulate_pairs(g12, p1 + ".raw", p2 + ".raw", n_pe, seed=pe_seed)
        for i, p in enumerate((p1, p2)):
            G.transform_reads(p + ".raw", p, pe_seed + 1 + i, n_rate=pe_n)
            os.remove(p + ".raw")
    pe = [path(f"pe{n_pe}_{i}.fq") for i in (1, 2)]
    _cached(pe[0], pairs, pe[1])
    if report:
        log(f"phase 12 inputs made in {time.perf_counter() - t0:.1f} s")
    return dict(ref=g12, ont=reads, pairs=pe, tx=tx)


def _p12_start(ref):
    """Start making phase 12's inputs in a process of its own (spawn);
    phase_masked joins it, main() stops it."""
    import multiprocessing as mp
    p = mp.get_context("spawn").Process(
        target=_p12_inputs, args=(ref,), kwargs=dict(report=True),
        name="smoke-p12")
    p.start()
    return p


def _check_kept_n(label, kept, seen, phase=12):
    """The kept launch with the most DP cells among those with a code-4
    base, against the plain versions (comparison launches, not counted);
    None where the run launched none. An input already checked keeps
    that check."""
    if kept.ksw_n is None:
        return None
    _cells, jobs, splice, noncan = kept.ksw_n
    n4 = sum(1 for j in jobs if (j["qseq"] == 4).any()
             or (j["tseq"] == 4).any())
    d = _digest((jobs, kept.scoring[splice], splice, noncan))
    if d not in seen:
        pk, ts, kw = packed_ksw_inputs(jobs, kept.scoring[splice], splice,
                                       noncan, "cuda")
        seen[d] = (label, compare_ksw(
            f"{label} code-4 input ({len(jobs)} jobs, {n4} with code 4)",
            pk, ts, kw, reps=3, phase=phase))
    else:
        log(f"phase {phase} {label} code-4 input ({n4} jobs with code 4): "
            f"the same input as {seen[d][0]}, whose check stands")
    return dict(seen[d][1], jobs_with_n=n4, jobs=len(jobs))


def _p12_indexes(ref):
    """The map-ont, sr and splice indexes of `ref`, each built with the
    pair sort on the card: {preset: (mi, mo, build seconds)}, and the
    FASTA read's seconds."""
    import torch
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    from minimap2_chaindp_tpu_torch.options import set_opt
    t0 = time.perf_counter()
    names, seqs = [], []
    for r in read_fastx(ref):
        names.append(r.name)
        seqs.append(C.seq_to_nt4(r.seq))
    t_read = time.perf_counter() - t0
    out = {}
    for preset in ("map-ont", "sr", "splice"):
        io, mo = set_opt(preset)
        mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR          # -a
        if preset == "splice":
            mo.flag |= C.MM_F_OUT_MD                      # --MD
        t0 = time.perf_counter()
        # (the build empties the list it is given as it copies it)
        mi = build_index(names, list(seqs), io.w, io.k, io.flag,
                         io.bucket_bits, n_threads=os.cpu_count() or 1,
                         device="cuda")
        torch.cuda.synchronize()
        mo.update(mi)
        out[preset] = (mi, mo, time.perf_counter() - t0)
    return out, t_read


def phase_masked(inputs=None, ref=None):
    """Phase 12: phase 4's genome masked and N-gapped, its map-ont, sr and
    splice indexes built on the card, each input mapped by HostRuntime
    and by TorchRuntime under the device and steal routings at -t
    THREADS, byte-identical, each run's launches counted from 0 and its
    largest kernel inputs, and its largest extension launch with a code-4
    base, held against the plain versions. `inputs` is the process of
    _p12_start, joined first; `ref` phase 4's genome (made here when
    None)."""
    import gc
    import torch
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import seeds_device as SD
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    from minimap2_chaindp_tpu_torch.utils import kernel_inputs as KI
    t_phase = time.perf_counter()
    if ref is None:
        ref = _cached(os.path.join(
            SMOKE_DIR, f"genome_{CONTIGS}x{CONTIG_LEN}_s42.fa"),
            lambda p: G.make_genome(p, n_contigs=CONTIGS,
                                    contig_len=CONTIG_LEN, seed=42))
    t0 = time.perf_counter()
    if inputs is not None:
        inputs.join()
        check(inputs.exitcode == 0, "phase 12: making the inputs failed "
              f"(exit code {inputs.exitcode})")
    paths = _p12_inputs(ref)
    t_inputs = time.perf_counter() - t0
    idx, t_read = _p12_indexes(paths["ref"])
    log(f"phase 12 inputs ({t_inputs:.1f} s in this phase), FASTA read "
        f"{t_read:.1f} s; indexes built on the card: " + ", ".join(
            f"{p} {len(mi.keys)} keys {len(mi.values)} positions "
            f"{t:.1f} s" for p, (mi, _mo, t) in idx.items()))
    n_reads, read_len, _err, _seed = P12_READS
    work = {
        "ont": ("map-ont", [paths["ont"]], LANE_BATCH_READS * read_len),
        "sr": ("sr", paths["pairs"], None),
        "splice": ("splice", [paths["tx"]], None)}
    runs, checks, seen = {}, {}, {}
    for kind, (preset, files, batch_bases) in work.items():
        mi, mo, _t = idx[preset]
        if batch_bases is not None:
            mo.mini_batch_size = batch_bases
        batches = list(read_frags(files, mo.mini_batch_size, False))
        frags = [f for b in batches for f in b]
        n = len(frags)
        n4 = sum(1 for f in frags for sg in f.segs
                 if set(sg.seq) - set("ACGTacgt"))
        host = HostRuntime(mi, mo, n_threads=THREADS)
        host.map_batch(frags[:16])
        t0 = time.perf_counter()
        want = [ls for b in host.map_stream(batches) for ls in b]
        t_host = time.perf_counter() - t0
        host.close()
        for routing in ("device", "steal"):
            label = f"{kind}_{routing}"
            rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS,
                              routing=routing)
            rt.map_batch(frags[:16])
            torch.cuda.synchronize()
            for d in (rt.timers.acc, rt.timers.n, rt.timers.counters):
                d.clear()
            _reset_launches()
            with KI.record() as kept:
                t0 = time.perf_counter()
                got = [ls for b in rt.map_stream(batches) for ls in b]
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            launches = _read_launches()
            rt.close()
            n_diff = sum(a != b for a, b in zip(got, want))
            check(len(got) == len(want) == n and n_diff == 0,
                  f"phase 12 {label}: {n_diff} fragments' SAM lines differ "
                  "from HostRuntime")
            c = {k: rt.timers.counters.get(k, 0) for k in P11_COUNTERS}
            share = (c["device_reads"] + c["staged_device_reads"]) / n
            log(f"phase 12 {label}: {sum(map(len, got))} records for {n} "
                f"fragments ({n4} reads with N or an IUPAC code), "
                f"byte-identical to HostRuntime; {n / dt:.1f} a second "
                f"({dt:.2f} s) against HostRuntime {n / t_host:.1f} "
                f"({t_host:.2f} s), -t {THREADS}; chain device share "
                f"{share:.1%}; " + " ".join(f"{k}={v}" for k, v in c.items())
                + f"; launches chain {launches['chain']}, ksw2 "
                f"{launches['ksw']}, walk {launches['walk']}, signal "
                f"{launches['signal']}")
            if kind == "ont" and routing == "device":
                check(share >= 0.9, f"phase 12 {label}: the chain kernel "
                      f"chained {share:.1%} of the reads (< 90%)")
            t0 = time.perf_counter()
            chain, ksw = _p10_check_kept(label, kept, seen, phase=12)
            ksw_n = _check_kept_n(label, kept, seen)
            check((ksw_n is not None) <= (launches["ksw"] > 0),
                  f"phase 12 {label}: a code-4 input kept with no launch")
            checks[label] = (chain, ksw, ksw_n)
            runs[label] = dict(rate=n / dt, host_rate=n / t_host,
                               counters=c, share=share, launches=launches,
                               check_s=time.perf_counter() - t0)
            del rt, kept, got
        del want, frags, batches
    for mi, _mo, _t in idx.values():
        SD.release_device_index(mi, "cuda")
    del idx
    gc.collect()
    torch.cuda.empty_cache()
    n_code4 = sum(k is not None for _c, _k, k in checks.values())
    check(n_code4 > 0, "phase 12: no extension launch on the card held a "
          "code-4 base")
    check(runs["ont_device"]["launches"]["chain"] > 0
          and runs["splice_device"]["launches"]["ksw"] > 0
          and runs["splice_device"]["launches"]["signal"] > 0
          and runs["sr_device"]["launches"]["ksw"] > 0,
          "phase 12: a device run launched none of its kernels")
    check(runs["sr_device"]["launches"]["signal"] == 0,
          "phase 12 sr_device: an extd2 wave launched the splice signal")
    check(runs["splice_device"]["counters"]["ext_long_device"] > 0,
          "phase 12 splice_device: no extension job past 16384 bases ran "
          "on the card")
    launches = {k: sum(r["launches"][k] for r in runs.values())
                for k in ("chain", "ksw", "walk", "signal")}
    secs = time.perf_counter() - t_phase
    log(f"phase 12 done in {secs:.1f} s; launches {launches}; {n_code4} "
        "runs' code-4 extension launches bit-exact; checks "
        + ", ".join(f"{k} {r['check_s']:.1f} s" for k, r in runs.items()))
    return dict(launches=launches, runs=runs, checks=checks, secs=secs)


def phase7_turns(parent: str):
    """Phase 7's stealing runs on phase 4's reads and phase 6's pairs, and
    on phase 11's reads against its 3 Gbp index, in this tree and in
    `parent` (another checkout of the repo) in turns: parent, this, this,
    parent, each in a process of its own started in that tree's root. A
    turn maps each input with HostRuntime, then under the steal routing
    cold (the index tables dropped from the device cache, no warm-up: the
    flow is built during the first batch) and warm (one warm-up batch, as
    phase 7 does), each byte-identical to HostRuntime, and times the
    batches' waits in the device lane's join from outside the runtime
    (Thread.join of the lane's thread), so that both trees are measured
    alike. The 3 Gbp index is built here once and dumped (.mm2i, cached in
    SMOKE_DIR); each turn maps it by mmap. Returns the turns' records."""
    from minimap2_chaindp_tpu_torch.index.serialize import dump_index
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    ref = _cached(os.path.join(
        SMOKE_DIR, f"genome_{CONTIGS}x{CONTIG_LEN}_s42.fa"),
        lambda p: G.make_genome(p, n_contigs=CONTIGS,
                                contig_len=CONTIG_LEN, seed=42))
    reads = _cached(os.path.join(
        SMOKE_DIR, f"reads_{READS}x{READ_LEN}_s5.fa"),
        lambda p: G.simulate(ref, p, READS, READ_LEN, 0.10, seed=5))
    r1 = os.path.join(SMOKE_DIR, f"pairs_{PAIRS}_s11_1.fa")
    r2 = os.path.join(SMOKE_DIR, f"pairs_{PAIRS}_s11_2.fa")
    _cached(r1, lambda p, q: _write_pairs(ref, p, q), r2)
    ref3, reads3, _t, _t = _p11_inputs(GENOME_3G)
    mmi3 = _cached(ref3[:-len(".fa")] + ".mm2i",
                   lambda p: dump_index(_p11_index(ref3)[0], p))
    arg = json.dumps(dict(ref=ref, reads=reads, pairs=[r1, r2],
                          mmi3=mmi3, reads3=reads3,
                          batch=LANE_BATCH_READS * READ_LEN,
                          batch3=LANE_BATCH_READS * P11_READS[1],
                          threads=THREADS))
    turns = []
    for who, root in (("parent", parent), ("change", ROOT),
                      ("change", ROOT), ("parent", parent)):
        p = subprocess.run([sys.executable, "-c", _TURN, arg],
                           cwd=os.path.abspath(root), capture_output=True,
                           text=True, timeout=1200)
        check(p.returncode == 0, f"phase 7 turn in {root} failed: "
              f"{p.stderr[-3000:]}")
        rec = json.loads(p.stdout.strip().splitlines()[-1])
        for label, r in rec.items():
            log(f"phase 7 turns {who} {label}: {r['rate']:.1f} fragments/s "
                f"({r['seconds']:.2f} s); join waits {r['join_ms']:.1f} ms "
                f"over {r['joins']} batches; " + " ".join(
                    f"{k}={v}" for k, v in sorted(r["counters"].items())))
        turns.append(dict(who=who, runs=rec))
    print(json.dumps({"phase7_turns": turns}), flush=True)
    return turns


# one turn of phase7_turns, run with the tree's root as the working
# directory; only what both trees have is used
_TURN = r'''
import json, os, sys, threading, time
sys.path.insert(0, os.getcwd())
import torch
from minimap2_chaindp_tpu_torch import constants as C
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.index.serialize import load_index
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
from minimap2_chaindp_tpu_torch.ops import seeds_device as SD
from minimap2_chaindp_tpu_torch.options import set_opt
a = json.loads(sys.argv[1])
joins = []
real_join = threading.Thread.join
def join(self, *args, **kw):
    t0 = time.perf_counter()
    try:
        return real_join(self, *args, **kw)
    finally:
        if self.name == "mm2tpu-steal":
            joins.append((time.perf_counter() - t0) * 1e3)
threading.Thread.join = join
out = {}
for label, preset, qs, pe, batch in (
        ("reads", "map-ont", [a["reads"]], False, a["batch"]),
        ("pairs", "sr", a["pairs"], True, None),
        ("reads 3 Gbp", "map-ont", [a["reads3"]], False, a["batch3"])):
    io, mo = set_opt(preset)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    if label.endswith("Gbp"):
        mi = load_index(a["mmi3"], mmap=True)
    else:
        recs = list(read_fastx(a["ref"]))
        mi = build_index([r.name for r in recs],
                         [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                         io.flag, io.bucket_bits,
                         n_threads=os.cpu_count() or 1)
        del recs
    mo.update(mi)
    if batch:
        mo.mini_batch_size = batch
    batches = list(read_frags(qs, mo.mini_batch_size, pe))
    frags = [f for b in batches for f in b]
    host = HostRuntime(mi, mo, n_threads=a["threads"])
    want = [ls for b in host.map_stream(batches) for ls in b]
    host.close()
    for cond in ("cold", "warm"):
        SD._DEVICE_INDEX_CACHE.clear()
        torch.cuda.empty_cache()
        rt = TorchRuntime(mi, mo, device="cuda", n_threads=a["threads"],
                          routing="steal")
        if cond == "warm":
            rt.map_batch(frags[:16])
            torch.cuda.synchronize()
            rt.timers.counters.clear()
        del joins[:]
        t0 = time.perf_counter()
        got = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        rt.close()
        if got != want:
            raise SystemExit(f"{label} {cond}: lines differ from HostRuntime")
        c = {k: v for k, v in rt.timers.counters.items()
             if k.startswith("steal_") and not k.startswith("steal_cpu_")}
        out[f"{label} {cond}"] = dict(rate=len(frags) / dt, seconds=dt,
                                      join_ms=sum(joins), joins=len(joins),
                                      counters=c)
        del rt
    del mi
print(json.dumps(out))
'''


def _chain_fields(tag, res):
    """compare_kernel's numbers under the names of one more input."""
    return {f"ms_{tag}": res["ms"], f"plain_ms_{tag}": res["plain_ms"],
            f"bound_ms_{tag}": res["bound_ms"],
            f"bound_by_{tag}": res["bound_by"],
            f"step_ns_{tag}": res["step_ns"], f"form_{tag}": res["form"],
            f"variant_ms_{tag}": res["variant_ms"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("[smoke] FAILED: torch.cuda.is_available() is false; this "
              "smoke runs only on a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    t_all = time.perf_counter()
    p11_inputs = p12_inputs = None
    try:
        p11_inputs = _p11_start()
        card = run_phase("1", phase_env)
        build_s = run_phase("2", phase_build)
        worst, bench, sig = run_phase("3", phase_kernels)
        e2e = run_phase("4", phase_e2e)
        p12_inputs = _p12_start(e2e["ref"])
        spl = run_phase("5", phase_splice, e2e["ref"])
        pe = run_phase("6", phase_paired, e2e["ref"])
        run_phase("7", phase_lanes, e2e, spl, pe)
        rest = run_phase("8", phase_rest, e2e)
        p10 = run_phase("10", phase_presets)
        p11 = run_phase("11", phase_genome, p11_inputs)
        p12 = run_phase("12", phase_masked, p12_inputs, e2e["ref"])
    except Exception:
        traceback.print_exc()
        print("[smoke] FAILED", file=sys.stderr)
        return 1
    finally:
        for proc in (p11_inputs, p12_inputs):
            if proc is not None and proc.is_alive():
                proc.terminate()
                proc.join()
    total_s = time.perf_counter() - t_all
    log(f"done in {total_s:.1f} s on {card}; build {build_s:.2f} s")
    err = max(worst, spl["err"], pe["err"])
    n10 = p10["launches"]
    chain10 = {f"{label}_{mode}": r for label, (ch, _k) in
               p10["checks"].items() for mode, r in ch.items()}
    ksw10 = {label: k for label, (_ch, k) in p10["checks"].items()
             if k is not None}
    n11 = p11["launches"]
    chain11 = {f"{label}_{mode}": r for label, (ch, _k) in
               p11["checks"].items() for mode, r in ch.items()}
    ksw11 = {label: k for label, (_ch, k) in p11["checks"].items()
             if k is not None}
    n12 = p12["launches"]
    chain12 = {f"{label}_{mode}": r for label, (ch, _k, _n) in
               p12["checks"].items() for mode, r in ch.items()}
    ksw12 = {label: k for label, (_ch, k, _n) in p12["checks"].items()
             if k is not None}
    ksw12.update({f"{label}_code4": k for label, (_ch, _k, k)
                  in p12["checks"].items() if k is not None})
    chain_keys = ("err", "ms", "plain_ms", "bound_ms", "bound_by", "form",
                  "anchors")
    ksw_keys = ("err", "ms", "plain_ms", "bound_ms", "bound_by")
    print(json.dumps(timing_record(total_s)), flush=True)
    print(json.dumps({"kernels": [
        {"name": "chain_dp", "route": "cuda", "source": CHAIN_SOURCE,
         "replaces": CHAIN_REPLACES,
         "launches": e2e["launches"] + spl["chain"] + pe["chain"]
         + rest["launches"] + n10["chain"] + n11["chain"] + n12["chain"],
         "launches_phase10": n10["chain"],
         "launches_phase11": n11["chain"],
         "launches_phase12": n12["chain"],
         "max_abs_err": max(worst, e2e["err"], spl["chain_err"],
                            pe["chain_err"], rest["meshes"]["res"]["err"],
                            *(r["err"] for r in chain10.values()),
                            *(r["err"] for r in chain11.values()),
                            *(r["err"] for r in chain12.values())),
         "ms": e2e["ms"],
         "plain_ms": e2e["plain_ms"], "bound_ms": e2e["bound_ms"],
         "bound_by": e2e["bound_by"], "library_ms": None,
         "step_ns": e2e["step_ns"], "form": e2e["form"],
         "variant_ms": e2e["variant_ms"],
         "launches_by_form": {f: e2e["by_form"][f] + spl["chain_by_form"][f]
                              + pe["chain_by_form"][f] + rest["by_form"][f]
                              for f in e2e["by_form"]},
         **_chain_fields("phase5", spl["chain_res"]["cdna"]),
         **_chain_fields("phase6", pe["chain_res"]["many_segs"]),
         **_chain_fields("phase8_mesh", rest["meshes"]["res"]),
         **_chain_fields("bench", bench),
         **_chain_fields("phase11", p11["big"]),
         "anchors_per_s_bench": bench["anchors"] / bench["ms"] * 1e3,
         "checks_phase10": {
             k: {f: r[f] for f in ("err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "form", "anchors")}
             for k, r in chain10.items()},
         "checks_phase11": {
             k: {f: r[f] for f in chain_keys} for k, r in chain11.items()},
         "checks_phase12": {
             k: {f: r[f] for f in chain_keys}
             for k, r in chain12.items()}},
        {"name": "ksw2", "route": "cuda", "source": KSW_SOURCE,
         "replaces": KSW_REPLACES,
         "launches": spl["ksw"] + pe["ksw"] + n10["ksw"] + n11["ksw"]
         + n12["ksw"],
         "launches_phase10": n10["ksw"],
         "launches_phase11": n11["ksw"],
         "launches_phase12": n12["ksw"],
         "max_abs_err": max(err, *(r["err"] for r in [
             *ksw10.values(), *ksw11.values(), *ksw12.values()])),
         "ms": spl["ms"], "plain_ms": spl["plain_ms"],
         "bound_ms": spl["bound_ms"], "bound_by": spl["bound_by"],
         "library_ms": None, "step_ns": spl["step_ns"],
         "variant_ms": spl["variant_ms"],
         "launches_by_variant": {v: spl["by_variant"][v]
                                 + pe["by_variant"][v]
                                 for v in spl["by_variant"]},
         "ms_phase6": pe["ms"], "bound_ms_phase6": pe["bound_ms"],
         "step_ns_phase6": pe["step_ns"],
         "variant_ms_phase6": pe["variant_ms"],
         "checks_phase10": {
             k: {f: r[f] for f in ("err", "ms", "plain_ms", "bound_ms",
                                   "bound_by")}
             for k, r in ksw10.items()},
         "checks_phase11": {
             k: {f: r[f] for f in ksw_keys} for k, r in ksw11.items()},
         "checks_phase12": {
             k: {**{f: r[f] for f in ksw_keys},
                 **({"jobs": r["jobs"], "jobs_with_n": r["jobs_with_n"]}
                    if "jobs_with_n" in r else {})}
             for k, r in ksw12.items()}},
        {"name": "ksw2_walk", "route": "cuda", "source": KSW_SOURCE,
         "replaces": WALK_REPLACES,
         "launches": spl["walk"] + pe["walk"] + n10["walk"] + n11["walk"]
         + n12["walk"],
         "launches_phase10": n10["walk"],
         "launches_phase11": n11["walk"],
         "launches_phase12": n12["walk"],
         "max_abs_err": max(err, *(r["err"] for r in [
             *ksw10.values(), *ksw11.values(), *ksw12.values()])),
         "ms": spl["walk_ms"],
         "plain_ms": spl["walk_plain_ms"],
         "bound_ms": spl["walk_bound_ms"],
         "bound_by": spl["walk_bound_by"], "library_ms": None,
         "step_ns": spl["walk_step_ns"], "ms_phase6": pe["walk_ms"],
         "bound_ms_phase6": pe["walk_bound_ms"],
         "step_ns_phase6": pe["walk_step_ns"],
         "checks_phase10": {k: {"err": r["err"], "ms": r["walk_ms"],
                                "plain_ms": r["walk_plain_ms"],
                                "bound_ms": r["walk_bound_ms"],
                                "bound_by": r["walk_bound_by"]}
                            for k, r in ksw10.items()},
         "checks_phase11": {k: {"err": r["err"], "ms": r["walk_ms"],
                                "plain_ms": r["walk_plain_ms"],
                                "bound_ms": r["walk_bound_ms"],
                                "bound_by": r["walk_bound_by"]}
                            for k, r in ksw11.items()},
         "checks_phase12": {k: {"err": r["err"], "ms": r["walk_ms"],
                                "plain_ms": r["walk_plain_ms"],
                                "bound_ms": r["walk_bound_ms"],
                                "bound_by": r["walk_bound_by"]}
                            for k, r in ksw12.items()}},
        {"name": "ksw_splice_signal", "route": "cuda", "source": KSW_SOURCE,
         "replaces": None,
         "launches": spl["signal"] + pe["signal"] + n10["signal"]
         + n11["signal"] + n12["signal"],
         "launches_phase10": n10["signal"],
         "launches_phase11": n11["signal"],
         "launches_phase12": n12["signal"],
         "max_abs_err": 0, "ms": sig["ms"], "plain_ms": sig["plain_ms"],
         "bound_ms": sig["bound_ms"], "bound_by": sig["bound_by"],
         "library_ms": None, "jobs": sig["jobs"],
         "positions": sig["positions"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
