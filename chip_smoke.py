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
     ksw_cases() (every ez column, every step code, fin (i, j, k));
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
     steal, share, host, device and device with the crossovers of
     utils/route_sweep.py; phase 6's pairs under steal, share and device
     with seed collection on the card; phase 5's transcripts under device
     with the extension crossover. Byte-identical to HostRuntime, the
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
     kernel on both meshes.
  9. the port's bench (`python -m minimap2_chaindp_tpu_torch.bench`) as a
     subprocess: the chain kernel's headline at 8192 x 1024, the native
     host baseline, the end-to-end rows (10 kb, 1 kb, sr pairs, the
     stealing routing; BENCH_E2E_SCALE of their reads, BENCH_STEADY timed
     pairs) and the flow row. Its last line must parse, stay under 2000
     characters, name the card, hold the headline rate, and every pair of
     runs must write the same SAM on the card's lane and the host's; then
     the headline batch is held against the plain version here, and so is
     the largest input of each kernel wrapper that each row and the flow
     row kept (`--keep-inputs`, utils/kernel_inputs.py): the chain kernel
     by mode in every row, the ksw2 forward and walk kernels on the sr
     row's largest extension launch (and any other row's).
In phases 5 and 6 the chain kernel (on the largest input of each of its
modes) and the ksw2 kernels (on the largest launch) are checked and timed
again on the inputs the path gave them.
Each of phases 4-6, each run of phase 7 and each path of phase 8 (entry(),
each timed run of the two meshes, the dry run) sets the launch counters to
0 just before its run and reads them just after; the kernels line counts
phases 4, 5, 6, 8 and 9 (phase 9's processes start from 0 and report
their counts in the bench's record). A mesh's other ranks are processes
of their own, but in a 1 x I mesh rank 0 runs every chain (the index-0
rank of a data row chains it, models/device_pipeline.py).
The second-to-last line is the kernels' JSON record, the last line
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
PAIRS, PAIR_LEN, FRAG_LEN = 5000, 150, (250, 500)
# phase 7: phase 4's reads in batches of this many (so that the stream
# has batches after the first and the stealing lane pulls); the share of
# the flow under the "share" routing, with the JAX runtime's chain
# crossover, whose host lane (5 bases an anchor) takes 10 kb reads; and the
# crossovers that utils/route_sweep.py measured on the H100 (PERF.md §7).
# The runtime's defaults stay at 0
LANE_BATCH_READS = 250
LANE_SHARE = 0.5
LANE_SHARE_CHAIN_MAX = 2048     # anchors
LANE_CHAIN_MAX = 1024           # anchors
LANE_EXT_MAX = 256              # bases of query plus target
# phase 8: the host routing and HostRuntime in turns, ABAB then BABA
HOST_GAP_ORDER = "ABABBABA"
# phase 9: the port's bench at the headline's full shape (8192 x 1024), its
# end-to-end rows cut to a quarter of their reads and 2 timed pairs each
# (the cut keeps the smoke inside its time limit)
BENCH_E2E_SCALE = 0.25
BENCH_STEADY = 2
BENCH_TIMEOUT_S = 600


class SmokeFailure(Exception):
    pass


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


def _spliced_job(rng, flag, n_exons, exon=60, intron=120, err=0.05):
    """A cDNA/genome pair with GT..AG introns (the corpus style of
    tests/test_ksw2_splice_pallas.py)."""
    genome, cdna = [], []
    for i in range(n_exons):
        ex = rng.integers(0, 4, exon + int(rng.integers(0, 30))).tolist()
        genome.extend(ex)
        cdna.extend(c for c in ex if rng.random() > err * 0.5)
        if i != n_exons - 1:
            ilen = intron + int(rng.integers(0, 60))
            genome.extend([2, 3] + rng.integers(0, 4, ilen - 4).tolist()
                          + [0, 2])
    return dict(qseq=np.array(cdna, dtype=np.uint8),
                tseq=np.array(genome, dtype=np.uint8),
                zdrop=int(rng.choice([200, 400])), end_bonus=-1, flag=flag,
                w=-1)


def ksw_cases():
    """(name, jobs, scoring, splice) for the ksw kernel checks; scoring is
    (q, e, q2, e2 or noncan, a, b) from the presets."""
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
    return cases


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
    utils/kernel_inputs.py keeps it)."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    from minimap2_chaindp_tpu_torch.ops.ksw2_ext import TENSOR_KEYS
    pk = KPK.pack_jobs(jobs, splice=splice, noncan=noncan)
    ts = {k: torch.from_numpy(pk[k]).to(device) for k in TENSOR_KEYS}
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
    n_in = sum(pk[k].nbytes for k in ("tseq", "qrev", "dac", "meta", "poff",
                                      "order"))
    fwd = _bound(n_in + p_out + ez_h.nbytes, n_ops)
    steps = ez_h[:, KPK.C_FIN_K].astype(np.int64)
    walk = _bound(2 * int(steps.sum()) + meta.nbytes + ez_h.nbytes,
                  int(steps.sum()) * WALK_OPS_PER_STEP)
    return fwd + (cells,), walk + (int(steps.sum()),), int(steps.max())


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
    args = [ts[k] for k in KE.TENSOR_KEYS]
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
    (_p_ref, ez_ref), plain_ms = _timed(
        lambda: KE.ksw_forward_ref(*args[:5], **{
            k: v for k, v in kw.items() if k != "groups"}))
    ez_wr = ez.clone()
    ops_ref, walk_plain = _timed(lambda: KE.ksw_walk_ref(
        p, ts["poff"], ts["meta"], ez_wr, **wkw))
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
    return worst, bench


# ---------------------------------------------------------------- phase 4
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

    t0 = time.perf_counter()
    TorchRuntime(mi, mo, device="cuda", n_threads=THREADS) \
        .map_batch(warm)          # uploads the index, warms the allocator
    torch.cuda.synchronize()
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


def _write_spliced(ref, out_ref, out_reads, seed=7):
    """A copy of `ref` with GENES gene loci patched in (EXONS exons of
    EXON_LEN bp, INTRON_LEN bp introns with GT..AG at their edges) and
    TRANSCRIPTS cDNA reads from them (each gene's full transcript and one
    that skips an internal exon) at SPLICE_ERR error, half reverse
    complemented. The tools/diff_sweep.py:86-120 idea at genome scale."""
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    recs = [(r.name, bytearray(r.seq.encode())) for r in read_fastx(ref)]
    per = -(-GENES // len(recs))
    loci = []
    for g in range(GENES):
        ci = g % len(recs)
        seq = recs[ci][1]
        slot = len(seq) // per
        n_ex = int(rng.integers(*EXONS))
        exl = rng.integers(*EXON_LEN, n_ex)
        inl = rng.integers(*INTRON_LEN, n_ex - 1)
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
    comp = str.maketrans("ACGT", "TGCA")
    with open(out_reads, "w") as f:
        for t in range(TRANSCRIPTS):
            ci, exons = loci[t % GENES]
            if t >= GENES:   # the second transcript skips an internal exon
                drop = int(rng.integers(1, len(exons) - 1))
                exons = exons[:drop] + exons[drop + 1:]
            seq = recs[ci][1]
            s = _mutate(rng, b"".join(seq[a:b] for a, b in exons).decode(),
                        SPLICE_ERR)
            if rng.random() < 0.5:
                s = s[::-1].translate(comp)
            f.write(f">tx{t}!{recs[ci][0]}!{exons[0][0]}\n{s}\n")


def _write_pairs(ref, out1, out2, seed=11):
    """PAIRS read pairs of PAIR_LEN bp in FR orientation from fragments of
    FRAG_LEN bp, at 1% substitutions and indels."""
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    recs = [(r.name, r.seq) for r in read_fastx(ref)]
    comp = str.maketrans("ACGT", "TGCA")
    with open(out1, "w") as f1, open(out2, "w") as f2:
        for i in range(PAIRS):
            name, seq = recs[int(rng.integers(0, len(recs)))]
            fl = int(rng.integers(*FRAG_LEN))
            st = int(rng.integers(0, len(seq) - fl))
            fr = seq[st:st + fl]
            r1 = _mutate(rng, fr[:PAIR_LEN], 0.01)
            r2 = _mutate(rng, fr[-PAIR_LEN:], 0.01)[::-1].translate(comp)
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
    RT.TorchRuntime(mi, mo, device="cuda", n_threads=THREADS) \
        .map_batch(warm)
    torch.cuda.synchronize()
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
    TD.chain_scores_batch.launches = 0
    TD.chain_scores_batch.by_form = dict.fromkeys(TD.FORMS, 0)
    KE.ksw_forward.launches = KE.ksw_walk.launches = 0
    KE.ksw_forward.by_variant = dict.fromkeys(KE.ksw_forward.by_variant, 0)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        port_lines = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    finally:
        RT.chain_scores_batch, KE.pack_jobs = real_chain, real_pack
    rec.update(chain=TD.chain_scores_batch.launches,
               chain_by_form=dict(TD.chain_scores_batch.by_form),
               ksw=KE.ksw_forward.launches, walk=KE.ksw_walk.launches,
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
    log(f"phase {phase} extension jobs: {ex.n_device} on the card, "
        f"{ex.n_native} native, {ex.n_host} numpy model; ksw forward "
        f"launches {rec['ksw']} {rec['by_variant']}, walk launches "
        f"{rec['walk']} (p budget "
        f"{KE.P_BUDGET} B per launch); chain kernel launches "
        f"{rec['chain']} {rec['modes']} {rec['chain_by_form']}")
    log(f"phase {phase} port stages (host wall clock): "
        f"{rt.timers.summary()}")
    log(f"phase {phase} device memory: max_memory_allocated {rec['peak']} B")
    check(rec["ksw"] > 0 and rec["walk"] > 0,
          f"phase {phase}: the ksw kernels were not launched")
    for v in sorted(rec["planned"]):
        check(rec["by_variant"][v] > 0, f"phase {phase}: the waves held "
              f"jobs for the {v} forward variant, which never launched")
    rec.update(jobs=n_jobs, jobs_device=ex.n_device, mi=mi, mo=mo,
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
    res = compare_ksw(f"main-path input ({len(jobs)} jobs)", pk, ts, kw,
                      reps=3, phase=phase)
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
                 "steal_dev_fallback", "fast_native", "native_finish",
                 "staged_frags", "host_chain", "device_seed", "host_seed",
                 "ext_device", "ext_native")


def _lane_run(label, mi, mo, batches, host_lines, t_host, **kw):
    """One routing over `batches` at -t THREADS: a warm-up batch, then the
    counters (the runtime's and the kernels' launches) set to 0, the timed
    map_stream and the counters read. Checks the lines against
    HostRuntime's. Returns a dict of the run's numbers."""
    import torch
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    frags = [f for b in batches for f in b]
    rt = TorchRuntime(mi, mo, device="cuda", n_threads=THREADS, **kw)
    rt.map_batch(frags[:16])
    torch.cuda.synchronize()
    for d in (rt.timers.acc, rt.timers.n, rt.timers.counters):
        d.clear()
    ex = rt.align_exec
    ex.n_device = ex.n_native = ex.n_host = 0
    TD.chain_scores_batch.launches = 0
    KE.ksw_forward.launches = KE.ksw_walk.launches = 0
    t0 = time.perf_counter()
    lines = [ls for b in rt.map_stream(batches) for ls in b]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rt.close()
    launches = dict(chain=TD.chain_scores_batch.launches,
                    ksw=KE.ksw_forward.launches, walk=KE.ksw_walk.launches)
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
        f"walk {launches['walk']}; lane CPU {cpu}")
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
    runs["A"].close()
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
    return dict(launches=launches, by_form=by_form, index=idx,
                meshes=meshes, gap=gap)


# ---------------------------------------------------------------- phase 9
def phase_bench():
    """The port's bench (minimap2_chaindp_tpu_torch/bench.py) as a
    subprocess: its record must parse, stay under 2000 characters, name
    the card, hold a headline rate and every pair row's SAM equal on both
    lanes. The bench process counts its launches from 0 (each row and the
    flow row in processes of their own) and reports them in its record;
    they are phase 9's. Each row and the flow row keep the largest input
    of each kernel wrapper (--keep-inputs): here every one of them, and
    the headline batch, is held against the plain version (comparison
    launches, not counted)."""
    import shutil
    import torch
    from minimap2_chaindp_tpu_torch import bench as B
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.utils import kernel_inputs as KI
    t0 = time.perf_counter()
    keep = os.path.join(SMOKE_DIR, "bench_inputs")
    shutil.rmtree(keep, ignore_errors=True)
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.bench",
         "--e2e-scale", str(BENCH_E2E_SCALE), "--steady", str(BENCH_STEADY),
         "--keep-inputs", keep],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, cwd=ROOT)
    for line in out.stderr.splitlines():
        if line.startswith("[bench]"):
            log(f"phase 9 {line}")
    check(out.returncode == 0, f"phase 9: the bench exited "
          f"{out.returncode}: {out.stderr.strip()[-2000:]}")
    last = out.stdout.strip().splitlines()[-1]
    check(len(last) < 2000, f"phase 9: the record has {len(last)} chars")
    rec = json.loads(last)
    log(f"phase 9 record: {last}")
    check(rec["device"]["platform"] == "gpu" and rec["device"]["power_limit"],
          f"phase 9: the record's device is {rec['device']}")
    check(rec["metric"] == "chaindp_anchors_per_s" and rec["value"]
          and rec["baseline_host_native_1core"]
          and rec["check_batch1"] == "bit-exact",
          "phase 9: no headline rate, baseline or batch check")
    pairs = f"{BENCH_STEADY + 1}/{BENCH_STEADY + 1}"
    for row in B.E2E_ROWS:
        check(rec[f"{row}_sam_identical"] == pairs
              and rec[f"{row}_cuda_vs_host_paired_ratio"] is not None,
              f"phase 9: row {row} is incomplete")
    check(rec["flow_measured_reads_per_s"] is not None,
          "phase 9: no flow row")
    n = rec["launches"]
    check(n["chain"] > 0 and n["ksw"] > 0 and n["walk"] > 0,
          f"phase 9: the bench's paths launched {n}")
    secs_bench = time.perf_counter() - t0
    args, use_exc = B.headline_batch(B.N_READS, 1, torch.device("cuda"))
    got = B.dispatch(args, use_exc)
    want, plain_ms = _timed(lambda: TD.chain_scores_batch_ref(
        *args, **B.CHAIN_KW, use_exc=use_exc))
    for label, g, w in zip(("f", "p", "flag"), got, want):
        check(torch.equal(g, w), f"phase 9: the headline batch's {label} "
              "differs from the plain version")
    del args, got, want
    # every row's largest kernel inputs against the plain versions
    chain, ksw = {}, {}
    for row in [*B.E2E_ROWS, "flow"]:
        kept = KI.load(os.path.join(keep, row), "cuda")
        check(any(k.startswith("chain_") for k in kept),
              f"phase 9: row {row} kept no chain input")
        for name, val in kept.items():
            if name == "ksw":
                pk, ts, kw = packed_ksw_inputs(
                    val["jobs"], val["scoring"], val["splice"],
                    val["noncan"], "cuda")
                ksw[row] = compare_ksw(
                    f"{row} input ({len(val['jobs'])} jobs)", pk, ts, kw,
                    reps=3, phase=9)
                continue
            ts, kw = val
            mode = name[len("chain_"):]
            chain[f"{row}_{mode}"] = compare_kernel(
                f"{row} {mode} input R={ts[1].shape[0]} "
                f"max_n={kw['max_n']}", ts, kw, reps=3, phase=9)
    check("e2e_sr150" in ksw, "phase 9: the sr row kept no extension "
          "launch")
    secs = time.perf_counter() - t0
    log(f"phase 9 bench: {rec['value'] / 1e6:.1f} M anchors/s (pipeline "
        f"{rec['pipeline_ms']} ms host clock, {rec['pipeline_device_ms']} ms "
        f"CUDA events), baseline {rec['baseline_host_native_1core'] / 1e6:.2f}"
        f" M anchors/s; headline batch bit-exact against the plain version "
        f"({plain_ms:.1f} ms); every pair row's SAM identical on both lanes "
        f"({pairs}); the rows' largest inputs bit-exact: chain "
        f"{sorted(chain)}, ksw2 and walk {sorted(ksw)}; launches {n}; "
        f"bench {secs_bench:.1f} s, phase {secs:.1f} s")
    return dict(launches=n, secs=secs, chain=chain, ksw=ksw)


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
    try:
        card = phase_env()
        build_s = phase_build()
        worst, bench = phase_kernels()
        e2e = phase_e2e()
        spl = phase_splice(e2e["ref"])
        pe = phase_paired(e2e["ref"])
        phase_lanes(e2e, spl, pe)
        rest = phase_rest(e2e)
        bench9 = phase_bench()
    except Exception:
        traceback.print_exc()
        print("[smoke] FAILED", file=sys.stderr)
        return 1
    log(f"done in {time.perf_counter() - t_all:.1f} s on {card}; "
        f"build {build_s:.2f} s")
    err = max(worst, spl["err"], pe["err"])
    print(json.dumps({"kernels": [
        {"name": "chain_dp", "route": "cuda", "source": CHAIN_SOURCE,
         "replaces": CHAIN_REPLACES,
         "launches": e2e["launches"] + spl["chain"] + pe["chain"]
         + rest["launches"] + bench9["launches"]["chain"],
         "launches_phase9": bench9["launches"]["chain"],
         "max_abs_err": max(worst, e2e["err"], spl["chain_err"],
                            pe["chain_err"], rest["meshes"]["res"]["err"],
                            *(r["err"] for r in bench9["chain"].values())),
         "ms": e2e["ms"],
         "plain_ms": e2e["plain_ms"], "bound_ms": e2e["bound_ms"],
         "bound_by": e2e["bound_by"], "library_ms": None,
         "step_ns": e2e["step_ns"], "form": e2e["form"],
         "variant_ms": e2e["variant_ms"],
         "launches_by_form": {f: e2e["by_form"][f] + spl["chain_by_form"][f]
                              + pe["chain_by_form"][f] + rest["by_form"][f]
                              + bench9["launches"][f]
                              for f in e2e["by_form"]},
         **_chain_fields("phase5", spl["chain_res"]["cdna"]),
         **_chain_fields("phase6", pe["chain_res"]["many_segs"]),
         **_chain_fields("phase8_mesh", rest["meshes"]["res"]),
         **_chain_fields("bench", bench),
         "anchors_per_s_bench": bench["anchors"] / bench["ms"] * 1e3,
         "checks_phase9": {
             k: {f: r[f] for f in ("err", "ms", "plain_ms", "bound_ms",
                                   "bound_by", "form", "anchors")}
             for k, r in bench9["chain"].items()}},
        {"name": "ksw2", "route": "cuda", "source": KSW_SOURCE,
         "replaces": KSW_REPLACES,
         "launches": spl["ksw"] + pe["ksw"] + bench9["launches"]["ksw"],
         "launches_phase9": bench9["launches"]["ksw"],
         "max_abs_err": max(err, *(r["err"]
                                   for r in bench9["ksw"].values())),
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
         "checks_phase9": {
             k: {f: r[f] for f in ("err", "ms", "plain_ms", "bound_ms",
                                   "bound_by")}
             for k, r in bench9["ksw"].items()}},
        {"name": "ksw2_walk", "route": "cuda", "source": KSW_SOURCE,
         "replaces": WALK_REPLACES,
         "launches": spl["walk"] + pe["walk"] + bench9["launches"]["walk"],
         "launches_phase9": bench9["launches"]["walk"],
         "max_abs_err": max(err, *(r["err"]
                                   for r in bench9["ksw"].values())),
         "ms": spl["walk_ms"],
         "plain_ms": spl["walk_plain_ms"],
         "bound_ms": spl["walk_bound_ms"],
         "bound_by": spl["walk_bound_by"], "library_ms": None,
         "step_ns": spl["walk_step_ns"], "ms_phase6": pe["walk_ms"],
         "bound_ms_phase6": pe["walk_bound_ms"],
         "step_ns_phase6": pe["walk_step_ns"],
         "checks_phase9": {k: {"err": r["err"], "ms": r["walk_ms"],
                               "plain_ms": r["walk_plain_ms"],
                               "bound_ms": r["walk_bound_ms"],
                               "bound_by": r["walk_bound_by"]}
                           for k, r in bench9["ksw"].items()}}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
