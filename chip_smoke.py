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
     extd2 and many_segs chain launches.
In phases 5 and 6 the chain kernel (on the largest input of each of its
modes) and the ksw2 kernels (on the largest launch) are checked and timed
again on the inputs the path gave them.
Each of phases 4-6 sets the launch counters to 0 just before its run and
reads them just after.
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
FIELDS = ("xhi", "rpos", "qpos", "span", "sid", "stw")

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
    from minimap2_chaindp_tpu import native
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


def _pack(batch, max_dist_x, max_n):
    from minimap2_chaindp_tpu_torch.ops.chain_host import split_anchors
    from minimap2_chaindp_tpu_torch.ops.chain_pack import pack_reads
    reads = []
    for a in batch:
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(len(a))))
    packed, nn, w1, exc, host_flag = pack_reads(reads, max_n, max_dist_x)
    check(not host_flag.any(), "corpus read needs the host path")
    return [packed[k] for k in FIELDS] + [nn, w1, exc]


def kernel_cases():
    """(name, numpy inputs, kwargs) for the listed kernel checks."""
    from minimap2_chaindp_tpu.options import set_opt
    from minimap2_chaindp_tpu.utils.synth import synth_batch
    _, ont = set_opt("map-ont")
    _, sr = set_opt("sr")
    _, spl = set_opt("splice")
    single = dict(max_dist_x=ont.max_gap, max_dist_y=ont.max_gap, bw=ont.bw,
                  max_skip=ont.max_chain_skip, is_cdna=False,
                  many_segs=False)
    cases = []
    for max_n, seed in ((1024, 1), (4096, 2)):
        arrs = _pack(synth_batch(64, max_n - 100, seed=seed),
                     single["max_dist_x"], max_n)
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
    cases.append(("many_segs R=16 max_n=512", _pack(batch, 800, 512),
                  dict(max_n=512, max_dist_x=800, max_dist_y=600, bw=sr.bw,
                       max_skip=sr.max_chain_skip, is_cdna=False,
                       many_segs=True, use_exc=True)))
    rng = np.random.default_rng(3)
    batch = [_anchors(rng, int(rng.integers(200, 500)), big_gaps=True)
             for _ in range(16)]
    cases.append(("is_cdna R=16 max_n=512", _pack(batch, 200000, 512),
                  dict(max_n=512, max_dist_x=200000, max_dist_y=2000,
                       bw=spl.bw, max_skip=spl.max_chain_skip, is_cdna=True,
                       many_segs=False, use_exc=True)))
    rng = np.random.default_rng(11)
    batch = [_anchors(rng, int(rng.integers(150, 500)),
                      noise=0.5 if r % 2 else 0.0) for r in range(16)]
    cases.append(("flagged R=16 max_n=512 max_skip=2",
                  _pack(batch, single["max_dist_x"], 512),
                  dict(single, max_n=512, max_skip=2, use_exc=True)))
    # f row in device memory (max_n beyond the shared-memory limit)
    cases.append(("single R=8 max_n=9216 (f in global memory)",
                  _pack(synth_batch(8, 9000, seed=5), single["max_dist_x"],
                        9216), dict(single, max_n=9216, use_exc=True)))
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


def compare_kernel(name, ts, kw, reps=20, phase=3):
    """Kernel vs plain version on the same card tensors: bit-exact f, p and
    flag, then CUDA-event times. Returns (max_abs_err, ms, plain_ms,
    n_flagged)."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    before = TD.chain_scores_batch.launches
    got = TD.chain_scores_batch(*ts, **kw)
    want = TD.chain_scores_batch_ref(*ts, **kw)
    torch.cuda.synchronize()
    check(TD.chain_scores_batch.launches == before + 1,
          f"{name}: the launch counter did not move")
    err = max(int((g.long() - w.long()).abs().max()) for g, w in
              zip(got, want))
    for label, g, w in zip(("f", "p", "flag"), got, want):
        check(g.shape == w.shape and torch.equal(g, w),
              f"{name}: kernel {label} differs from the plain version "
              f"(max abs err {err})")
    ms = _time_ms(lambda: TD.chain_scores_batch(*ts, **kw), reps)
    plain_ms = _time_ms(lambda: TD.chain_scores_batch_ref(*ts, **kw), 1,
                        warm=False)
    n_flag = int(got[2][:, 0].sum())
    log(f"phase {phase} {name}: bit-exact (f, p, flag; {n_flag} flagged); "
        f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    return err, ms, plain_ms, n_flag


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
    from minimap2_chaindp_tpu.ops import ksw2 as K
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
    from minimap2_chaindp_tpu.ops import ksw2 as K
    from minimap2_chaindp_tpu.options import set_opt

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
    """pack_jobs' arrays as tensors on `device` plus the launch keywords."""
    import torch
    from minimap2_chaindp_tpu.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    q, e, q2, e2n, a, b = scoring
    pk = KPK.pack_jobs(jobs, splice=splice, noncan=e2n if splice else 0)
    qq, ee, qq2, ee2, lt, ld = KPK.gap_params(q, e, q2, 0 if splice else e2n,
                                              splice)
    mat = K.gen_simple_mat(5, a, b)
    ts = {k: torch.from_numpy(pk[k]).to(device)
          for k in ("tseq", "qrev", "dac", "meta", "poff")}
    kw = dict(scoring=(qq, ee, qq2, ee2, int(mat[0]), int(mat[1]),
                       -ee if splice else -ee2, lt, ld),
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


def compare_ksw(name, pk, ts, kw, reps=5, phase=3):
    """ksw forward kernel and walk kernel against their plain versions on
    the same card tensors: bit-exact ez rows, step codes and fin (i, j, k),
    and CUDA-event times (the plain versions timed on their one comparison
    run). Returns (max_abs_err, fwd ms, fwd plain ms, walk ms, walk plain
    ms)."""
    import torch
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    args = [ts[k] for k in ("tseq", "qrev", "dac", "meta", "poff")]
    wkw = dict(splice=kw["splice"], ops_total=pk["ops_total"])
    before = (KE.ksw_forward.launches, KE.ksw_walk.launches)
    p, ez = KE.ksw_forward(*args, **kw)
    ez_w = ez.clone()
    ops = KE.ksw_walk(p, ts["poff"], ts["meta"], ez_w, **wkw)
    torch.cuda.synchronize()
    check((KE.ksw_forward.launches, KE.ksw_walk.launches)
          == (before[0] + 1, before[1] + 1),
          f"{name}: the launch counters did not move")
    (_p_ref, ez_ref), plain_ms = _timed(
        lambda: KE.ksw_forward_ref(*args, **kw))
    ez_wr = ez.clone()
    ops_ref, walk_plain = _timed(lambda: KE.ksw_walk_ref(
        p, ts["poff"], ts["meta"], ez_wr, **wkw))
    err = int((ez.long() - ez_ref.long()).abs().max())
    check(torch.equal(ez, ez_ref), f"{name}: kernel ez rows differ from "
          f"the plain version (max abs err {err})")
    fin = slice(KPK.C_FIN_I, KPK.C_FIN_K + 1)
    err_w = int((ez_w[:, fin].long() - ez_wr[:, fin].long()).abs().max())
    check(torch.equal(ez_w, ez_wr), f"{name}: walk fin (i, j, k) differs "
          f"from the plain version (max abs err {err_w})")
    ops_h, ops_rh = ops.cpu().numpy(), ops_ref.cpu().numpy()
    ez_h = ez_w.cpu().numpy()
    n_steps = 0
    for j, o in enumerate(pk["meta"][:, KPK.M_OPOFF]):
        k = int(ez_h[j, KPK.C_FIN_K])
        n_steps += k
        a, b = ops_h[o:o + k].astype(int), ops_rh[o:o + k].astype(int)
        if not (a == b).all():
            err_w = max(err_w, int(abs(a - b).max()))
            check(False, f"{name}: job {j} walk step codes differ from the "
                  f"plain version (max abs err {err_w})")
    ms = _time_ms(lambda: KE.ksw_forward(*args, **kw), reps)
    walk_ms = _time_ms(lambda: KE.ksw_walk(p, ts["poff"], ts["meta"],
                                           ez.clone(), **wkw), reps)
    cells = int((pk["meta"][:, KPK.M_QLEN].astype(np.int64)
                 * pk["meta"][:, KPK.M_TLEN]).sum())
    log(f"phase {phase} ksw {name}: {len(pk['meta'])} jobs, {n_steps} walk "
        f"steps, bit-exact (ez, step codes, fin); forward {ms:.3f} ms "
        f"(plain {plain_ms:.1f} ms), walk {walk_ms:.3f} ms (plain "
        f"{walk_plain:.1f} ms); {cells} q x t cells, {pk['p_bytes']} p "
        f"bytes, {pk['rows_max']} rows, band {kw['band_max']}")
    return max(err, err_w), ms, plain_ms, walk_ms, walk_plain


def phase_kernels():
    import torch
    worst, flagged = 0, 0
    for name, arrs, kw in kernel_cases():
        ts = [torch.from_numpy(a).cuda() for a in arrs]
        err, _ms, _plain, n_flag = compare_kernel(name, ts, kw)
        worst = max(worst, err)
        if "flagged" in name:
            flagged = n_flag
    check(flagged > 0, "the flagged corpus flagged no read")
    for name, jobs, scoring, splice in ksw_cases():
        pk, ts, kw = ksw_inputs(jobs, scoring, splice, "cuda")
        worst = max(worst, compare_ksw(name, pk, ts, kw)[0])
    return worst


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
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import genome_scale as G
    from minimap2_chaindp_tpu import constants as C
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu.options import set_opt
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
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        port_lines = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    finally:
        DF.chain_scores_batch = real
    launches = TD.chain_scores_batch.launches
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
        f"{launches}")
    log(f"phase 4 port stages (host wall clock): {rt.timers.summary()}")
    log(f"phase 4 device memory: index tables {dx.nbytes()} B "
        f"(upload + warm-up {t_up:.1f} s), max_memory_allocated {peak} B")
    check(launches > 0, "the main path launched no chain kernel")
    check(c["device_reads"] >= 0.9 * n_reads,
          f"only {c['device_reads']} of {n_reads} reads chained on the card")
    err, ms, plain_ms, _ = compare_kernel(
        "main-path input R={} max_n={}".format(
            biggest["args"][1].shape[0], biggest["kw"]["max_n"]),
        biggest["args"], biggest["kw"], reps=5, phase=4)
    return dict(launches=launches, err=err, ms=ms, plain_ms=plain_ms,
                ref=ref)


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
    from minimap2_chaindp_tpu.io.fastx import read_fastx
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
    from minimap2_chaindp_tpu.io.fastx import read_fastx
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
    from minimap2_chaindp_tpu import constants as C
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    from minimap2_chaindp_tpu.options import set_opt
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
    from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
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
    rec = dict(modes={}, chain_in={}, biggest=None, cells=-1)
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
        return pk
    RT.chain_scores_batch, KE.pack_jobs = chain, pack
    TD.chain_scores_batch.launches = 0
    KE.ksw_forward.launches = KE.ksw_walk.launches = 0
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        port_lines = [ls for b in rt.map_stream(batches) for ls in b]
        torch.cuda.synchronize()
        t_port = time.perf_counter() - t0
    finally:
        RT.chain_scores_batch, KE.pack_jobs = real_chain, real_pack
    rec.update(chain=TD.chain_scores_batch.launches,
               ksw=KE.ksw_forward.launches, walk=KE.ksw_walk.launches,
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
        f"launches {rec['ksw']}, walk launches {rec['walk']} (p budget "
        f"{KE.P_BUDGET} B per launch); chain kernel launches "
        f"{rec['chain']} {rec['modes']}")
    log(f"phase {phase} port stages (host wall clock): "
        f"{rt.timers.summary()}")
    log(f"phase {phase} device memory: max_memory_allocated {rec['peak']} B")
    check(rec["ksw"] > 0 and rec["walk"] > 0,
          f"phase {phase}: the ksw kernels were not launched")
    rec.update(jobs=n_jobs, jobs_device=ex.n_device)
    return host_lines, port_lines, rt, rec


def _main_path_kernels(phase, rec, scoring):
    """Check and time the chain kernel on the largest input of each mode
    the path ran, and the ksw kernels on the largest launch the path
    made. Returns rec with the chain's worst error and the ksw numbers
    (err, ms, plain_ms, walk_ms, walk_plain_ms)."""
    chain_err = 0
    for mode, (_size, args, kw) in sorted(rec["chain_in"].items()):
        err, _ms, _plain, _ = compare_kernel(
            f"main-path {mode} input R={args[1].shape[0]} "
            f"max_n={kw['max_n']}", args, kw, reps=3, phase=phase)
        chain_err = max(chain_err, err)
    jobs, splice = rec["biggest"]
    pk, ts, kw = ksw_inputs(jobs, scoring, splice, "cuda")
    err, ms, plain, wms, wplain = compare_ksw(
        f"main-path input ({len(jobs)} jobs)", pk, ts, kw, reps=3,
        phase=phase)
    return dict(rec, chain_err=chain_err, err=err, ms=ms, plain_ms=plain,
                walk_ms=wms, walk_plain_ms=wplain)


def phase_splice(ref):
    t0 = time.perf_counter()
    sref = os.path.join(SMOKE_DIR, f"genome_{CONTIGS}x{CONTIG_LEN}_s42"
                        f"_genes{GENES}_s7.fa")
    reads = os.path.join(SMOKE_DIR, f"transcripts_{TRANSCRIPTS}_s7.fa")
    _cached(sref, lambda p, q: _write_spliced(ref, p, q), reads)
    from minimap2_chaindp_tpu.io.fastx import read_frags
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
    from minimap2_chaindp_tpu.io.fastx import read_frags
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
        worst = phase_kernels()
        e2e = phase_e2e()
        spl = phase_splice(e2e["ref"])
        pe = phase_paired(e2e["ref"])
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
         "launches": e2e["launches"] + spl["chain"] + pe["chain"],
         "max_abs_err": max(worst, e2e["err"], spl["chain_err"],
                            pe["chain_err"]), "ms": e2e["ms"],
         "plain_ms": e2e["plain_ms"]},
        {"name": "ksw2", "route": "cuda", "source": KSW_SOURCE,
         "replaces": KSW_REPLACES, "launches": spl["ksw"] + pe["ksw"],
         "max_abs_err": err, "ms": spl["ms"], "plain_ms": spl["plain_ms"]},
        {"name": "ksw2_walk", "route": "cuda", "source": KSW_SOURCE,
         "replaces": WALK_REPLACES, "launches": spl["walk"] + pe["walk"],
         "max_abs_err": err, "ms": spl["walk_ms"],
         "plain_ms": spl["walk_plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
