"""Times the ksw2 forward kernel's launch plans against each other on
synthetic waves, on one CUDA device:

  python -m minimap2_chaindp_tpu_torch.utils.ksw_sweep    (from the repo root)

`block_threads` in ops/ksw2_pack.py and the shape of `launch_plan` were
chosen from this script's output; run it again before changing them. Three
waves: a short-read one (9397 jobs of at most 150 bases, the size of the
largest launch of chip_smoke.py's paired-end phase), a splice one (2702
jobs: query pieces of 20-330 bases against targets of up to 16 kb, the
shape of its splice phase) and 64 jobs of 10 kb at w=500. For each: the
device-memory kernel, the plan the wrapper makes, everything in one
block-per-job launch, and one launch per ring size one after the other
(with half a ring and a whole ring of threads); each checked against the
first for equal ez rows, and all timed in turns (the median of `ROUNDS`
rounds, each call between CUDA events of its own). Then the walk. It uses
chip_smoke.py's helpers and prints one line per plan.
"""
from __future__ import annotations

import sys

import numpy as np

ROUNDS = 7


def _mut(rng, t, sub=0.03, ind=0.01):
    r = rng.random(len(t))
    q = t.copy()
    m = r < sub
    q[m] = rng.integers(0, 4, int(m.sum()))
    q = q[~((r >= sub) & (r < sub + ind))]
    return q if len(q) else np.array([0], np.uint8)


def short_read_wave(K, n=9397):
    rng = np.random.default_rng(1)
    flags = (0, K.KSW_EZ_EXTZ_ONLY,
             K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR)
    jobs = []
    for _ in range(n):
        t = rng.integers(0, 4, int(min(150, max(8, rng.exponential(40)))))
        flag = int(rng.choice(flags))
        jobs.append(dict(qseq=_mut(rng, t.astype(np.uint8)),
                         tseq=t.astype(np.uint8), w=151, zdrop=100,
                         end_bonus=10 if flag else -1, flag=flag))
    return jobs


def splice_wave(K, n=2702):
    rng = np.random.default_rng(3)
    jobs = []
    for k in range(n):
        ql = int(rng.integers(20, 330))
        ex = rng.integers(0, 4, ql).astype(np.uint8)
        t = ex
        if rng.random() < 0.6:   # an intron with GT..AG at its edges
            il = int(rng.integers(100, 16000 if k % 20 == 0 else 6000))
            t = np.concatenate([ex[:ql // 2], [2, 3],
                                rng.integers(0, 4, il - 4), [0, 2],
                                ex[ql // 2:]]).astype(np.uint8)
        jobs.append(dict(qseq=_mut(rng, ex), tseq=t, zdrop=200, end_bonus=-1,
                         flag=K.KSW_EZ_SPLICE_FOR, w=-1))
    return jobs


def by_ring(KPK, meta, threads_of):
    """One block-per-job launch per ring size, widest first (jobs past
    shared memory need the device-memory kernel: none in these waves)."""
    rows = meta[:, KPK.M_QLEN].astype(np.int64) + meta[:, KPK.M_TLEN] - 1
    by_len = np.argsort(-rows, kind="stable").astype(np.int32)
    rings = KPK.ring_of(meta[:, KPK.M_LANES])
    order, groups = [], []
    for ring in sorted(set(rings), reverse=True):
        idx = by_len[rings[by_len] == ring]
        groups.append(dict(variant="block", ring=int(ring),
                           threads=threads_of(int(ring)),
                           start=sum(map(len, order)), count=len(idx)))
        order.append(idx)
    return np.concatenate(order).astype(np.int32), groups


def sweep(name, jobs, scoring, splice):
    import torch

    import chip_smoke as S
    from ..ops import ksw2_ext as KE
    from ..ops import ksw2_pack as KPK
    pk, ts, kw = S.ksw_inputs(jobs, scoring, splice, "cuda")
    args = [ts[k] for k in KE.FORWARD_KEYS]
    meta = pk["meta"]
    rows = meta[:, KPK.M_QLEN] + meta[:, KPK.M_TLEN] - 1
    print(f"== {name}: {len(jobs)} jobs, rows max {rows.max()} mean "
          f"{rows.mean():.0f}, lanes max {meta[:, KPK.M_LANES].max()} mean "
          f"{meta[:, KPK.M_LANES].mean():.0f}, p {pk['p_bytes'] / 1e6:.0f} "
          "MB", flush=True)
    plans = [("device memory", lambda: KPK.launch_plan(meta, "global")),
             ("as planned", lambda: (pk["order"], pk["groups"])),
             ("one block launch", lambda: KPK.launch_plan(meta, "block")),
             ("by ring, ring/2 threads", lambda: by_ring(
                 KPK, meta, KPK.block_threads)),
             ("by ring, ring threads", lambda: by_ring(
                 KPK, meta, lambda r: min(KPK.MAX_THREADS, max(64, r))))]
    ref, runs, shapes = None, {}, {}
    for label, make in plans:
        try:
            order, groups = make()
        except ValueError:
            continue      # a job's rows do not fit this variant
        order_t = torch.from_numpy(order).cuda()
        fkw = dict(kw, groups=groups)
        runs[label] = (lambda o=order_t, k=fkw:
                       KE.ksw_forward(*args[:5], o, **k))
        _p, ez = runs[label]()
        torch.cuda.synchronize()
        ref = ez.clone() if ref is None else ref
        shapes[label] = (torch.equal(ez, ref), [
            (g["variant"], g["ring"], g["threads"], g["count"])
            for g in groups])
        del _p
    for label, ms in S._in_turns(runs, ROUNDS).items():
        print(f"   {label}: {ms:.3f} ms, ez equal {shapes[label][0]}, "
              f"{shapes[label][1]}", flush=True)
    p, ez = KE.ksw_forward(*args, **kw)
    wkw = dict(splice=splice, ops_total=pk["ops_total"])
    run = lambda: KE.ksw_walk(p, ts["poff"], ts["meta"], ts["order"],
                              ez.clone(), **wkw)
    ms = S._time_ms(run, ROUNDS)
    ez_w = ez.clone()
    KE.ksw_walk(p, ts["poff"], ts["meta"], ts["order"], ez_w, **wkw)
    steps = ez_w[:, KPK.C_FIN_K].cpu().numpy()
    print(f"   walk: {ms:.3f} ms, {steps.sum()} steps, longest "
          f"{steps.max()}, {ms * 1e6 / max(steps.max(), 1):.1f} ns per "
          "step", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ksw_sweep needs a CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as S
    from ..ops import ksw2 as K
    from ..options import set_opt
    print(S.phase_env(), flush=True)
    S.phase_build()

    def gaps(preset, splice=False):
        _, o = set_opt(preset)
        return (o.q, o.e, o.q2, o.noncan if splice else o.e2, o.a, o.b)
    sweep("short-read wave", short_read_wave(K), gaps("sr"), False)
    sweep("splice wave", splice_wave(K), gaps("splice", True), True)
    ont = [c for c in S.ksw_cases() if "10 kb" in c[0]][0]
    sweep("64 x 10 kb w=500", ont[1], ont[2], False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
