"""The port on the card: the CUDA chain kernel against its plain PyTorch
version on every kernel case of chip_smoke.py (bit-exact f, p, flag), the
ksw2 forward kernel (as the wrapper plans its launches and in every
variant that holds the jobs, forced) and the walk kernel against theirs on
chip_smoke.ksw_cases() and on jobs at the variants' boundaries (bit-exact
ez rows, step codes, fin), the shared-memory limit and jobs past 16384
and 32768 target bases against the native host library, the splice-signal
kernel against its plain version
(donor_acceptor job by job), exts2 waves on phase 3's N corpus against
the plain versions and the native host library, and TorchRuntime on cuda
against the port's HostRuntime (byte-identical lines) under map-ont and
-x splice, the staged path's native finish against the align generators
and HostRuntime on sr pairs, and under the stealing routing from map_stream's two batch
threads; the device index build,
entry(), a 1 x 1 nccl mesh, and meshes of two ranks on one card over gloo
(1 x 2, 2 x 1); the regimes of the presets: the chain launches of
-x ava-pb (bw 2000) and extension jobs of several kb under the asm10 and
asm20 scorings, each against the plain version. Skips without a CUDA device. This file imports neither JAX nor the JAX package, so on a GPU
host without JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_chain_kernel_matches_ref_on_card(cuda):
    from chip_smoke import kernel_cases
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.utils.chain_corpus import boundary_cases
    cases = [(c["name"], c["arrays"], c["kw"], c.get("flagged"))
             for c in boundary_cases(wide_n=3000)]
    cases += [(n, a, k, None) for n, a, k in kernel_cases()]
    n_flagged = 0
    for name, arrs, kw, flagged in cases:
        ts = [torch.from_numpy(a).to(cuda) for a in arrs]
        want = TD.chain_scores_batch_ref(*ts, **kw)
        for form in (None,) + TD.FORMS:
            TD.chain_scores_batch.force = form
            before = TD.chain_scores_batch.launches
            try:
                got = TD.chain_scores_batch(*ts, **kw)
            finally:
                TD.chain_scores_batch.force = None
            torch.cuda.synchronize()
            assert TD.chain_scores_batch.launches == before + 1, name
            for g, w in zip(got, want):
                assert torch.equal(g, w), (name, form)
        if flagged is not None:
            assert bool(want[2][:, 0].any()) == flagged, name
        n_flagged += int(want[2][:, 0].sum())
    assert n_flagged > 0


def test_chain_launches_from_two_threads_on_card(cuda):
    """map_stream launches from two threads; the largest buckets (max_n
    4096 and 8192) side by side, every result against the plain version.
    Neither form of the kernel opts in to shared memory beyond the default,
    so no launch can lower a limit under another."""
    import threading
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils.chain_corpus import pack_batch
    from minimap2_chaindp_tpu_torch.utils.synth import synth_batch
    _, ont = set_opt("map-ont")
    jobs = []
    for max_n, seed in ((8192, 21), (4096, 22)):
        kw = dict(max_n=max_n, max_dist_x=ont.max_gap, max_dist_y=ont.max_gap,
                  bw=ont.bw, max_skip=ont.max_chain_skip, is_cdna=False,
                  many_segs=False, use_exc=True)
        ts = [torch.from_numpy(a).to(cuda) for a in pack_batch(
            synth_batch(8, max_n - 50, seed=seed), max_n, ont.max_gap)]
        jobs.append((ts, kw, TD.chain_scores_batch_ref(*ts, **kw)))
    torch.cuda.synchronize()
    failures = []

    def loop(ts, kw, want):
        try:
            for _ in range(25):
                got = TD.chain_scores_batch(*ts, **kw)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    failures.append(f"max_n={kw['max_n']}: wrong result")
        except Exception as e:   # a refused launch raises in the wrapper
            failures.append(f"max_n={kw['max_n']}: {e!r}")
    for form in (None,) + TD.FORMS:
        TD.chain_scores_batch.force = form
        try:
            threads = [threading.Thread(target=loop, args=j) for j in jobs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            TD.chain_scores_batch.force = None
    assert not failures, failures


def test_chain_kernel_largest_max_n_on_card(cuda):
    """max_n = 65536, the contract's limit: the window starts fill the 16
    bits the staged form packs them into."""
    import numpy as np
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils.chain_corpus import pack_batch
    from minimap2_chaindp_tpu_torch.utils.synth import synth_read_anchors
    _, ont = set_opt("map-ont")
    max_n = 1 << 16
    rng = np.random.default_rng(31)
    batch = [synth_read_anchors(rng, n, read_len=1_000_000)
             for n in (max_n, max_n - 1, 40000)]
    ts = [torch.from_numpy(a).to(cuda)
          for a in pack_batch(batch, max_n, ont.max_gap)]
    kw = dict(max_n=max_n, max_dist_x=ont.max_gap, max_dist_y=ont.max_gap,
              bw=ont.bw, max_skip=ont.max_chain_skip, is_cdna=False,
              many_segs=False, use_exc=True)
    want = TD.chain_scores_batch_ref(*ts, **kw)
    assert int(want[1].max()) > 65000          # predecessors up there
    for form in TD.FORMS:
        TD.chain_scores_batch.force = form
        try:
            got = TD.chain_scores_batch(*ts, **kw)
        finally:
            TD.chain_scores_batch.force = None
        for g, w in zip(got, want):
            assert torch.equal(g, w), form


def test_runtime_on_card_matches_host(cuda, tmp_path):
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    from minimap2_chaindp_tpu_torch.ops import seeds_device as TS
    ref, reads = str(tmp_path / "g.fa"), str(tmp_path / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=41)
    G.simulate(ref, reads, 48, 2000, 0.10, seed=43)
    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    batches = list(read_frags([reads], mo.mini_batch_size, False))
    want = [ls for b in HostRuntime(mi, mo).map_stream(batches) for ls in b]
    before = TD.chain_scores_batch.launches
    rt = TorchRuntime(mi, mo, device=cuda)
    got = [ls for b in rt.map_stream(batches) for ls in b]
    assert got == want
    assert TD.chain_scores_batch.launches > before
    assert rt.timers.counters["device_reads"] > 0
    # "cuda" and "cuda:<n>" name one card and share one upload
    card = f"cuda:{torch.cuda.current_device()}"
    assert TS.device_index_cached(mi, "cuda") is \
        TS.device_index_cached(mi, card)


def test_replay_on_card_matches_generators(cuda, tmp_path):
    """The staged path's native finish on the card: sr pairs (2%
    substitutions, a fifth of them with a 1-10 base indel), the ksw2
    kernels answering the units' job tables, against the align generators
    on the same batch and against HostRuntime (byte-identical lines);
    every unit replayed, every recorded job run by the executor, most on
    the card, in no more extension waves than the generators take."""
    import numpy as np
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import (SeqRecord, read_fastx,
                                                     read_frags)
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    ref, p1, p2 = (str(tmp_path / n) for n in ("g.fa", "r1.fq", "r2.fq"))
    G.make_genome(ref, n_contigs=4, contig_len=500_000, seed=61)
    G.simulate_pairs(ref, p1, p2, 3000, seed=63, err=0.02)
    io, mo = set_opt("sr")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([p1, p2], 10**9, True) for f in b]
    rng = np.random.default_rng(65)
    for f in frags[::5]:
        s = f.segs[0]
        p, n = int(rng.integers(40, 110)), int(rng.integers(1, 11))
        f.segs[0] = SeqRecord(s.name, s.seq[:p] + s.seq[p + n:], s.qual[n:],
                              s.comment)
    want = HostRuntime(mi, mo).map_batch(frags)
    runs = {}
    for replay in (True, False):
        rt = TorchRuntime(mi, mo, device=cuda)
        if not replay:
            rt._replay.takes = lambda: False
        waves = []
        run = rt.align_exec.run
        rt.align_exec.run = lambda jobs, run=run, waves=waves: \
            waves.append(len(jobs)) or run(jobs)
        runs[replay] = (rt.map_batch(frags), dict(rt.timers.counters),
                        waves)
    got, c, waves = runs[True]
    assert got == want == runs[False][0]
    assert c["replay_units"] == c["staged_frags"] == len(frags)
    assert "replay_declined" not in c
    assert c["replay_jobs"] == sum(waves) == c["ext_device"] + c.get(
        "ext_native", 0) + c.get("ext_host", 0)
    assert c["ext_device"] > 0.9 * c["replay_jobs"]
    assert len(waves) <= len(runs[False][2])


def test_ksw_kernels_match_ref_on_card(cuda):
    from chip_smoke import compare_ksw, ksw_cases, ksw_inputs
    for name, jobs, scoring, splice in ksw_cases():
        if len(jobs) == 64:
            continue   # the 64 x 10 kb case: chip_smoke.py only
        pk, ts, kw = ksw_inputs(jobs, scoring, splice, cuda)
        assert compare_ksw(name, pk, ts, kw, reps=1)["err"] == 0, name


def boundary_jobs(splice):
    """Jobs whose rows sit at the rings' boundaries (ring sizes 64, 128,
    256, 512 and 1024 lanes, one block size each up to 512 threads), in
    every mode of the kernels: approximate and exact maxima, right and
    left alignment, score only, z-drop on (divergent pairs) and off."""
    import numpy as np
    from chip_smoke import _mutate_codes
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    rng = np.random.default_rng(29)
    base = K.KSW_EZ_SPLICE_FOR if splice else 0
    flags = [base, base | K.KSW_EZ_APPROX_MAX,
             base | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT,
             base | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR,
             base | K.KSW_EZ_SCORE_ONLY,
             base | K.KSW_EZ_APPROX_MAX | K.KSW_EZ_APPROX_DROP]
    jobs = []
    # min(qlen, tlen, w + 1) -> lanes: 32 -> 64, 33 -> 80, 96 -> 128,
    # 97 -> 144, 224 -> 256, 225 -> 272, 480 -> 512, 481 -> 528
    for k, n in enumerate((31, 32, 33, 96, 97, 224, 225, 480, 481)):
        for f, flag in enumerate(flags):
            t = rng.integers(0, 4, n + 40).astype(np.uint8)
            divergent = (k + f) % 4 == 3
            q = rng.integers(0, 4, n + 30).astype(np.uint8) if divergent \
                else _mutate_codes(rng, t)
            eb = 10 if flag & K.KSW_EZ_EXTZ_ONLY else -1
            jobs.append(dict(
                qseq=q, tseq=t, w=-1 if splice else n - 1,
                zdrop=-1 if f == 0 else 100, end_bonus=eb, flag=flag))
            if splice:   # unbanded: the shorter sequence sets the lanes
                jobs[-1]["qseq"] = jobs[-1]["qseq"][:n]
    return jobs


@pytest.mark.parametrize("splice", [False, True], ids=["extd2", "exts2"])
def test_ksw_variant_boundaries_on_card(cuda, splice):
    from chip_smoke import compare_ksw, ksw_inputs
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    from minimap2_chaindp_tpu_torch.options import set_opt
    _, o = set_opt("splice" if splice else "map-ont")
    scoring = (o.q, o.e, o.q2, o.noncan if splice else o.e2, o.a, o.b)
    jobs = boundary_jobs(splice)
    # all together: one block-per-job launch with the widest ring, then
    # block and global forced
    pk, ts, kw = ksw_inputs(jobs, scoring, splice, cuda)
    assert [(g["variant"], g["ring"]) for g in pk["groups"]] == \
        [("block", 1024)]
    res = compare_ksw("boundaries", pk, ts, kw, reps=1)
    assert res["err"] == 0 and set(res["variant_ms"]) == set(KPK.VARIANTS)
    # and the narrow ones alone: a launch of 128-thread blocks
    narrow = [j for j, lanes in zip(jobs, pk["meta"][:, KPK.M_LANES])
              if KPK.ring_of(lanes) <= 256]
    pk, ts, kw = ksw_inputs(narrow, scoring, splice, cuda)
    assert [(g["variant"], g["ring"], g["threads"])
            for g in pk["groups"]] == [("block", 256, 128)]
    assert {KPK.ring_of(x) for x in pk["meta"][:, KPK.M_LANES]} == \
        {64, 128, 256}
    res = compare_ksw("narrow boundaries", pk, ts, kw, reps=1)
    assert res["err"] == 0 and set(res["variant_ms"]) == set(KPK.VARIANTS)


def test_ksw_shared_memory_limit_on_card(cuda):
    """The widest ring shared memory holds (16384 lanes, 224 KB in one
    block) and the first job past it, which takes the device-memory
    variant: both against the native host library (the reference's SIMD
    kernel), Ez field by Ez field and CIGAR by CIGAR."""
    import numpy as np
    from chip_smoke import _mutate_codes
    from minimap2_chaindp_tpu_torch import native
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    rng = np.random.default_rng(31)
    jobs = []
    for n in (16352, 16353):
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = np.resize(_mutate_codes(rng, t, 0.05, 0.0), n)
        jobs.append(dict(qseq=q, tseq=t, w=-1, zdrop=400, end_bonus=-1,
                         flag=0))
    pk = KPK.pack_jobs(jobs, splice=False)
    assert [(g["variant"], g["ring"]) for g in pk["groups"]] == \
        [("global", 32768), ("block", 16384)]
    mat = K.gen_simple_mat(5, 2, 4)
    before = dict(KE.ksw_forward.by_variant)
    got = KE.extd2_batch(jobs, mat, 4, 2, 24, 1, device=cuda)
    assert KE.ksw_forward.by_variant["block"] == before["block"] + 1
    assert KE.ksw_forward.by_variant["global"] == before["global"] + 1
    want = native.extd2_batch_native(jobs, mat, 4, 2, 24, 1)
    assert want is not None
    key = lambda g: (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe,
                     g.mqe_t, g.mte, g.mte_q, g.reach_end, list(g.cigar))
    assert [key(g) for g in got] == [key(g) for g in want]


@pytest.mark.parametrize("splice", [True, False], ids=["exts2", "extd2"])
def test_ksw_long_targets_on_card(cuda, splice):
    """Jobs past 16384 and past 32768 target bases, beside short ones, in
    one launch: chip_smoke.long_splice_wave (targets of 16385, 32767,
    32768, 32769, 65536 and 155000 bases with GT..AG or CT..AC introns
    under each splice flag, one z-dropped) and long_extd2_jobs (banded
    targets of 40000 and 70000 bases), the inputs on which a scan key that
    packs the lane index itself in 15 bits was wrong. Their bands fit the
    shared-memory ring, so the planned launch is that form's; the forward
    and walk kernels against the native host library (the reference's
    SIMD build), Ez field by Ez field and CIGAR by CIGAR
    (chip_smoke.compare_ksw_native), and the device-memory form, forced,
    against the planned launch: equal ez rows and step codes."""
    import chip_smoke as S
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.options import set_opt
    _, o = set_opt("splice" if splice else "map-ont")
    if splice:
        name, jobs, noncan = S.long_splice_wave()
    else:
        name, jobs, noncan = "long extd2", S.long_extd2_jobs(), o.e2
    # jobs with lanes past 2^15 (targets of 32769 bases and more)
    assert sum(len(j["tseq"]) > 32768 for j in jobs) == (4 if splice else 2)
    got = S.compare_ksw_native(name, jobs, (o.q, o.e, o.q2, noncan, o.a,
                                            o.b), splice, reps=1)
    # the long jobs reached their targets' far lanes; the spliced one with
    # 400 unrelated bases z-dropped there
    assert max(g.max_t for g in got) >= (154_990 if splice else 69_999)
    if splice:
        assert got[-1].zdropped and got[-1].max_t == 32768
    _forced_global_matches(jobs, K.gen_simple_mat(5, o.a, o.b), o, splice,
                           noncan if splice else 0, cuda)


def _forced_global_matches(jobs, mat, o, splice, noncan, dev):
    """The wave's planned launch is one shared-memory launch; the
    device-memory form, forced, gives the same ez rows and, over each
    job's walk, the same step codes."""
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    pk = KPK.pack_jobs(jobs, splice=splice, noncan=noncan)
    assert [g["variant"] for g in pk["groups"]] == ["block"]
    ts = KE.device_inputs(pk, dev, splice=splice)
    scoring = KE.forward_scoring(
        mat, KPK.gap_params(o.q, o.e, o.q2, 0 if splice else o.e2, splice),
        splice=splice)
    kw = dict(scoring=scoring, splice=splice, p_bytes=pk["p_bytes"],
              t_total=pk["t_total"], band_max=pk["band_max"],
              rows_max=pk["rows_max"])
    args = [ts[k] for k in KE.FORWARD_KEYS]
    runs = []
    for force in (None, "global"):
        order, groups = KPK.launch_plan(pk["meta"], force=force)
        order = torch.from_numpy(order).to(dev)
        p, ez = KE.ksw_forward(*args[:5], order, groups=groups, **kw)
        ops = KE.ksw_walk(p, ts["poff"], ts["meta"], order, ez,
                          splice=splice, ops_total=pk["ops_total"]).cpu()
        ez = ez.cpu()
        runs.append((ez, [ops[o:o + k].tolist() for o, k in zip(
            pk["meta"][:, KPK.M_OPOFF], ez[:, KPK.C_FIN_K].tolist())]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert runs[0][1] == runs[1][1]


@pytest.mark.parametrize("wave", range(4))
def test_splice_signal_kernel_on_card(cuda, wave):
    """The splice-signal kernel's buffer against its plain version
    (donor_acceptor job by job on the CPU, from the same packed arrays),
    byte for byte: chip_smoke's mixed waves (every splice flag set,
    targets of 1 to 40 bases, at 16k +- 1, GT/AG-rich ones of 3000) and a
    cDNA-sized wave of 2400 jobs with targets up to 16384."""
    import chip_smoke as S
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
    name, jobs, noncan = [*S.splice_signal_waves(),
                          S.splice_signal_cdna_wave()][wave]
    pk = KPK.pack_jobs(jobs, splice=True, noncan=noncan)
    before = KE.splice_signal.launches
    ts = KE.device_inputs(pk, cuda, splice=True)
    assert KE.splice_signal.launches == before + 1
    got = ts["dac"].cpu()
    plain = KE.splice_signal_ref(ts["tseq"].cpu(), ts["meta"].cpu(),
                                 t_total=pk["t_total"], noncan=noncan)
    assert got.dtype == torch.int16 and torch.equal(got, plain), name


def test_exts2_batch_on_card_n_corpus(cuda):
    """exts2_batch on the card, its splice signal from the kernel, against
    the plain versions (the signal computed on the CPU) and the native host
    library (the reference's SIMD build) on phase 3's N corpus: every Ez
    field and CIGAR equal."""
    from chip_smoke import ambiguous_ksw_cases
    from minimap2_chaindp_tpu_torch import native
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    key = lambda g: (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe,
                     g.mqe_t, g.mte, g.mte_q, g.reach_end, list(g.cigar))
    cases = [c for c in ambiguous_ksw_cases() if c[3]]
    assert cases
    for name, jobs, (q, e, q2, noncan, a, b), _splice in cases:
        mat = K.gen_simple_mat(5, a, b)
        before = KE.splice_signal.launches
        got = KE.exts2_batch(jobs, mat, q, e, q2, noncan, device=cuda)
        assert KE.splice_signal.launches == before + 1, name
        plain = KE.exts2_batch(jobs, mat, q, e, q2, noncan, device="cpu")
        assert [key(g) for g in got] == [key(g) for g in plain], name
        want = native.exts2_batch_native(jobs, mat, q, e, q2, noncan)
        if want is not None:
            assert [key(g) for g in got] == [key(g) for g in want], name


def test_splice_runtime_on_card_matches_host(cuda):
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
    data = os.path.join(ROOT, "tests", "data")
    io, mo = set_opt("splice")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(os.path.join(data, "splice_genome.fa")))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([os.path.join(data, "splice_cdna.fa")],
                                   mo.mini_batch_size, False) for f in b]
    want = HostRuntime(mi, mo).map_batch(frags)
    before = (KE.ksw_forward.launches, KE.ksw_walk.launches,
              KE.splice_signal.launches)
    rt = TorchRuntime(mi, mo, device=cuda)
    assert rt.map_batch(frags) == want
    assert KE.ksw_forward.launches > before[0]
    assert KE.ksw_walk.launches > before[1]
    assert KE.splice_signal.launches > before[2]
    assert rt.align_exec.n_device > 0


def test_steal_routing_on_card_matches_host(cuda, tmp_path):
    """The stealing lanes on the card from map_stream's two batch threads
    (two batches of 160 reads, each past the lane's 128-read minimum)."""
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    ref, reads = str(tmp_path / "g.fa"), str(tmp_path / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=45)
    G.simulate(ref, reads, 320, 2000, 0.10, seed=47)
    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    batches = [frags[:160], frags[160:]]
    want = [ls for b in HostRuntime(mi, mo, n_threads=3).map_stream(batches)
            for ls in b]
    rt = TorchRuntime(mi, mo, device=cuda, n_threads=3, routing="steal")
    for _ in range(2):
        got = [ls for b in rt.map_stream(batches) for ls in b]
        assert got == want
    c = rt.timers.counters
    assert c["fast_native"] + c.get("steal_device_reads", 0) == 2 * len(frags)


def _small_genome(tmp_path, n_reads=48):
    from minimap2_chaindp_tpu_torch import constants as C
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    ref, reads = str(tmp_path / "g.fa"), str(tmp_path / "r.fa")
    G.make_genome(ref, n_contigs=3, contig_len=200_000, seed=51)
    G.simulate(ref, reads, n_reads, 2000, 0.10, seed=53)
    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(ref))
    names = [r.name for r in recs]
    seqs = [C.seq_to_nt4(r.seq) for r in recs]
    mi = build_index(names, tuple(seqs), io.w, io.k, io.flag,
                     io.bucket_bits)
    mo.update(mi)
    batches = list(read_frags([reads], mo.mini_batch_size, False))
    return dict(names=names, seqs=seqs, io=io, mi=mi, mo=mo,
                batches=batches)


def test_device_index_build_on_card(cuda, tmp_path):
    import numpy as np
    from minimap2_chaindp_tpu_torch.index.build import build_index
    g = _small_genome(tmp_path, n_reads=1)
    io = g["io"]
    for w, k, flag in ((io.w, io.k, io.flag), (5, 19, 1)):
        host = build_index(g["names"], tuple(g["seqs"]), w, k, flag,
                           device=False)
        dev = build_index(g["names"], tuple(g["seqs"]), w, k, flag,
                          device=True)
        for f in ("keys", "starts", "values"):
            assert np.array_equal(getattr(host, f), getattr(dev, f)), f


def test_entry_on_card(cuda):
    from minimap2_chaindp_tpu_torch.entry import CHAIN_KW, entry
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    fn, args = entry()
    assert all(a.is_cuda for a in args)
    before = TD.chain_scores_batch.launches
    f = fn(*args)
    torch.cuda.synchronize()
    assert TD.chain_scores_batch.launches == before + 1
    want = TD.chain_scores_batch_ref(*args, max_n=f.shape[1], **CHAIN_KW)[0]
    assert f.is_cuda and torch.equal(f, want)


def test_mesh_1x1_nccl_on_card(cuda, tmp_path):
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    g = _small_genome(tmp_path)
    mi, mo, batches = g["mi"], g["mo"], g["batches"]
    want = [ls for b in HostRuntime(mi, mo).map_stream(batches) for ls in b]
    before = TD.chain_scores_batch.launches
    rt = TorchRuntime(mi, mo, device="cuda", mesh_shape=(1, 1))
    try:
        got = [ls for b in rt.map_stream(batches) for ls in b]
        assert rt._mesh.backend == "nccl"
    finally:
        rt.close()
    assert got == want
    assert TD.chain_scores_batch.launches > before
    c = rt.timers.counters
    # one rank sends nothing to another
    assert c["device_reads"] > 0 and c["mesh_bytes"] == 0


@pytest.mark.parametrize("shape", [(1, 2), (2, 1)], ids=["1x2", "2x1"])
def test_mesh_gloo_two_ranks_one_card(cuda, tmp_path, shape):
    """Two ranks on cuda:0 over gloo: every collective of the mesh on CUDA
    tensors of both ranks (1 x 2: the index group's all_reduce and
    all_gather; 2 x 1: the gather of the data rows; both: the header, the
    scatters and close()'s all_reduce). The SAM equals HostRuntime's."""
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
    g = _small_genome(tmp_path)
    mi, mo, batches = g["mi"], g["mo"], g["batches"]
    want = [ls for b in HostRuntime(mi, mo).map_stream(batches) for ls in b]
    rt = TorchRuntime(mi, mo, device="cuda", mesh_shape=shape,
                      mesh_devices=["cuda:0", "cuda:0"])
    try:
        got = [ls for b in rt.map_stream(batches) for ls in b]
        assert rt._mesh.backend == "gloo"
    finally:
        rt.close()
    assert got == want
    c = rt.timers.counters
    assert c["device_reads"] > 0 and c["mesh_bytes"] > 0
    if shape == (1, 2):
        assert c["mesh_allgather_bytes"] > 0


def test_ava_pb_chain_inputs_on_card(cuda, tmp_path):
    """-x ava-pb: reads mapped against themselves (HPC k19 w5, PAF), every
    unit staged (NO_DIAG); each chain launch the runtime made (bw 2000, the
    widest below the table's 2048; max_dist 10000) against the plain
    version, in every form; the lines equal HostRuntime's."""
    from chip_smoke import compare_kernel
    from minimap2_chaindp_tpu_torch.index.build import build_index
    from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu_torch.models import runtime as RT
    from minimap2_chaindp_tpu_torch.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu_torch.options import set_opt
    from minimap2_chaindp_tpu_torch.utils import genome_synth as G
    src, reads = str(tmp_path / "src.fa"), str(tmp_path / "ava.fa")
    G.make_genome(src, n_contigs=1, contig_len=40_000, seed=63)
    G.simulate(src, reads, 48, 5000, 0.10, seed=69)
    io, mo = set_opt("ava-pb")
    recs = list(read_fastx(reads))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    want = HostRuntime(mi, mo).map_batch(frags)
    kept = []
    real = RT.chain_scores_batch
    RT.chain_scores_batch = lambda *a, **kw: (kept.append((a, kw))
                                              or real(*a, **kw))
    try:
        rt = RT.TorchRuntime(mi, mo, device=cuda)
        got = rt.map_batch(frags)
    finally:
        RT.chain_scores_batch = real
    assert got == want
    assert kept and rt.timers.counters["staged_device_reads"] > 0
    for a, kw in kept:
        assert kw["bw"] == 2000 and kw["max_dist_x"] == 10000
        res = compare_kernel(f"ava-pb R={a[1].shape[0]} max_n="
                             f"{kw['max_n']}", a, kw, reps=1, phase=0)
        assert res["err"] == 0


@pytest.mark.parametrize("preset", ["asm10", "asm20"])
def test_asm_ksw_jobs_on_card(cuda, preset):
    """Eight extension jobs of 2-6 kb under the asm10 and asm20 scorings
    and z-drop 200, the query diverged at the preset's rate in smoke phase
    10 (1%, 5%), band 751 as the asm runs set it; global, right-aligned
    and reversed-CIGAR jobs in turn. The forward kernel (as planned and
    every variant forced) and the walk against their plain versions, bit
    for bit."""
    import numpy as np
    from chip_smoke import P10_ASM, _mutate_codes, compare_ksw, ksw_inputs
    from minimap2_chaindp_tpu_torch.ops import ksw2 as K
    from minimap2_chaindp_tpu_torch.options import set_opt
    _, o = set_opt(preset)
    div = P10_ASM[preset]
    rng = np.random.default_rng(13)
    flags = (0, K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT,
             K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR)
    jobs = []
    for i in range(8):
        t = rng.integers(0, 4, int(rng.integers(2000, 6001))).astype(
            np.uint8)
        jobs.append(dict(qseq=_mutate_codes(rng, t, div * 0.55, div * 0.45),
                         tseq=t, w=751, zdrop=o.zdrop, end_bonus=-1,
                         flag=flags[i % len(flags)]))
    assert o.zdrop == 200
    pk, ts, kw = ksw_inputs(jobs, (o.q, o.e, o.q2, o.e2, o.a, o.b), False,
                            cuda)
    assert compare_ksw(f"{preset} 2-6 kb", pk, ts, kw, reps=1)["err"] == 0


def test_spans_on_the_device_trace_clock(cuda):
    """One clock with the device trace: a span on a worker thread wraps a
    torch.cuda._sleep of about 20 ms and its synchronize, inside a
    device_wait child; put on the profiler's clock through two anchors
    (the start of a record_function on the main thread before and after,
    each paired with the midpoint of perf_counter_ns read around its
    enter), the kernel's CUPTI interval lies inside the span's within 0.2
    ms at each end, and device_wait ends at or after the kernel's end."""
    import threading
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from minimap2_chaindp_tpu_torch.utils.trace import Tracer, clock_map

    def at(ev, what):
        for unit, scale in (("ns", 1), ("us", 1000)):
            fn = getattr(ev, f"{what}_{unit}", None)
            if fn is not None:
                return int(fn()) * scale
        raise AttributeError(what)

    def anchor(name):
        rf = record_function(name)
        a = time.perf_counter_ns()
        rf.__enter__()
        b = time.perf_counter_ns()
        rf.__exit__(None, None, None)
        return (a + b) // 2

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        anchor("warm")       # the first enter and exit resolve their ops
        p0 = anchor("anchor0")
        tr.start_trace()

        def work():
            torch.cuda._sleep(1000)   # the thread's first launch, untimed
            torch.cuda.synchronize()
            with tr.time("map_batch"):
                torch.cuda._sleep(40_000_000)     # about 20 ms at 1.98 GHz
                with tr.time("device_wait"):
                    torch.cuda.synchronize()
        t = threading.Thread(target=work)
        t.start()
        t.join(60)
        assert not t.is_alive()
        spans = {s.name: s for s in tr.stop_trace()}
        p1 = anchor("anchor1")
    evs = prof.profiler.kineto_results.events()
    starts = {e.name(): at(e, "start") for e in evs
              if e.device_type() != DeviceType.CUDA
              and e.name() in ("anchor0", "anchor1")}
    to_trace = clock_map((p0, starts["anchor0"]), (p1, starts["anchor1"]))
    ks = [(at(e, "start"), at(e, "start") + at(e, "duration"))
          for e in evs if e.device_type() == DeviceType.CUDA
          and at(e, "duration") > 5_000_000]
    assert len(ks) == 1, ks
    k0, k1 = ks[0]
    s, dw = spans["map_batch"], spans["device_wait"]
    s0, s1 = to_trace(s.start_ns), to_trace(s.end_ns)
    tol = 200_000      # 0.2 ms
    why = dict(span=(s0 - k0, s1 - k1), wait_end=to_trace(dw.end_ns) - k1,
               kernel=(k0, k1), anchors=((p0, starts["anchor0"]),
                                         (p1, starts["anchor1"])))
    assert s0 - tol <= k0 <= s0 + tol, why
    assert s1 - tol <= k1 <= s1 + tol, why
    assert to_trace(dw.end_ns) >= k1, why
    assert dw.thread == s.thread != threading.get_ident()
