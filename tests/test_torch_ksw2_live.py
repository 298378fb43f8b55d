"""The plain ksw2 versions (ops/ksw2_ext.ksw_forward_ref, ksw_walk_ref)
step only the jobs still within their rows, longest first, on the widest
band among them. A job's results must not depend on the launch it is in:
one plain run over a mixed launch (one job of about 600 bases among about
40 of 10-80 bases: z-dropped, approx, approx-drop, score-only,
right-aligned, all-N and width-1-band jobs) against each job run alone,
on every ez column, every backtrack byte of the job's range, every step
code and fin (i, j, k); the same launch against the JAX package's numpy
models; the launches whose live prefix never shrinks (no job, one job,
jobs of one length). Tolerance zero throughout."""
import ast
import inspect
import os
import sys

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.ops import ksw2 as K
from minimap2_chaindp_tpu.ops.ksw2_splice import exts2
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
from minimap2_chaindp_tpu_torch.options import set_opt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke as S  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)


def gaps(preset, splice):
    _, o = set_opt(preset)
    return (o.q, o.e, o.q2, o.noncan if splice else o.e2, o.a, o.b)


def ez_key(g):
    return (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe, g.mqe_t,
            g.mte, g.mte_q, g.reach_end, list(g.cigar))


def _job(q, t, flag, w=-1, zdrop=400, end_bonus=-1):
    return dict(qseq=np.asarray(q, np.uint8), tseq=np.asarray(t, np.uint8),
                w=w, zdrop=zdrop, end_bonus=end_bonus, flag=flag)


def _odd_jobs(rng, splice, base):
    """z-dropped (unrelated sequences), score-only, width-1-band (a
    one-base query) and all-N jobs of 10-80 bases."""
    jobs = [_job(rng.integers(0, 4, 70), rng.integers(0, 4, 78),
                 base | K.KSW_EZ_EXTZ_ONLY, w=100, zdrop=20)
            for _ in range(2)]
    t = rng.integers(0, 4, 60)
    jobs.append(_job(S._mutate_codes(rng, t), t,
                     base | K.KSW_EZ_SCORE_ONLY, w=25))
    jobs.append(_job(S._mutate_codes(rng, t), t,
                     base | K.KSW_EZ_SCORE_ONLY | K.KSW_EZ_APPROX_MAX))
    jobs.append(_job(rng.integers(0, 4, 1), rng.integers(0, 4, 40), base,
                     zdrop=-1, end_bonus=0))
    jobs.append(_job(np.full(12, 4), rng.integers(0, 4, 30), base,
                     zdrop=-1, end_bonus=0))
    jobs.append(_job(rng.integers(0, 4, 25), np.full(20, 4),
                     base | K.KSW_EZ_EXTZ_ONLY, zdrop=100))
    return jobs


def extd2_mixed():
    """One job of 600 bases among about 40 of 10-80 under map-ont."""
    rng = np.random.default_rng(31)
    (_, amb, sc, _), _, _ = S.ambiguous_ksw_cases(max_len=80, n_ext=8)
    jobs = [j for j in amb if len(j["qseq"]) <= 80 and len(j["tseq"]) <= 80]
    jobs += S._ext_jobs(rng, 18, (10, 80)) + _odd_jobs(rng, False, 0)
    # the long job's band (w 25) is narrower than the short jobs' widest
    t = rng.integers(0, 4, 600).astype(np.uint8)
    jobs.insert(len(jobs) // 2, _job(S._mutate_codes(rng, t, 0.05, 0.005),
                                     t, 0, w=25))
    return jobs, sc


def exts2_mixed():
    """One spliced job of about 600 genome bases among about 40 smaller
    ones under splice, every splice flag and N at donors, acceptors,
    introns and exons among them."""
    rng = np.random.default_rng(32)
    *_, (_, amb, sc, _) = S.ambiguous_ksw_cases(max_len=60, n_flags=3)
    fw = K.KSW_EZ_SPLICE_FOR
    flags = (fw, K.KSW_EZ_SPLICE_REV, fw | K.KSW_EZ_SPLICE_FLANK,
             fw | K.KSW_EZ_RIGHT, fw | K.KSW_EZ_APPROX_MAX,
             fw | K.KSW_EZ_APPROX_MAX | K.KSW_EZ_APPROX_DROP,
             fw | K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_REV_CIGAR)
    jobs = amb + [S._spliced_job(rng, f, 2, exon=12, intron=20)
                  for f in flags for _ in range(3)]
    jobs += _odd_jobs(rng, True, fw)
    jobs.insert(len(jobs) // 2,
                S._spliced_job(rng, fw, 3, exon=100, intron=110, err=0.03))
    return jobs, sc


def launch(name):
    jobs, sc = {"extd2": extd2_mixed, "exts2": exts2_mixed}[name]()
    return jobs, sc, name == "exts2"


def plain_on(jobs, scoring, splice, device):
    """The plain forward and walk over one launch of `jobs` on `device`:
    (pk, p, ez with fin, ops)."""
    pk, ts, kw = S.ksw_inputs(jobs, scoring, splice, device)
    args = [ts[k] for k in KE.FORWARD_KEYS[:5]]
    p, ez = KE.ksw_forward_ref(*args, **{k: v for k, v in kw.items()
                                         if k != "groups"})
    ops = KE.ksw_walk_ref(p, ts["poff"], ts["meta"], ez, splice=splice,
                          ops_total=pk["ops_total"])
    return pk, p, ez, ops


def plain(jobs, scoring, splice):
    """plain_on the CPU, as numpy arrays."""
    pk, *out = plain_on(jobs, scoring, splice, "cpu")
    return (pk, *(x.numpy() for x in out))


def job_ranges(pk, j):
    """Job j's backtrack bytes and step codes: (p slice, ops slice)."""
    m = pk["meta"][j]
    rows = int(m[KPK.M_QLEN] + m[KPK.M_TLEN] - 1)
    po, oo = int(pk["poff"][j]), int(m[KPK.M_OPOFF])
    return (slice(po, po + rows * int(m[KPK.M_NCOL])),
            slice(oo, oo + rows + 1))


def assert_each_alone(jobs, scoring, splice, whole=None):
    pk, p, ez, ops = whole or plain(jobs, scoring, splice)
    for j, job in enumerate(jobs):
        pk1, p1, ez1, ops1 = plain([job], scoring, splice)
        ps, os_ = job_ranges(pk, j)
        ps1, os1 = job_ranges(pk1, 0)
        msg = (f"job {j} flag={job['flag']} w={job['w']} "
               f"qlen={len(job['qseq'])} tlen={len(job['tseq'])}")
        assert np.array_equal(ez[j], ez1[0]), msg
        assert np.array_equal(p[ps], p1[ps1]), msg
        assert np.array_equal(ops[os_], ops1[os1]), msg
    return pk, ez


def assert_models(jobs, scoring, splice):
    """The batch API over the launch against the JAX package's numpy
    models, every Ez field and the CIGAR."""
    q, e, q2, e2n, a, b = scoring
    mat = K.gen_simple_mat(5, a, b)
    if splice:
        got = KE.exts2_batch(jobs, mat, q, e, q2, e2n, device="cpu")
        want = [exts2(j["qseq"], j["tseq"], mat, q, e, q2, e2n, j["zdrop"],
                      j["flag"]) for j in jobs]
    else:
        got = KE.extd2_batch(jobs, mat, q, e, q2, e2n, device="cpu")
        want = [K.extd2(j["qseq"], j["tseq"], mat, q, e, q2, e2n, j["w"],
                        j["zdrop"], j["end_bonus"], j["flag"]) for j in jobs]
    for j, (job, g, w) in enumerate(zip(jobs, got, want)):
        assert ez_key(g) == ez_key(w), (
            f"job {j} flag={job['flag']} qlen={len(job['qseq'])} "
            f"tlen={len(job['tseq'])}")
    return got


@pytest.mark.parametrize("name", ["extd2", "exts2"])
def test_mixed_launch_equals_each_job_alone(name):
    jobs, sc, splice = launch(name)
    pk, ez = assert_each_alone(jobs, sc, splice)
    meta = pk["meta"]
    rows = meta[:, KPK.M_QLEN] + meta[:, KPK.M_TLEN] - 1
    # the launch is what it is meant to be: one long job, the prefix
    # shrinking to it (in extd2 the live band narrowing to its width)
    assert 38 <= len(jobs) <= 46 and len(pk["groups"]) == 1
    assert np.sort(rows)[-1] > 3 * np.sort(rows)[-2]
    _order, live, band = KE._live_order(
        rows.astype(np.int64), int(rows.max()),
        meta[:, KPK.M_LANES].astype(np.int64))
    assert live[0] == len(jobs) and live[-1] == 1 and len(set(live)) > 10
    assert band[0] == pk["band_max"]
    assert (band[-1] < band[0]) == (not splice)
    flag = meta[:, KPK.M_APPROX], meta[:, KPK.M_ADROP], \
        meta[:, KPK.M_SCONLY], meta[:, KPK.M_RIGHT]
    assert all(f.any() for f in flag)
    assert ez[:, KPK.C_ZDROP].any() and (meta[:, KPK.M_QLEN] == 1).any()
    assert any((j["qseq"] == 4).all() for j in jobs)
    assert any((j["tseq"] == 4).all() for j in jobs)
    assert (ez[:, KPK.C_FIN_K] > 0).sum() > len(jobs) // 2


@pytest.mark.parametrize("name", ["extd2", "exts2"])
def test_mixed_launch_matches_numpy_models(name):
    jobs, sc, splice = launch(name)
    got = assert_models(jobs, sc, splice)
    assert sum(1 for g in got if g.cigar) > len(jobs) // 2


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["extd2", "exts2"])
def test_card_runs_equal_cpu_runs(name):
    """On a CUDA device the runs of rows and steps on one live prefix
    replay from CUDA graphs (ksw2_ext._stepper): the same p bytes, ez
    rows, step codes and fin (i, j, k) as the CPU's eager run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs, sc, splice = launch(name)
    pk, *cpu = plain(jobs, sc, splice)
    rows = pk["meta"][:, KPK.M_QLEN] + pk["meta"][:, KPK.M_TLEN] - 1
    assert rows.max() - np.sort(rows)[-2] > 4 * KE.GRAPH_STEPS
    _pk, *card = plain_on(jobs, sc, splice, "cuda")
    for label, c, g in zip(("p", "ez", "ops"), cpu, card):
        g = g.cpu().numpy()
        assert np.array_equal(c, g), label


def _equal_lengths(splice):
    """Jobs of one length (the prefix never shrinks) under every flag."""
    rng = np.random.default_rng(33)
    if splice:
        fw = K.KSW_EZ_SPLICE_FOR
        flags = (fw, K.KSW_EZ_SPLICE_REV, fw | K.KSW_EZ_RIGHT,
                 fw | K.KSW_EZ_APPROX_MAX, fw | K.KSW_EZ_SCORE_ONLY)
    else:
        flags = (0, K.KSW_EZ_APPROX_MAX, K.KSW_EZ_EXTZ_ONLY,
                 K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT,
                 K.KSW_EZ_APPROX_MAX | K.KSW_EZ_APPROX_DROP,
                 K.KSW_EZ_SCORE_ONLY)
    jobs = []
    for i in range(6):
        t = rng.integers(0, 4, 70)
        q = (rng.integers(0, 4, 50) if i % 4 == 3
             else S._mutate_codes(rng, t, 0.06, 0)[:50])
        q = np.concatenate([q, np.zeros(50 - len(q), np.uint8)])
        jobs.append(_job(q, t, flags[i % len(flags)], w=(10, 25, -1)[i % 3],
                         zdrop=(30, 400)[i % 2], end_bonus=(-1, 5)[i % 2]))
    return jobs


@pytest.mark.parametrize("splice", [False, True], ids=["extd2", "exts2"])
@pytest.mark.parametrize("edge", ["no_job", "one_job", "one_length"])
def test_launches_whose_prefix_never_shrinks(edge, splice):
    sc = gaps("splice" if splice else "map-ont", splice)
    if edge == "no_job":
        pk, p, ez, ops = plain([], sc, splice)
        assert ez.shape == (0, KPK.EZ_COLS) and p.shape == (1,) \
            and ops.shape == (1,) and not p.any() and not ops.any()
        return
    jobs = _equal_lengths(splice)
    if edge == "one_job":
        jobs = jobs[:1]
    pk, p, ez, ops = plain(jobs, sc, splice)
    rows = pk["meta"][:, KPK.M_QLEN] + pk["meta"][:, KPK.M_TLEN] - 1
    assert len(set(rows)) == 1
    assert_each_alone(jobs, sc, splice, whole=(pk, p, ez, ops))
    assert_models(jobs, sc, splice)


def test_live_order():
    """Longest first (stable among equals); live[s] counts the jobs with
    more than s steps, band[s] the widest of them."""
    steps_of = np.array([3, 7, 0, 7, 5, 1], np.int64)
    widths = np.array([90, 20, 500, 40, 60, 10], np.int64)
    order, live, band = KE._live_order(steps_of, 8, widths)
    assert order.tolist() == [1, 3, 4, 0, 5, 2]
    assert live == [5, 4, 4, 3, 3, 2, 2, 0]
    assert band == [90, 90, 90, 60, 60, 40, 40, 20]
    order, live, band = KE._live_order(np.zeros(0, np.int64), 0)
    assert len(order) == 0 and live == [] and band == []


def test_chunks():
    """Runs of steps on one prefix: as long as the live count and band
    hold, and never shorter than `length` (but for the last)."""
    live = [5] * 3 + [4] * 40 + [2, 1, 1]
    band = [9] * 20 + [7] * 26
    assert KE._chunks(live, band, 8) == [(0, 8), (8, 12), (20, 23),
                                         (43, 3)]
    assert KE._chunks(live, band, 1) == [(0, 3), (3, 17), (20, 23),
                                         (43, 1), (44, 2)]
    assert KE._chunks([], [], 8) == []


@pytest.mark.parametrize("splice", [False, True], ids=["extd2", "exts2"])
def test_job_width_bounds_its_lanes(splice):
    """The live band's premise: on every row a job computes, its aligned
    band [st, en] and its score block [st0, s_end) lie within n_col_of +
    16 lanes of st (ksw2_pack's M_LANES, the kernels' own width)."""
    rng = np.random.default_rng(34)
    shapes = [(q, t, w) for q in range(1, 34) for t in range(1, 34)
              for w in (-1, 0, 1, 2, 5, 16, 33)]
    shapes += [(int(rng.integers(1, 2000)), int(rng.integers(1, 2000)),
                int(rng.choice([-1, 25, 100, 500, 751])))
               for _ in range(60)]
    for ql, tl, w in shapes:
        w = max(ql, tl) if splice or w < 0 else w
        r = torch.arange(ql + tl - 1)
        st0, en0, st, en = KE._band(r, torch.tensor(ql), torch.tensor(tl),
                                    torch.tensor(w), splice)
        s_end = st0 + 16 * ((en0 - st0) // 16 + 1)
        live = st0 <= en0
        need = torch.maximum(en - st + 1, s_end - st)[live]
        assert not live.any() or int(need.max()) <= \
            KPK.n_col_of(ql, tl, w, splice) + 16, (ql, tl, w)


SYNCS = {"int", "float", "bool", "item", "tolist", "nonzero", "cpu",
         "numpy", "any", "all"}


@pytest.mark.parametrize("fn", [KE.ksw_forward_ref, KE.ksw_walk_ref],
                         ids=["forward", "walk"])
def test_loops_hold_no_host_sync(fn):
    """Nothing in the loop over runs of rows or steps, nor in the row or
    step it runs, reads a value back to the host: no int(), .item(),
    .nonzero() and the like, and no index by a comparison (a boolean
    mask)."""
    body = ast.parse(inspect.getsource(fn)).body[0].body
    loops = [n for n in body if isinstance(n, ast.For)
             and "_chunks" in ast.unparse(n)]
    steps = [n for n in body if isinstance(n, ast.FunctionDef)
             and n.name in ("row", "step")]
    assert len(loops) == 1 and len(steps) == 1
    for node in (n for top in loops + steps for n in ast.walk(top)):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(
                f, "id", "")
            assert name not in SYNCS, ast.unparse(node)
        if isinstance(node, ast.Subscript):
            assert not isinstance(node.slice, (ast.Compare, ast.BoolOp,
                                               ast.UnaryOp, ast.BinOp)), \
                ast.unparse(node)
