"""The port's ksw2 extension (CPU: the plain versions ksw_forward_ref and
ksw_walk_ref behind ops/ksw2_ext.extd2_batch / exts2_batch) against the
JAX package: the numpy models K.extd2 and ksw2_splice.exts2 on the corpora
of tests/test_ksw2_pallas.py, test_ksw2_backtrack.py and
test_ksw2_splice_pallas.py, and the Pallas kernel itself in interpret mode
on small cases. Tolerance zero: every Ez field and every CIGAR equal."""
import numpy as np
import pytest
import torch

import test_ksw2_pallas as TP
import test_ksw2_splice_pallas as TS
from minimap2_chaindp_tpu.ops import ksw2 as K
from minimap2_chaindp_tpu.ops.ksw2_splice import exts2, make_donor_acceptor
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

EXTD2 = (4, 2, 24, 1, 2, 4)
SR = (12, 2, 24, 1, 2, 8)
ASM = (16, 2, 41, 1, 1, 9)
SPLICE = (2, 1, 32, 9, 1, 2)


def ez_key(g):
    return (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe, g.mqe_t,
            g.mte, g.mte_q, g.reach_end, list(g.cigar))


def tiny_and_divergent():
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(4):   # unrelated sequences: z-drop fires early
        t = rng.integers(0, 4, 400).astype(np.uint8)
        qv = rng.integers(0, 4, 380).astype(np.uint8)
        jobs.append(dict(qseq=qv, tseq=t, w=100, zdrop=100, end_bonus=-1,
                         flag=K.KSW_EZ_EXTZ_ONLY))
    for _ in range(4):
        t = rng.integers(0, 4, int(rng.integers(3, 10))).astype(np.uint8)
        q = TP.mut(rng, t)
        jobs.append(dict(qseq=q if len(q) else np.array([0], np.uint8),
                         tseq=t, w=25, zdrop=400, end_bonus=-1, flag=0))
    return jobs


def width1_band():
    """tests/test_ksw2_pallas.py:114-134: qlen 1, unbanded."""
    rng = np.random.default_rng(2)
    return [dict(qseq=rng.integers(0, 4, 1).astype(np.uint8),
                 tseq=rng.integers(0, 4, tlen).astype(np.uint8),
                 w=-1, zdrop=-1, end_bonus=0, flag=0) for tlen in (135, 200)]


def long_gaps():
    """tests/test_ksw2_backtrack.py:96-114: a 30I and a 30D through the
    second affine profile (88M30I62M30D20M)."""
    rng = np.random.default_rng(17)
    t = rng.integers(0, 4, 200).astype(np.uint8)
    ins = rng.integers(0, 4, 30).astype(np.uint8)
    q = np.concatenate([t[:90], ins, t[90:150], t[180:]]).astype(np.uint8)
    return [dict(qseq=q, tseq=t, w=80, zdrop=400, end_bonus=-1, flag=0)]


EXTD2_CORPORA = {
    "default": (lambda: TP.gen_jobs(0, 16), EXTD2),
    "small": (lambda: TP.gen_jobs(5, 8, tlen_rng=(10, 60)), EXTD2),
    "sr": (lambda: TP.gen_jobs(1, 8), SR),
    "asm": (lambda: TP.gen_jobs(2, 8), ASM),
    "mixed_sizes": (lambda: TP.gen_jobs(3, 4, tlen_rng=(10, 60))
                    + TP.gen_jobs(4, 4, tlen_rng=(300, 600)), EXTD2),
    "tiny_divergent": (tiny_and_divergent, EXTD2),
    "width1_band": (width1_band, EXTD2),
    "long_gaps": (long_gaps, EXTD2),
}


def splice_mixed():
    """tests/test_ksw2_splice_pallas.py:65-76."""
    jobs = TS.gen_jobs(1, 4)
    rng = np.random.default_rng(2)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    qv = rng.integers(0, 4, 280).astype(np.uint8)
    jobs.append(dict(qseq=qv, tseq=t, zdrop=100, end_bonus=-1,
                     flag=K.KSW_EZ_SPLICE_FOR, w=-1))
    jobs.append(dict(qseq=t[:9].copy(), tseq=t[:12].copy(), zdrop=200,
                     end_bonus=-1, flag=K.KSW_EZ_SPLICE_FOR, w=-1))
    return jobs


EXTS2_CORPORA = {
    "splice_scoring": lambda: TS.gen_jobs(0, 8),
    "mixed_sizes": splice_mixed,
    "backtrack_corpus": lambda: TS.gen_jobs(2, 8),
}


@pytest.mark.parametrize("corpus", sorted(EXTD2_CORPORA))
def test_plain_extd2_matches_numpy_model(corpus):
    make, (q, e, q2, e2, a, b) = EXTD2_CORPORA[corpus]
    jobs = make()
    mat = K.gen_simple_mat(5, a, b)
    got = KE.extd2_batch(jobs, mat, q, e, q2, e2)
    for j, (job, g) in enumerate(zip(jobs, got)):
        want = K.extd2(job["qseq"], job["tseq"], mat, q, e, q2, e2,
                       job["w"], job["zdrop"], job["end_bonus"], job["flag"])
        assert ez_key(g) == ez_key(want), (
            f"job {j} flag={job['flag']} w={job['w']} "
            f"qlen={len(job['qseq'])} tlen={len(job['tseq'])}")
    if corpus == "long_gaps":
        cig = "".join(f"{c >> 4}{'MIDN'[c & 0xF]}" for c in got[0].cigar)
        assert cig == "88M30I62M30D20M"


@pytest.mark.parametrize("corpus", sorted(EXTS2_CORPORA))
def test_plain_exts2_matches_numpy_model(corpus):
    q, e, q2, noncan, a, b = SPLICE
    jobs = EXTS2_CORPORA[corpus]()
    mat = K.gen_simple_mat(5, a, b)
    got = KE.exts2_batch(jobs, mat, q, e, q2, noncan)
    for j, (job, g) in enumerate(zip(jobs, got)):
        want = exts2(job["qseq"], job["tseq"], mat, q, e, q2, noncan,
                     job["zdrop"], job["flag"])
        assert ez_key(g) == ez_key(want), (
            f"job {j} flag={job['flag']} "
            f"qlen={len(job['qseq'])} tlen={len(job['tseq'])}")


def test_p_budget_splits_launches(monkeypatch):
    """A one-byte budget gives every job its own launch and changes no
    result; score-only jobs need no backtrack bytes."""
    jobs = TP.gen_jobs(0, 6)
    jobs[0] = dict(jobs[0], flag=K.KSW_EZ_SCORE_ONLY)
    assert KPK.p_bytes_of(jobs[0], False) == 0
    total = sum(KPK.p_bytes_of(j, False) for j in jobs)
    assert KPK.split_by_budget(jobs, False, total) == [list(range(6))]
    assert KPK.split_by_budget(jobs, False, 1) == [[i] for i in range(6)]
    mat = K.gen_simple_mat(5, 2, 4)
    one = KE.extd2_batch(jobs, mat, 4, 2, 24, 1)
    groups = []
    real_pack = KE.pack_jobs

    def pack(grp, **kw):
        groups.append(len(grp))
        return real_pack(grp, **kw)
    monkeypatch.setattr(KE, "P_BUDGET", 1)
    monkeypatch.setattr(KE, "pack_jobs", pack)
    cut = KE.extd2_batch(jobs, mat, 4, 2, 24, 1)
    assert groups == [1] * 6
    assert [ez_key(g) for g in one] == [ez_key(g) for g in cut]


def test_out_of_domain_raises():
    mat = K.gen_simple_mat(5, 2, 40)   # -min(mat) > 2 * (q + e)
    with pytest.raises(ValueError):
        KE.extd2_batch(TP.gen_jobs(0, 1), mat, 4, 2, 24, 1)
    with pytest.raises(ValueError):
        KE.extd2_batch([dict(qseq=np.zeros(0, np.uint8),
                             tseq=np.zeros(5, np.uint8), w=-1, zdrop=-1,
                             end_bonus=0, flag=0)],
                       K.gen_simple_mat(5, 2, 4), 4, 2, 24, 1)


@pytest.mark.parametrize("flag", [
    0, K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_REV,
    K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV,
    K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_FLANK,
    K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV | K.KSW_EZ_SPLICE_FLANK])
def test_donor_acceptor_matches_shared(flag):
    """The vectorized splice signals equal the shared per-base model on
    every length from 0 to 40 and on long GT/AG-rich targets."""
    rng = np.random.default_rng(flag)
    targets = [rng.integers(0, 4, n).astype(np.uint8) for n in range(41)]
    targets += [rng.choice(np.array([0, 1, 2, 3], np.uint8), 3000,
                           p=[0.3, 0.2, 0.3, 0.2]) for _ in range(3)]
    for t in targets:
        for noncan in (9, 0, 15):
            got = KPK.donor_acceptor(t, noncan, flag)
            want = make_donor_acceptor(t, noncan, flag)
            assert all(np.array_equal(g, w) and g.dtype == w.dtype
                       for g, w in zip(got, want)), (len(t), noncan)
