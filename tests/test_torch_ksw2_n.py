"""The port's ksw2 extension on base code 4 (an N, or an IUPAC code as
seq_nt4_table reads it), which no other corpus of the repo gives the
port: chip_smoke.ambiguous_ksw_cases() (single Ns and N runs in the query,
the target or both; an N run on the band's edge; all-N sequences; N at a
spliced job's donor, acceptor, intron and exon) through the plain versions
ksw_forward_ref / ksw_walk_ref (ops/ksw2_ext.extd2_batch, exts2_batch on
the CPU) against the port's numpy models (ops/ksw2.extd2,
ops/ksw2_splice.exts2) and the native SSE build (native.extd2_batch_native,
exts2_batch_native). Tolerance zero: every Ez field and the CIGAR. The
Pallas kernel's side is tests/test_torch_ksw2_n_pallas.py; on the card,
smoke phase 3 and tests/test_torch_cuda.py hold both forward kernels and
the walk on the same cases (chip_smoke.ksw_cases() ends with them)."""
import os
import sys

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu_torch import native as TN
from minimap2_chaindp_tpu_torch.ops import ksw2 as TK
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops.ksw2_splice import exts2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ambiguous_ksw_cases, ksw_cases  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

CASES = {name: (jobs, scoring, splice)
         for name, jobs, scoring, splice in ambiguous_ksw_cases()}


def ez_key(g):
    return (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe, g.mqe_t,
            g.mte, g.mte_q, g.reach_end, list(g.cigar))


def has_n(s):
    return bool((np.asarray(s) == 4).any())


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_numpy_models_and_native(case):
    jobs, (q, e, q2, e2n, a, b), splice = CASES[case]
    mat = TK.gen_simple_mat(5, a, b)
    if splice:
        got = KE.exts2_batch(jobs, mat, q, e, q2, e2n, device="cpu")
        want = [exts2(j["qseq"], j["tseq"], mat, q, e, q2, e2n, j["zdrop"],
                      j["flag"]) for j in jobs]
        nat = TN.exts2_batch_native(jobs, mat, q, e, q2, e2n)
    else:
        got = KE.extd2_batch(jobs, mat, q, e, q2, e2n, device="cpu")
        want = [TK.extd2(j["qseq"], j["tseq"], mat, q, e, q2, e2n, j["w"],
                         j["zdrop"], j["end_bonus"], j["flag"])
                for j in jobs]
        nat = TN.extd2_batch_native(jobs, mat, q, e, q2, e2n)
    assert nat is not None, "the native ksw2 library did not build"
    for j, (job, g, w, n) in enumerate(zip(jobs, got, want, nat)):
        msg = (f"job {j} flag={job['flag']} w={job.get('w')} "
               f"qlen={len(job['qseq'])} tlen={len(job['tseq'])}")
        assert ez_key(g) == ez_key(w), msg
        assert ez_key(g) == ez_key(n), msg
    # N in the query alone, the target alone and both; CIGARs with M
    where = {(has_n(j["qseq"]), has_n(j["tseq"])) for j in jobs}
    assert {(True, False), (False, True), (True, True)} <= where or splice
    assert any(has_n(j["tseq"]) for j in jobs)
    assert sum(1 for g in got if g.cigar) > len(jobs) // 2


def test_n_score_is_the_reference_build():
    """The score of a cell with N: -e2 in extd2 and -e in exts2, as the
    SSE build sets sc_N (native/ksw2_extd2.cc:720, :1033), where the
    matrix's N row and column are 0 (gen_simple_mat). An all-N query
    against any target scores that once a base over the shorter length."""
    from minimap2_chaindp_tpu_torch.options import set_opt
    _, o = set_opt("map-ont")
    mat = TK.gen_simple_mat(5, o.a, o.b)
    assert mat[4 * 5:].tolist() == [0] * 5 and mat[4::5].tolist() == [0] * 5
    scoring = KE.forward_scoring(mat, (o.q, o.e, o.q2, o.e2, 0, 0),
                                 splice=False)
    assert scoring[6] == -o.e2
    _, s = set_opt("splice")
    assert KE.forward_scoring(mat, (s.q, s.e, s.q2, 0, 0, 0),
                              splice=True)[6] == -s.e
    job = dict(qseq=np.full(20, 4, np.uint8),
               tseq=np.arange(20, dtype=np.uint8) % 4, w=-1, zdrop=-1,
               end_bonus=0, flag=0)
    (g,) = KE.extd2_batch([job], mat, o.q, o.e, o.q2, o.e2, device="cpu")
    assert g.score == -20 * o.e2 and g.cigar == [20 << 4]


def test_smoke_phase3_holds_the_n_corpus():
    """chip_smoke.ksw_cases(), which smoke phase 3 and the card's tests
    run on both forward kernels (forced) and the walk, ends with the
    ambiguous cases: extd2 and exts2 jobs with code 4."""
    cases = ksw_cases()
    names = [c[0] for c in cases]
    assert names[-len(CASES):] == list(CASES)
    for splice in (False, True):
        assert any(has_n(j["qseq"]) or has_n(j["tseq"])
                   for _n, jobs, _s, sp in cases if sp == splice
                   for j in jobs)
