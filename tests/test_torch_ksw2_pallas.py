"""The port's plain ksw2 versions against the Pallas kernel itself, in
interpret mode as the JAX package's tests run it: every result column of
the ez rows on small extd2 and exts2 cases and, in the slow tier, the
walk's step codes and fin (i, j, k) against the fused walk."""
import numpy as np
import pytest
import torch

import test_ksw2_splice_pallas as TS
from minimap2_chaindp_tpu.ops import ksw2 as K
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
from test_torch_ksw2 import EXTD2, SPLICE, ez_key, width1_band


# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

RESULT_COLS = (KPK.C_MAX, KPK.C_MAX_T, KPK.C_MAX_Q, KPK.C_MQE, KPK.C_MQE_T,
               KPK.C_MTE, KPK.C_MTE_Q, KPK.C_SCORE, KPK.C_ZDROP)
FIN_COLS = (KPK.C_FIN_I, KPK.C_FIN_J, KPK.C_FIN_K)


def _port_raw(jobs, mat, gaps, splice, noncan=0):
    """The port's plain forward and walk on CPU tensors: (ez, ops, meta)."""
    pk = KPK.pack_jobs(jobs, splice=splice, noncan=noncan)
    q, e, q2, e2, lt, ld = gaps
    ts = {k: torch.from_numpy(pk[k]) for k in
          ("tseq", "qrev", "dac", "meta", "poff")}
    scoring = (q, e, q2, e2, int(mat[0]), int(mat[1]),
               -e if splice else -e2, lt, ld)
    p, ez = KE.ksw_forward(ts["tseq"], ts["qrev"], ts["dac"], ts["meta"],
                           ts["poff"], scoring=scoring, splice=splice,
                           p_bytes=pk["p_bytes"], t_total=pk["t_total"],
                           band_max=pk["band_max"], rows_max=pk["rows_max"])
    ops = KE.ksw_walk(p, ts["poff"], ts["meta"], ez, splice=splice,
                      ops_total=pk["ops_total"])
    return ez.numpy(), ops.numpy(), pk["meta"]


def _small_splice_jobs():
    rng = np.random.default_rng(7)
    jobs = []
    for flag in (K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_RIGHT):
        qs, ts = TS.make_spliced(rng, n_exons=2, exon=30, intron=40)
        jobs.append(dict(qseq=qs, tseq=ts, zdrop=200, end_bonus=-1,
                         flag=flag, w=-1))
    return jobs


def _pallas_and_port(monkeypatch, mode, backtrack):
    """Run the Pallas kernel in interpret mode (recording the raw outputs
    of its launch) and the port's plain versions on the same jobs.
    Returns (pallas Ez list, pallas raw outputs, port Ez list, port ez
    rows, port step codes, port meta)."""
    from minimap2_chaindp_tpu.ops import ksw2_pallas as KP
    seen = {}
    real = KP._ksw_call

    def record(*a, **kw):
        seen["raw"] = real(*a, **kw)
        return seen["raw"]
    monkeypatch.setattr(KP, "_ksw_call", record)
    if mode == "extd2":
        jobs = width1_band()
        q, e, q2, e2, a, b = EXTD2
        mat = K.gen_simple_mat(5, a, b)
        pal = KP.extd2_batch(jobs, mat, q, e, q2, e2, interpret=True,
                             backtrack=backtrack)
        port = KE.extd2_batch(jobs, mat, q, e, q2, e2)
        raw = _port_raw(jobs, mat, KPK.gap_params(q, e, q2, e2, False),
                        False)
    else:
        jobs = _small_splice_jobs()
        q, e, q2, noncan, a, b = SPLICE
        mat = K.gen_simple_mat(5, a, b)
        pal = KP.exts2_batch(jobs, mat, q, e, q2, noncan, interpret=True,
                             backtrack=backtrack)
        port = KE.exts2_batch(jobs, mat, q, e, q2, noncan)
        raw = _port_raw(jobs, mat, KPK.gap_params(q, e, q2, 0, True), True,
                        noncan)
    return (pal, [np.asarray(x) for x in seen["raw"]], port) + raw


@pytest.mark.parametrize("mode", ["extd2", "exts2"])
def test_plain_matches_pallas_interpret(monkeypatch, mode):
    """The Pallas kernel's ez rows (interpret mode, backtrack="host", as
    the JAX tests run it) equal the port's column for column, and the
    Ez results, CIGARs included, are equal."""
    pal, (_p, pal_ez), port, ez, _ops, _meta = _pallas_and_port(
        monkeypatch, mode, "host")
    for j, (a, b) in enumerate(zip(pal, port)):
        assert ez_key(a) == ez_key(b), f"job {j}"
        assert [int(pal_ez[j, c]) for c in RESULT_COLS] == \
            [int(ez[j, c]) for c in RESULT_COLS], f"job {j}"


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["extd2", "exts2"])
def test_walk_matches_pallas_fused_walk(monkeypatch, mode):
    """The walk's step codes and fin (i, j, k) equal the Pallas kernel's
    fused walk (interpret mode, backtrack="device")."""
    pal, (_p, pal_ez, pal_ops), port, ez, ops, meta = _pallas_and_port(
        monkeypatch, mode, "device")
    for j, (a, b) in enumerate(zip(pal, port)):
        assert ez_key(a) == ez_key(b), f"job {j}"
        assert [int(pal_ez[j, c]) for c in FIN_COLS] == \
            [int(ez[j, c]) for c in FIN_COLS], f"job {j}"
        k, o = int(ez[j, KPK.C_FIN_K]), int(meta[j, KPK.M_OPOFF])
        assert k > 0
        assert list(pal_ops[j, :k]) == list(ops[o:o + k]), f"job {j}"
