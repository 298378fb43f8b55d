"""The port's plain ksw2 versions on base code 4 against the JAX package's
Pallas kernel, in interpret mode as its own tests run it, with the fused
walk (backtrack="device"): every result column of the ez rows, fin (i, j,
k), every step code of the walk and the Ez results with their CIGARs, on
chip_smoke.ambiguous_ksw_cases() cut to small jobs (interpret mode takes
about 10 ms a row a job on the CPU): the extd2 cases here, the exts2 case
in tests/test_torch_ksw2_n_pallas_splice.py (a file each keeps each under
a minute). tests/test_torch_ksw2_n.py holds the full-size cases against
the numpy models and the native SSE build."""
import os
import sys

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.ops import ksw2 as K
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
from test_torch_ksw2_pallas import FIN_COLS, RESULT_COLS, _port_raw
from test_torch_ksw2 import ez_key

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import ambiguous_ksw_cases  # noqa: E402

torch.set_num_threads(1)

SMALL = {name: (jobs, scoring, splice) for name, jobs, scoring, splice in
         ambiguous_ksw_cases(max_len=60, n_ext=6, n_flags=2)}


@pytest.mark.parametrize("case", sorted(k for k, v in SMALL.items()
                                       if not v[2]))
def test_plain_matches_pallas_with_n(monkeypatch, case):
    check_against_pallas(monkeypatch, case)


def check_against_pallas(monkeypatch, case):
    """One case of SMALL through the Pallas kernel (interpret mode, fused
    walk) and the port's plain versions, compared column by column."""
    from minimap2_chaindp_tpu.ops import ksw2_pallas as KP
    jobs, (q, e, q2, e2n, a, b), splice = SMALL[case]
    assert any((j["qseq"] == 4).any() or (j["tseq"] == 4).any()
               for j in jobs)
    seen = {}
    real = KP._ksw_call

    def record(*args, **kw):
        seen["raw"] = real(*args, **kw)
        return seen["raw"]
    monkeypatch.setattr(KP, "_ksw_call", record)
    mat = K.gen_simple_mat(5, a, b)
    if splice:
        pal = KP.exts2_batch(jobs, mat, q, e, q2, e2n, interpret=True,
                             backtrack="device")
        port = KE.exts2_batch(jobs, mat, q, e, q2, e2n, device="cpu")
        gaps = KPK.gap_params(q, e, q2, 0, True)
    else:
        pal = KP.extd2_batch(jobs, mat, q, e, q2, e2n, interpret=True,
                             backtrack="device")
        port = KE.extd2_batch(jobs, mat, q, e, q2, e2n, device="cpu")
        gaps = KPK.gap_params(q, e, q2, e2n, False)
    _p, pal_ez, pal_ops = (np.asarray(x) for x in seen["raw"])
    ez, ops, meta = _port_raw(jobs, mat, gaps, splice, e2n if splice else 0)
    for j, (x, y) in enumerate(zip(pal, port)):
        assert ez_key(x) == ez_key(y), f"job {j}"
        k, o = int(ez[j, KPK.C_FIN_K]), int(meta[j, KPK.M_OPOFF])
        # a job with no walk (score-only, or z-dropped with no maximum)
        # has k = 0 in both; its fin (i, j) is -1 in the port and left
        # unwritten by the fused walk, and no caller reads it
        cols = RESULT_COLS + (FIN_COLS if k else (KPK.C_FIN_K,))
        assert [int(pal_ez[j, c]) for c in cols] == \
            [int(ez[j, c]) for c in cols], f"job {j}"
        assert list(pal_ops[j, :k]) == list(ops[o:o + k]), f"job {j}"
    assert sum(1 for g in port if g.cigar) > len(jobs) // 2
