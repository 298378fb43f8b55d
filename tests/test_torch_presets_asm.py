"""The assembly presets' kernel inputs against the JAX package's Pallas
kernels in interpret mode (CPU): the staged chain launches of asm5, asm10,
asm20 and map10k through tests/test_torch_presets_chain.py's check, and
the real extension jobs of each asm preset (its scoring: asm5's
(q+e)+(q2+e2) is 124, three below the int8 limit; z-drop 200) through the
port's plain ksw2 forward and walk and through the Pallas kernel: the same
score, every ez field and the same CIGAR, exactly. The inputs are
tests/test_torch_presets.py's."""
import pytest
import torch

from minimap2_chaindp_tpu.ops import ksw2 as K
from minimap2_chaindp_tpu.ops import ksw2_pallas as KP
from minimap2_chaindp_tpu_torch.models import runtime as RT
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from test_torch_ksw2 import ez_key
from test_torch_presets import ASM_CONTIGS, load
from test_torch_presets_chain import check_chain_inputs

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

# the interpreter takes seconds per anti-diagonal batch: the Pallas side
# runs the preset's jobs of at most this many bases of query plus target
PALLAS_JOB_BASES = 200


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("presets_asm"))


@pytest.mark.parametrize("preset", [*ASM_CONTIGS, "map10k"])
def test_asm_chain_inputs_match_pallas(workdir, preset, monkeypatch):
    check_chain_inputs(workdir, preset, monkeypatch)


@pytest.mark.parametrize("preset", list(ASM_CONTIGS))
def test_asm_extension_jobs_match_pallas(workdir, preset, monkeypatch):
    mi, mo, frags = load(workdir, preset)
    assert (mo.q + mo.e) + (mo.q2 + mo.e2) <= 127 and mo.zdrop == 200
    jobs = []
    real = KE.pack_jobs

    def keep(js, *, splice, noncan=0):
        assert not splice
        jobs.extend(js)
        return real(js, splice=splice, noncan=noncan)
    monkeypatch.setattr(KE, "pack_jobs", keep)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    rt.map_batch(frags)
    assert jobs and rt.timers.counters["ext_device"] == len(jobs)
    small = [j for j in jobs
             if len(j["qseq"]) + len(j["tseq"]) <= PALLAS_JOB_BASES]
    assert len(small) >= 2
    mat = K.gen_simple_mat(5, mo.a, mo.b)
    pal = KP.extd2_batch(small, mat, mo.q, mo.e, mo.q2, mo.e2,
                         interpret=True, backtrack="host")
    port = KE.extd2_batch(small, mat, mo.q, mo.e, mo.q2, mo.e2,
                          device="cpu")
    assert len(pal) == len(port) == len(small)
    for j, (a, b) in enumerate(zip(pal, port)):
        assert ez_key(a) == ez_key(b), f"job {j}"
    assert any(len(g.cigar) for g in port)
