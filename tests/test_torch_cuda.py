"""The port on the card: the CUDA chain kernel against its plain PyTorch
version on every kernel case of chip_smoke.py (bit-exact f, p, flag), the
ksw2 forward and walk kernels against theirs on chip_smoke.ksw_cases()
(bit-exact ez rows, step codes, fin), and TorchRuntime on cuda against
HostRuntime (byte-identical lines) under map-ont and -x splice. Skips
without a CUDA device. This file imports no JAX, so on a GPU host without
JAX it runs as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_chain_kernel_matches_ref_on_card(cuda):
    from chip_smoke import kernel_cases
    from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
    n_flagged = 0
    for name, arrs, kw in kernel_cases():
        ts = [torch.from_numpy(a).to(cuda) for a in arrs]
        before = TD.chain_scores_batch.launches
        got = TD.chain_scores_batch(*ts, **kw)
        want = TD.chain_scores_batch_ref(*ts, **kw)
        torch.cuda.synchronize()
        assert TD.chain_scores_batch.launches == before + 1, name
        for g, w in zip(got, want):
            assert torch.equal(g, w), name
        n_flagged += int(got[2][:, 0].sum())
    assert n_flagged > 0


def test_runtime_on_card_matches_host(cuda, tmp_path):
    import genome_scale as G
    from minimap2_chaindp_tpu import constants as C
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu.options import set_opt
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


def test_ksw_kernels_match_ref_on_card(cuda):
    from chip_smoke import compare_ksw, ksw_cases, ksw_inputs
    for name, jobs, scoring, splice in ksw_cases():
        if len(jobs) == 64:
            continue   # the 64 x 10 kb case: chip_smoke.py only
        pk, ts, kw = ksw_inputs(jobs, scoring, splice, cuda)
        assert compare_ksw(name, pk, ts, kw, reps=1)[0] == 0, name


def test_splice_runtime_on_card_matches_host(cuda):
    from minimap2_chaindp_tpu import constants as C
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags
    from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
    from minimap2_chaindp_tpu.options import set_opt
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
    before = (KE.ksw_forward.launches, KE.ksw_walk.launches)
    rt = TorchRuntime(mi, mo, device=cuda)
    assert rt.map_batch(frags) == want
    assert KE.ksw_forward.launches > before[0]
    assert KE.ksw_walk.launches > before[1]
    assert rt.align_exec.n_device > 0
