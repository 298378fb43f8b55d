"""The JAX package's presets through the port's TorchRuntime on the CPU
(plain versions): ava-ont, ava-pb, asm5, asm10, asm20, map10k and sr
single-end on a small genome_synth genome, each against the JAX package's
HostRuntime byte for byte, with the counters showing where the units went
(the fused flow, the staged chain kernel, the host routes). The chain
kernel's inputs of each preset are held against the Pallas kernel in
tests/test_torch_presets_chain.py, the assembly scorings' extension jobs
against the Pallas ksw2 kernel in tests/test_torch_presets_asm.py; both
build their inputs with the helpers here."""
import os

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.index.build import build_index
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
from minimap2_chaindp_tpu.models.pipeline import prepare_frag, seed_unit
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu_torch.models import device_flow as DF
from minimap2_chaindp_tpu_torch.models import runtime as RT
from minimap2_chaindp_tpu_torch.ops import chain_pack as CPK
from minimap2_chaindp_tpu_torch.utils import genome_synth as G

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

PRESETS = ("ava-ont", "ava-pb", "asm5", "asm10", "asm20", "map10k", "sr")
# divergence and seed of each asm preset's contigs: at 3 kb these seeds
# give contigs that the fused flow chains, contigs that the chain kernel
# flags for the host (the max_skip bound) and, under asm5, one contig with
# more anchors than the last bucket
ASM_CONTIGS = {"asm5": (0.001, 73), "asm10": (0.01, 75),
               "asm20": (0.05, 78)}
SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR


def make_inputs(d, preset):
    """(reference, queries) FASTA paths for one preset under directory d:
    a 2 x 200 kb genome (seed 61) and, by preset, 40 x 150 bp reads at 1%
    error (sr single-end), 8 x 3 kb at 10% (map10k), 3 contigs of 3 kb at
    the asm preset's divergence (ASM_CONTIGS), or for ava 16 x 5 kb reads
    at 10% from one 40 kb contig, mapped against themselves. Files are
    written once."""
    def once(path, make):
        if not os.path.exists(path):
            make(path + ".tmp")
            os.replace(path + ".tmp", path)
        return path
    genome = once(os.path.join(d, "genome.fa"), lambda p: G.make_genome(
        p, n_contigs=2, contig_len=200_000, seed=61))
    if preset.startswith("ava"):
        src = once(os.path.join(d, "ava_src.fa"), lambda p: G.make_genome(
            p, n_contigs=1, contig_len=40_000, seed=63))
        reads = once(os.path.join(d, "ava.fa"), lambda p: G.simulate(
            src, p, 16, 5000, 0.10, seed=69))
        return reads, reads
    if preset in ASM_CONTIGS:
        err, seed = ASM_CONTIGS[preset]
        return genome, once(os.path.join(d, f"{preset}.fa"),
                            lambda p: G.simulate(genome, p, 3, 3000, err,
                                                 seed=seed))
    if preset == "map10k":
        return genome, once(os.path.join(d, "map10k.fa"), lambda p:
                            G.simulate(genome, p, 8, 3000, 0.10, seed=67))
    assert preset == "sr"
    return genome, once(os.path.join(d, "sr.fa"), lambda p: G.simulate(
        genome, p, 40, 150, 0.01, seed=65))


def load(d, preset, flags=None):
    """The JAX package's index and options for `preset` over make_inputs,
    and the query fragments (single-end). Output is SAM with CIGAR, but
    PAF for the ava presets, as their users run them."""
    ref, queries = make_inputs(d, preset)
    io, mo = set_opt(preset)
    mo.flag |= (0 if preset.startswith("ava") else SAM) \
        if flags is None else flags
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([queries], mo.mini_batch_size, False)
             for f in b]
    return mi, mo, frags


def seeded_units(mi, mo, frags):
    """Every unit of the fragments, seeded on the host: the inputs of the
    staged chain pass (the pattern of tests/test_torch_staged.py)."""
    out = []
    for f in frags:
        _w, _f, us = prepare_frag(mo, f.segs)
        out.extend((u, seed_unit(mi, mo, u)) for u in us)
    return out


def count_chain_calls(monkeypatch):
    """Count the chain wrapper's calls where the runtime's paths make them
    (the fused flow, the staged pass): {"flow": n, "staged": n}."""
    calls = {"flow": 0, "staged": 0}
    for key, mod in (("flow", DF), ("staged", RT)):
        real = mod.chain_scores_batch

        def wrapped(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(mod, "chain_scores_batch", wrapped)
    return calls


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("presets"))


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_matches_host(workdir, preset, monkeypatch):
    """(a) TorchRuntime(device="cpu") writes the JAX HostRuntime's lines
    byte for byte; (d) the chain wrapper ran for the preset, on the route
    the JAX package's routing gives its units."""
    mi, mo, frags = load(workdir, preset)
    want = HostRuntime(mi, mo).map_batch(frags)
    calls = count_chain_calls(monkeypatch)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    got = rt.map_batch(frags)
    assert got == want
    assert sum(map(len, got)) >= len(frags) // 2
    c = rt.timers.counters
    assert calls["flow"] + calls["staged"] > 0
    assert c["device_reads"] + c["staged_device_reads"] > 0
    if preset.startswith("ava"):
        # NO_DIAG takes every unit off the flow (flow_mode_ok)
        assert calls["flow"] == 0 and rt._flow is None
        assert c["staged_frags"] == len(frags) and c["staged_device_reads"]
    else:
        assert calls["flow"] > 0
    if preset in ASM_CONTIGS:
        # long extension jobs with the assembly scoring on the ksw2 path
        assert c["ext_device"] > 0
        assert rt.align_exec.n_device == c["ext_device"]
    if preset == "sr":
        assert c["native_finish"] > 0    # single-end: the flow's finish


def test_ava_with_cigar_matches_host(workdir):
    """ava-pb with -c: the staged path's extension jobs under the ava
    preset. The plain ksw2 takes minutes on the 5 kb ava reads, so this
    case maps 6 x 1 kb reads at 2% error from the first 3 kb of the ava
    contig against themselves."""
    src, _ = make_inputs(workdir, "ava-pb")
    head = os.path.join(workdir, "ava_head.fa")
    reads = os.path.join(workdir, "ava_c.fa")
    seq = next(iter(read_fastx(os.path.join(workdir, "ava_src.fa")))).seq
    with open(head, "w") as f:
        f.write(f">s\n{seq[:3000]}\n")
    G.simulate(head, reads, 6, 1000, 0.02, seed=69)
    io, mo = set_opt("ava-pb")
    mo.flag |= C.MM_F_OUT_CG | C.MM_F_CIGAR                 # -c
    recs = list(read_fastx(reads))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    want = HostRuntime(mi, mo).map_batch(frags)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    assert rt.map_batch(frags) == want
    assert sum("cg:Z:" in ln for ls in want for ln in ls) >= 6
    c = rt.timers.counters
    assert c["ext_device"] > 0 and c["staged_device_reads"] > 0


@pytest.mark.parametrize("bw", [None, CPK.TBL], ids=["preset-bw", "bw-tbl"])
def test_host_chain_routes_counted(workdir, bw):
    """The staged pass counts the units it sends to the host: more anchors
    than the last bucket (host_chain_oversized) and, with bw at the table's
    end, every other unit (host_chain_bw); routing and output stay the JAX
    package's. asm5's contigs cover the flow, the staged kernel
    and the oversized route."""
    mi, mo, frags = load(workdir, "asm5", flags=0)
    if bw is not None:
        mo.bw = bw
    n_anchors = [len(info.sh.anchors)
                 for _u, info in seeded_units(mi, mo, frags)]
    over = sum(n > RT.BUCKETS[-1] for n in n_anchors)
    assert over >= 1
    want = HostRuntime(mi, mo).map_batch(frags)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    assert rt.map_batch(frags) == want
    c = rt.timers.counters
    assert c["host_chain_oversized"] == over
    if bw is None:
        assert c.get("host_chain_bw", 0) == 0
        assert c["device_reads"] + c["staged_device_reads"] >= 1
    else:
        # bw >= TBL: no flow for the mode, and no unit in the chain kernel
        assert rt._flow is None and c.get("staged_device_reads", 0) == 0
        assert c["host_chain_bw"] == sum(
            0 < n <= RT.BUCKETS[-1] for n in n_anchors)
    assert np.all(np.array(n_anchors) > 0)
