"""The port's staged path on the CPU (plain versions): TorchRuntime under
-x splice against HostRuntime and the reference binary's SAM
(tests/golden/splice.sam), paired-end -x sr against HostRuntime on a
synthetic genome, the staged chain pass unit by unit against the JAX
package's DeviceRuntime._chain_batch (interpret mode), the CLI, and the
flow's lazy construction."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import genome_scale as G  # noqa: E402
from minimap2_chaindp_tpu import constants as C  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.models.pipeline import prepare_frag, seed_unit  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.models import device_flow as DF  # noqa: E402
from minimap2_chaindp_tpu_torch.models import runtime as RT  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR
SPLICE_REF = os.path.join(DATA, "splice_genome.fa")
SPLICE_READS = os.path.join(DATA, "splice_cdna.fa")


def load(preset, ref, queries, flags=SAM, frag_mode=False):
    io, mo = set_opt(preset)
    mo.flag |= flags
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags(queries, mo.mini_batch_size, frag_mode)
             for f in b]
    return mi, mo, frags


def write_pairs(ref, p1, p2, n, seed, read_len=150, frag=(260, 400),
                err=0.02):
    """n read pairs from `ref` in FR orientation (mate 2 reverse
    complemented), with substitutions at rate `err`."""
    rng = np.random.default_rng(seed)
    contigs = [r.seq for r in read_fastx(ref)]
    comp = str.maketrans("ACGT", "TGCA")

    def noisy(s):
        b = np.frombuffer(s.encode(), dtype=np.uint8).copy()
        hit = rng.random(len(b)) < err
        b[hit] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, int(hit.sum()))]
        return b.tobytes().decode()
    with open(p1, "w") as f1, open(p2, "w") as f2:
        for i in range(n):
            seq = contigs[int(rng.integers(0, len(contigs)))]
            fl = int(rng.integers(*frag))
            st = int(rng.integers(0, len(seq) - fl))
            fr = seq[st:st + fl]
            f1.write(f">p{i}\n{noisy(fr[:read_len])}\n")
            f2.write(f">p{i}\n{noisy(fr[-read_len:])[::-1].translate(comp)}\n")


@pytest.fixture(scope="module")
def splice_run():
    return load("splice", SPLICE_REF, [SPLICE_READS])


@pytest.fixture(scope="module")
def pe_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("pe")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=51)
    p1, p2 = str(d / "r1.fa"), str(d / "r2.fa")
    write_pairs(ref, p1, p2, 24, seed=53)
    return ref, p1, p2


def test_splice_matches_host_and_golden(splice_run, monkeypatch):
    mi, mo, frags = splice_run
    uploads = []
    real = DF.device_index_cached
    monkeypatch.setattr(DF, "device_index_cached",
                        lambda *a: uploads.append(a) or real(*a))
    want = HostRuntime(mi, mo).map_batch(frags)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    got = rt.map_batch(frags)
    assert got == want
    with open(os.path.join(ROOT, "tests", "golden", "splice.sam")) as f:
        golden = [ln.rstrip("\n") for ln in f if not ln.startswith("@")]
    assert [ln for ls in got for ln in ls] == golden
    assert any("N" in ln.split("\t")[5] for ls in got for ln in ls)
    c = rt.timers.counters
    assert c["staged_frags"] == len(frags) and c["ext_device"] > 0
    assert rt.align_exec.n_device == c["ext_device"]
    # splice mode never takes the fused flow: no CSR table upload
    assert uploads == [] and rt._flow is None


def test_paired_end_matches_host(pe_inputs, monkeypatch):
    ref, p1, p2 = pe_inputs
    mi, mo, frags = load("sr", ref, [p1, p2], frag_mode=True)
    assert all(len(f.segs) == 2 for f in frags)
    modes = []
    real = RT.chain_scores_batch
    monkeypatch.setattr(RT, "chain_scores_batch", lambda *a, **kw: (
        modes.append((kw["is_cdna"], kw["many_segs"])) or real(*a, **kw)))
    want = HostRuntime(mi, mo).map_batch(frags)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    got = [ls for b in rt.map_stream([frags[:12], frags[12:]]) for ls in b]
    assert got == want
    assert sum(len(ls) for ls in got) == 2 * len(frags)
    assert (False, True) in modes
    c = rt.timers.counters
    assert c["staged_frags"] == len(frags) and c["ext_device"] > 0
    assert c["staged_device_reads"] > 0 and rt._flow is None


def test_chain_batch_matches_jax(splice_run):
    from minimap2_chaindp_tpu.models.runtime import DeviceRuntime
    mi, mo, frags = splice_run

    def units():
        out = []
        for f in frags:
            _w, _f, us = prepare_frag(mo, f.segs)
            out.extend((u, seed_unit(mi, mo, u)) for u in us)
        return out
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    got = rt._chain_batch(units())
    want = DeviceRuntime(mi, mo)._chain_batch(units())
    assert len(got) == len(want) == len(frags)
    assert rt.timers.counters["staged_device_reads"] == len(frags)
    for k, (a, b) in enumerate(zip(got, want)):
        assert np.array_equal(a.anchors, b.anchors), f"unit {k} anchors"
        assert np.array_equal(a.u, b.u), f"unit {k} chains"


def test_cli_splice_matches_host():
    def cli(module, device):
        out = subprocess.run(
            [sys.executable, "-m", module, "-ax", "splice", "--device",
             device, SPLICE_REF, SPLICE_READS],
            capture_output=True, text=True, cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS="1"))
        assert out.returncode == 0, out.stderr
        return ([ln for ln in out.stdout.split("\n")
                 if not ln.startswith("@PG")], out.stderr)
    port, err = cli("minimap2_chaindp_tpu_torch.cli", "cpu")
    host, _ = cli("minimap2_chaindp_tpu.cli", "host")
    assert port == host
    timers = [ln for ln in err.split("\n") if ln.startswith("[timers]")]
    assert timers and "ext_device=" in timers[-1]
