"""The port's CLI on the CPU (`--device cpu`: the fused flow with the plain
versions) against the JAX package's CLI on the host path: byte-identical
SAM and PAF apart from @PG. Without a GPU, `--device cuda` exits non-zero."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import genome_scale as G  # noqa: E402


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=31)
    reads = str(d / "r.fa")
    G.simulate(ref, reads, 24, 2000, 0.10, seed=37)
    return ref, reads


def _cli(module, args):
    # one intra-op thread: the plain versions' small torch ops only spin
    # against the other test workers
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, cwd=ROOT,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    return out.returncode, out.stdout, out.stderr


@pytest.mark.parametrize("fmt", ["-a", "-c"], ids=["sam", "paf"])
def test_port_cli_matches_host_cli(inputs, fmt):
    ref, reads = inputs
    rc, port, err = _cli("minimap2_chaindp_tpu_torch.cli",
                         [fmt, "-x", "map-ont", "--print-qname", "--device",
                          "cpu", ref, reads])
    assert rc == 0, err
    rc, host, err_h = _cli("minimap2_chaindp_tpu.cli",
                           [fmt, "-x", "map-ont", "--print-qname",
                            "--device", "host", ref, reads])
    assert rc == 0, err_h
    strip = lambda s: [ln for ln in s.split("\n") if not ln.startswith("@PG")]
    assert strip(port) == strip(host)
    assert sum(1 for ln in port.split("\n") if ln and ln[0] != "@") >= 24
    qr = lambda s: [ln for ln in s.split("\n") if ln.startswith("QR\t")]
    assert len(qr(err)) == 24 and qr(err) == qr(err_h)
    stat = lambda s: [ln.split("] ", 1)[1] for ln in s.split("\n")
                      if ln.startswith("[M::mm_idx_stat")]
    assert len(stat(err)) == 2 and stat(err) == stat(err_h)
    timers = [ln for ln in err.split("\n") if ln.startswith("[timers]")]
    assert timers and "device_reads=" in timers[-1]


def test_port_cli_cuda_needs_a_gpu(inputs):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ref, reads = inputs
    rc, out, err = _cli("minimap2_chaindp_tpu_torch.cli",
                        ["-a", "--device", "cuda", ref, reads])
    assert rc != 0
    assert "CUDA" in err and not out
