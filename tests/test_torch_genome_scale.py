"""The port's tools/genome_scale.py on the CPU (`--device cpu`: the lane
with the plain versions beside the host): on a 2 Mbp genome with 20 x 2 kb
reads every identity line reads IDENTICAL (the device-sorted index build
against the native one, the fast path on and off, the lane against the
host under map-ont and map-pb; with --pe and --mesh the pairs and a 1 x 2
mesh too) and the tool exits 0. Each run is held against the JAX tool's
(tools/genome_scale.py --skip-ref) on the same sizes and seeds: the same
genome, reads and pairs, the same [index] keys, positions and occurrence
distribution, the same Q60 accuracy lines, mapeval curve (the port's
paftools) and [pe] counts. Its card test runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_genome_scale.py
"""
import filecmp
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("--mb", "2", "--reads", "20", "--read-len", "2000")
PE = 20


def _run(tmp_path, *args):
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.tools."
         "genome_scale", *SMALL, "--dir", str(tmp_path), *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    return out.returncode, out.stdout, out.stderr


@pytest.fixture(scope="module")
def jax_tool(tmp_path_factory):
    """The JAX tool on the same sizes, with mapeval and PE pairs: (its
    directory, its stdout)."""
    d = tmp_path_factory.mktemp("jax_genome_scale")
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "genome_scale.py"),
         *SMALL, "--skip-ref", "--pe", str(PE), "--dir", str(d)],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
                 MM2TPU_XLA_CACHE="0", TMPDIR=str(d)))
    assert out.returncode == 0, out.stderr[-3000:]
    return str(d), out.stdout


def _identity_lines(out):
    return [ln for ln in out.splitlines()
            if "IDENTICAL" in ln or "MISMATCH" in ln]


def _index_counts(out):
    """The keys and positions of the [index] build line and the whole
    occurrence-distribution line."""
    build = next(ln for ln in out.splitlines()
                 if ln.startswith("[index] build "))
    occ = next(ln for ln in out.splitlines()
               if ln.startswith("[index] occurrence dist:"))
    return re.search(r"[\d.]+M keys, [\d.]+M positions", build)[0], occ


def _lines(out, prefix):
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


def test_genome_scale_cpu_identical(tmp_path, jax_tool):
    rc, out, err = _run(tmp_path, "--device", "cpu")
    assert rc == 0, err + out
    lines = _identity_lines(out)
    # the device build, then per preset fast path on/off and the lane
    assert len(lines) == 5, out
    assert all("MISMATCH" not in ln for ln in lines), out
    assert sum("--device cpu" in ln for ln in lines) == 2
    assert "[load] mmap" in out
    jdir, jout = jax_tool
    assert filecmp.cmp(tmp_path / "genome2.fa",
                       os.path.join(jdir, "genome2.fa"), shallow=False)
    for port, jax in (("ont2_20x2000.fa", "ont2.fa"),
                      ("pb2_20x2000.fa", "pb2.fa")):
        assert filecmp.cmp(tmp_path / port, os.path.join(jdir, jax),
                           shallow=False), port
    assert _index_counts(out) == _index_counts(jout)
    for prefix in ("[reads]", "[map-ont] accuracy:", "[map-pb] accuracy:",
                   "[mapeval]"):
        assert _lines(out, prefix) == _lines(jout, prefix), prefix
        assert _lines(out, prefix), prefix


def test_genome_scale_cpu_pairs_and_mesh(tmp_path, jax_tool):
    rc, out, err = _run(tmp_path, "--device", "cpu", "--skip-build",
                        "--skip-mapeval", "--pe", str(PE), "--mesh", "1x2",
                        "--mesh-reads", "10")
    assert rc == 0, err + out
    lines = _identity_lines(out)
    assert len(lines) == 6 and all("MISMATCH" not in ln for ln in lines)
    assert any(ln.startswith(f"[pe] {PE} FR pairs") for ln in lines)
    assert any(ln.startswith("[mesh 1x2]") for ln in lines)
    jdir, jout = jax_tool
    for mate in (1, 2):
        assert filecmp.cmp(tmp_path / f"pe2_{PE}_{mate}.fq",
                           os.path.join(jdir, f"pe2_{mate}.fq"),
                           shallow=False)
    # the proper and position counts of the [pe] line
    pe = lambda text: _lines(text, "[pe]")[0].split(";")[0]
    assert pe(out) == pe(jout)
    for prefix in ("[map-ont] accuracy:", "[map-pb] accuracy:"):
        assert _lines(out, prefix) == _lines(jout, prefix), prefix


def test_genome_scale_cuda_needs_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _run(tmp_path)
    assert rc != 0 and "no CUDA device" in err
    assert not _identity_lines(out)


@pytest.mark.cuda
def test_genome_scale_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, out, err = _run(tmp_path, "--device", "cuda", "--skip-mapeval",
                        "--pe", str(PE), "--mesh", "1x1", "--mesh-reads",
                        "10")
    assert rc == 0, err + out
    lines = _identity_lines(out)
    assert len(lines) == 7 and all("MISMATCH" not in ln for ln in lines)
    assert out.count("peak device memory") == 3
