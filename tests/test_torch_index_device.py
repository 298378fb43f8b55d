"""The port's device index build (index/build_device.py) on the CPU: the
pair sort through torch.sort gives the keys, starts and values of the JAX
package's build_csr_device (XLA on the CPU) and of the native host build,
exactly, on synthetic multi-contig genomes (plain and HPC sketches, the
two cases of tests/test_api_cli.py:346-366 without a reference tree) and
on an empty input; build_index(device=...) gives the host build's index;
and the CLI under MM2TPU_DEVICE_INDEX=1 writes the SAM of --device host."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.index.build_device import \
    build_csr_device as jax_build_csr_device
from minimap2_chaindp_tpu_torch.constants import seq_to_nt4
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.index.build_device import build_csr_device
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx
from minimap2_chaindp_tpu_torch.native import (build_csr_native,
                                               sketch_batch_cat_native)
from minimap2_chaindp_tpu_torch.utils import genome_synth as G

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
# (w, k, flag): map-ont's sketch and an HPC one
SKETCHES = {"plain": (10, 15, 0), "hpc": (5, 19, 1)}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("idx") / "g.fa")
    G.make_genome(path, n_contigs=4, contig_len=60_000, seed=31)
    recs = list(read_fastx(path))
    return [r.name for r in recs], [seq_to_nt4(r.seq) for r in recs]


def _mvs(seqs, w, k, flag):
    cat = np.concatenate(seqs)
    offs = np.concatenate([[0], np.cumsum([len(s) for s in seqs])])
    return sketch_batch_cat_native(cat, offs.astype(np.int64),
                                   np.arange(len(seqs)), w, k, bool(flag))


def _equal(a, b):
    assert len(a) == len(b) == 3
    for x, y, what in zip(a, b, ("keys", "starts", "values")):
        assert x.dtype == y.dtype, what
        assert np.array_equal(x, y), what


@pytest.mark.parametrize("sketch", list(SKETCHES))
def test_csr_matches_jax_and_native(genome, sketch):
    _names, seqs = genome
    mvs = _mvs(seqs, *SKETCHES[sketch])
    assert sum(map(len, mvs)) > 10_000
    # keys shared across contigs: some runs are longer than one
    got = build_csr_device(mvs, "cpu")
    assert (np.diff(got[1]) > 1).any()
    _equal(got, build_csr_native(mvs))
    _equal(got, jax_build_csr_device(mvs))


def test_csr_empty_input():
    want = (np.empty(0, np.uint64), np.zeros(1, np.int64),
            np.empty(0, np.uint64))
    _equal(build_csr_device([], "cpu"), want)
    _equal(build_csr_device([np.empty((0, 2), np.uint64)], "cpu"), want)
    _equal(build_csr_device([], "cpu"), jax_build_csr_device([]))


def test_csr_order_across_the_sign_bit():
    """Keys and values above 2**63 sort after those below, as unsigned."""
    rng = np.random.default_rng(4)
    top = np.uint64(1 << 63)
    x = rng.integers(0, 1 << 40, 300).astype(np.uint64) << np.uint64(8)
    y = rng.integers(0, 1 << 62, 300).astype(np.uint64)
    y[::3] |= top
    x[::5] = x[1]                   # a long run of one key
    mv = np.stack([x, y], axis=1)
    _equal(build_csr_device([mv[:100], mv[100:]], "cpu"),
           build_csr_native([mv[:100], mv[100:]]))


@pytest.mark.parametrize("sketch", list(SKETCHES))
def test_build_index_on_device(genome, sketch):
    names, seqs = genome
    w, k, flag = SKETCHES[sketch]
    host = build_index(names, tuple(seqs), w, k, flag, device=False)
    dev = build_index(names, tuple(seqs), w, k, flag, device="cpu")
    for f in ("keys", "starts", "values"):
        assert np.array_equal(getattr(host, f), getattr(dev, f)), f


def test_cli_device_index_maps_like_host():
    """MM2TPU_DEVICE_INDEX=1 with --device cpu maps and writes the SAM of
    --device host without the variable (apart from @PG)."""
    def cli(device, extra):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env.pop("MM2TPU_DEVICE_INDEX", None)
        env.update(extra)
        out = subprocess.run(
            [sys.executable, "-m", "minimap2_chaindp_tpu_torch.cli",
             "--device", device, "-a", os.path.join(DATA, "splice_genome.fa"),
             os.path.join(DATA, "splice_cdna.fa")],
            capture_output=True, text=True, cwd=ROOT, env=env)
        assert out.returncode == 0, out.stderr
        return [ln for ln in out.stdout.split("\n") if not ln.startswith("@PG")]
    got = cli("cpu", {"MM2TPU_DEVICE_INDEX": "1"})
    assert got == cli("host", {}) and len(got) > 3


def test_cli_device_index_on_cuda_without_a_card():
    """MM2TPU_DEVICE_INDEX=1 with --device cuda on a machine without a
    card exits non-zero with an [ERROR] line: no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.cli", "--device",
         "cuda", "-a", os.path.join(DATA, "splice_genome.fa"),
         os.path.join(DATA, "splice_cdna.fa")],
        capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1", MM2TPU_DEVICE_INDEX="1"))
    assert out.returncode != 0 and out.stdout == ""
    assert "[ERROR]" in out.stderr and "Traceback" not in out.stderr
