"""The port's tools/e2e_bench.py: `--device pair` on the CPU (the cpu lane
with the plain versions against the host lane) writes the same SAM on
both lanes and the same as the JAX package's CLI on the host path, apart
from @PG, and prints the steady and paired-ratio lines; a lane SAM that
differs from the host's exits non-zero. The JAX side runs as a
subprocess, so the card's tests of this file run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_e2e_bench.py
"""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu_torch.tools import e2e_bench as E  # noqa: E402
from minimap2_chaindp_tpu_torch.utils.genome_synth import \
    make_genome  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    ref = str(tmp_path_factory.mktemp("e2e") / "g.fa")
    make_genome(ref, n_contigs=2, contig_len=200_000, seed=31)
    return ref


def _run(module, args):
    out = subprocess.run([sys.executable, "-m", module, *args],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    return out.returncode, out.stdout, out.stderr


def _body(text):
    return [ln for ln in text.split("\n") if ln and not ln.startswith("@PG")]


def _pair(genome, work, lane):
    return _run("minimap2_chaindp_tpu_torch.tools.e2e_bench",
                ["--ref-fa", genome, "--reads", "20", "--len", "2000",
                 "--device", "pair", "--pair-lane", lane, "--steady", "1",
                 "--workdir", str(work)])


def test_pair_cpu_matches_host_and_jax_cli(genome, tmp_path):
    rc, out, err = _pair(genome, tmp_path, "cpu")
    assert rc == 0, err
    for key in ("steady[cpu]:", "steady[host]:", "paired_ratio_median:"):
        assert sum(ln.startswith(key) for ln in out.splitlines()) == 1, key
    assert "sam_identical: 2/2" in out
    assert "flow1[cpu]: device_reads=" in err
    reads = tmp_path / "reads.fa"
    lanes = {dev: _body((tmp_path / f"{dev}.sam").read_text())
             for dev in ("cpu", "host")}
    assert lanes["cpu"] == lanes["host"]
    assert sum(not ln.startswith("@") for ln in lanes["host"]) >= 20
    rc, jax_sam, err = _run("minimap2_chaindp_tpu.cli",
                            ["-ax", "map-ont", "-K", str(400 * 2000),
                             "--device", "host", genome, str(reads)])
    assert rc == 0, err
    assert lanes["host"] == _body(jax_sam)


def test_pair_keeps_the_largest_kernel_inputs(genome, tmp_path):
    """--keep-inputs writes the largest chain input of the lane's runs
    (utils/kernel_inputs.py); on it the port's chain wrapper equals the JAX
    package's Pallas kernel in interpret mode."""
    import numpy as np
    from minimap2_chaindp_tpu_torch.ops.chain_dp import chain_scores_batch
    from minimap2_chaindp_tpu_torch.utils import kernel_inputs
    keep = tmp_path / "keep"
    rc, out, err = _run("minimap2_chaindp_tpu_torch.tools.e2e_bench",
                        ["--ref-fa", genome, "--reads", "6", "--len",
                         "2000", "--device", "pair", "--pair-lane", "cpu",
                         "--steady", "1", "--workdir", str(tmp_path),
                         "--keep-inputs", str(keep)])
    assert rc == 0, err
    assert "kept_inputs: chain_single" in out
    kept = kernel_inputs.load(str(keep), "cpu")
    args, kw = kept["chain_single"]
    assert kw["max_n"] == args[1].shape[1] and int(args[6][:, 0].max()) > 0
    got = [t.numpy() for t in chain_scores_batch(*args, **kw)]
    from minimap2_chaindp_tpu.ops import chain_pallas as CP
    R = args[0].shape[0]
    pad = -R % 8
    fill = lambda a: np.concatenate(
        [a.numpy(), np.full((pad, *a.shape[1:]), -1 if a is args[8] else 0,
                            a.numpy().dtype)])
    want = CP.chain_scores_batch(*map(fill, args), **kw, interpret=True)
    for name, g, w in zip(("f", "p", "flag"), got, want):
        assert np.array_equal(g, np.asarray(w)[:R]), name


def test_pair_sam_mismatch_exits_nonzero(genome, tmp_path, monkeypatch):
    """The check new to the port's copy: a lane whose SAM differs from the
    host lane's fails the run."""
    body = E.sam_body
    monkeypatch.setattr(
        E, "sam_body",
        lambda path: body(path) + (["extra\n"] if "cpu" in path else []))
    with pytest.raises(SystemExit) as exc:
        E.main(["--ref-fa", genome, "--reads", "4", "--len", "2000",
                "--device", "pair", "--pair-lane", "cpu", "--steady", "1",
                "--workdir", str(tmp_path)])
    assert exc.value.code == 1


def test_cuda_lane_needs_a_card(genome, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _run("minimap2_chaindp_tpu_torch.tools.e2e_bench",
                        ["--ref-fa", genome, "--reads", "2", "--device",
                         "cuda", "--steady", "1"])
    assert rc != 0 and "steady:" not in out


@pytest.mark.cuda
def test_pair_cuda_matches_host_on_card(genome, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, out, err = _pair(genome, tmp_path, "cuda")
    assert rc == 0, err
    assert "sam_identical: 2/2" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("launches:"))
    counts = dict(t.split("=") for t in line.split()[1:])
    assert int(counts["chain"]) > 0
