"""The port's bench (python -m minimap2_chaindp_tpu_torch.bench): the
headline's chain call at a small size against the JAX package's (Pallas in
interpret mode, exact), its record on the CPU (every time field null, under
2000 characters), a failed row (null, an error string, a non-zero exit),
and no record without a card. The JAX side is imported inside the tests,
so that the card's tests of this file run where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_bench.py
"""
import contextlib
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu_torch import bench as B  # noqa: E402

torch.set_num_threads(1)
TIME_FIELDS = ("value", "vs_baseline", "baseline_host_native_1core",
               "baseline_spread", "pipeline_ms", "pipeline_device_ms")


def _bench(*args):
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.bench", *args],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    return out.returncode, out.stdout, out.stderr


def _jax_headline(n_reads, seed):
    """root bench.py's main_device pack and dispatch on n_reads reads,
    Pallas in interpret mode: (f, p, flag) as numpy arrays."""
    from minimap2_chaindp_tpu.ops import chain_pallas as CP
    from minimap2_chaindp_tpu.ops.chain_jax import split_anchors
    from minimap2_chaindp_tpu.utils.synth import synth_batch
    reads = []
    for a in synth_batch(n_reads, B.ANCHORS_PER_READ, seed=seed):
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(len(a))))
    packed, nn, w1, exc, _flag = CP.pack_reads(reads, B.ANCHORS_PER_READ,
                                               B.MAX_DIST)
    out = CP.chain_scores_batch(
        *(packed[k] for k in ("xhi", "rpos", "qpos", "span", "sid", "stw")),
        nn, w1, exc, max_n=B.ANCHORS_PER_READ, max_dist_x=B.MAX_DIST,
        max_dist_y=B.MAX_DIST, bw=B.BW, max_skip=B.MAX_SKIP, is_cdna=False,
        many_segs=False, interpret=True, use_exc=CP.infer_use_exc(exc),
        score_bound=10300)
    return [np.asarray(t) for t in out]


def test_headline_chain_call_matches_jax():
    """4 reads x 1024 anchors of synth_batch(seed=1) with the bench's
    arguments: the port's --device cpu call equals the JAX kernel's f, p,
    flag, and the headline's fallback_flagged_reads its flag count."""
    want = _jax_headline(4, 1)
    args, use_exc = B.headline_batch(4, 1, torch.device("cpu"))
    got = [t.numpy() for t in B.dispatch(args, use_exc)]
    for name, g, w in zip(("f", "p", "flag"), got, want):
        assert g.shape == w.shape and np.array_equal(g, w), name
    head = B.headline(4, torch.device("cpu"))
    assert head["fallback_flagged_reads"] == int(want[2][:, 0].sum())
    assert head["check_batch1"] == "bit-exact"
    assert head["value"] is None and head["pipeline_ms"] is None


def test_bench_cpu_record():
    rc, out, err = _bench("--device", "cpu", "--reads", "8", "--no-e2e",
                          "--no-projection")
    assert rc == 0, err
    last = out.strip().splitlines()[-1]
    assert len(last) < 2000
    rec = json.loads(last)
    assert rec["metric"] == "chaindp_anchors_per_s"
    assert rec["device"] == {"platform": "cpu"}
    assert rec["reads"] == 8 and rec["check_batch1"] == "bit-exact"
    assert rec["baseline_single_core_c"] is None
    for key in TIME_FIELDS:
        assert rec[key] is None, key


def test_bench_failed_row_is_null_and_exits_nonzero(monkeypatch):
    """A row whose run fails is null with an error string, and the bench
    exits non-zero after printing its record."""
    monkeypatch.setattr(B, "E2E_ROWS",
                        {"e2e": (2, 1000, ("--no-such-option",), 1, {}, 120)})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = B.main(["--device", "cpu", "--reads", "8", "--no-projection"])
    assert rc != 0
    rec = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert rec["e2e_reads_per_s_host"] is None
    assert rec["e2e_reads_per_s_cpu"] is None
    assert rec["e2e_cpu_vs_host_paired_ratio"] is None
    assert rec["e2e_error"].startswith("RuntimeError: exited 2")


def test_bench_cuda_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _bench("--no-e2e", "--no-projection")
    assert rc != 0
    assert "chaindp_anchors_per_s" not in out
    assert "no CUDA device" in err


@pytest.mark.cuda
def test_bench_headline_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, out, err = _bench("--reads", "512", "--no-e2e", "--no-projection")
    assert rc == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["device"]["platform"] == "gpu"
    assert rec["device"]["power_limit"]
    assert rec["value"] > 0 and rec["baseline_host_native_1core"] > 0
    assert rec["check_batch1"] == "bit-exact"
    # two warm-up calls and two pipelines of three
    assert rec["launches"]["chain"] == 2 + 2 * B.N_TIMED
