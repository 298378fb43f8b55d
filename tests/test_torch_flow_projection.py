"""The port's tools/flow_projection.py on the CPU (`--device cpu`, the plain
versions): its counts equal the ones the JAX package's own functions give
the same genome and reads (the JAX tool's eligibility, tools/
flow_projection.py:114-176: reads kept and dropped, anchors per read, the
widest bucket and the transfer estimate, and the buckets JAX's DeviceFlow
groups the reads into), the host stage counters cover every stage,
TorchRuntime's lines equal HostRuntime's, and every time field is null.
Everything the tool writes stays under the test's temp directory. The JAX
side is imported inside the tests, so that the card's test of this file
runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_flow_projection.py
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu_torch.utils.genome_synth import \
    make_genome  # noqa: E402

torch.set_num_threads(1)
ARGS = ("--lengths", "1000", "--reads", "4", "--iters", "1", "--json")
STAGES = ["align", "chain", "collect", "finish", "sketch", "text"]
TIME_FIELDS = ("flow_device_ms_per_read", "host_ms_per_read",
               "host_replaced_ms_per_read", "host_residual_ms_per_read",
               "projected_reads_per_s", "measured_reads_per_s",
               "measured_host_reads_per_s_1core")
PCIE_GBPS = 16.0    # the JAX tool's link rate, for its transfer estimate


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    ref = str(tmp_path_factory.mktemp("flow") / "g.fa")
    make_genome(ref, n_contigs=2, contig_len=200_000, seed=41)
    return ref


def _port(genome, tmp_path, device):
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.tools."
         "flow_projection", *ARGS, "--device", device, "--ref", genome],
        capture_output=True, text=True, cwd=ROOT, timeout=600,
        env=dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path)))
    return out.returncode, out.stdout, out.stderr


def _jax_counts(genome, reads):
    """The JAX tool's count fields (tools/flow_projection.py:114-176) and
    JAX DeviceFlow's buckets (models/device_flow.py:310-357: key (mb, cb,
    gap_qry, gap_ref), sorted) as [mb, cb, reads], through the JAX
    package's functions."""
    from minimap2_chaindp_tpu import constants as C
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.io.fastx import read_fastx
    from minimap2_chaindp_tpu.models.device_flow import (
        CAP_BUCKETS, M_BUCKETS, host_seed_stats)
    from minimap2_chaindp_tpu.models.pipeline import prepare_frag, seed_unit
    from minimap2_chaindp_tpu.ops import chain_pallas as CP
    from minimap2_chaindp_tpu.options import set_opt
    io_, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    refs = list(read_fastx(genome))
    mi = build_index([r.name for r in refs], [r.seq for r in refs],
                     io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.update(mi)
    drops, n_anchors, keys = 0, 0, []
    for s in read_fastx(reads):
        _w, _f, us = prepare_frag(mo, [s])
        info = seed_unit(mi, mo, us[0], collect_hits=False)
        if info.mv is None or not len(info.mv):
            drops += 1
            continue
        n, span_sum, *_ = host_seed_stats(mi, info.mv, mo.mid_occ)
        if n == 0 or len(info.mv) > M_BUCKETS[-1] or n > CAP_BUCKETS[-1]:
            drops += 1
            continue
        avg = np.float32(span_sum) / np.float32(n)
        if avg < 1.6 or CP.clin_slope_exc(avg)[1] is None:
            drops += 1
            continue
        n_anchors += n
        keys.append((next(m for m in M_BUCKETS if len(info.mv) <= m),
                     next(c for c in CAP_BUCKETS if n <= c),
                     info.gap_qry, info.gap_ref))
    apr = n_anchors / len(keys)
    mb = max(k[0] for k in keys)
    xfer_b = 2.0 * mb / 1024 * 1024 + 18.0 * apr
    return dict(n_reads=len(keys), dropped=drops,
                anchors_per_read=round(apr, 1),
                pcie_transfer_us_per_read=round(xfer_b / (PCIE_GBPS * 1e3),
                                                1),
                minimizer_bucket=mb, anchor_cap=max(k[1] for k in keys),
                buckets=[[k[0], k[1], keys.count(k)]
                         for k in sorted(set(keys))])


def _written(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _dirs, fs in os.walk(root) for f in fs)


def test_flow_projection_cpu_counts_match_jax(genome, tmp_path):
    work = tmp_path / "tmp"
    work.mkdir()
    rc, out, err = _port(genome, work, "cpu")
    assert rc == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["device"] == {"platform": "cpu"}
    row = rec["per_length"]["1000"]
    # the tool wrote its reads into the cache under its TMPDIR, and nothing
    # else anywhere
    reads = os.path.join(work, "mm2tpu_torch_cache", "reads_g.fa_1000_4.fa")
    assert _written(work) == [os.path.relpath(reads, work)]
    want = _jax_counts(genome, reads)
    for key, value in want.items():
        assert row[key] == value, key
    assert row["n_reads"] == 4 and row["rows"] == 4
    assert row["host_stages"] == STAGES
    assert row["sam_identical"] is True
    for key in TIME_FIELDS:
        assert row[key] is None, key


def test_flow_projection_cuda_needs_a_card(genome, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc, out, err = _port(genome, tmp_path, "cuda")
    assert rc != 0 and "per_length" not in out
    assert "no CUDA device" in err


@pytest.mark.cuda
def test_flow_projection_on_card(genome, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rc, out, err = _port(genome, tmp_path, "cuda")
    assert rc == 0, err
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["device"]["platform"] == "gpu"
    row = rec["per_length"]["1000"]
    assert row["sam_identical"] is True and row["host_stages"] == STAGES
    for key in TIME_FIELDS:
        assert row[key] is not None and row[key] > 0, key
    assert rec["launches"]["chain"] > 0
