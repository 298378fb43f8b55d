"""The port's device seed collect (plain torch ops, CPU) against the JAX
package's `_collect_dev_pos` on the same inputs and the same CSR tables
(the JAX DeviceIndex's tables carried across with DeviceIndex.from_arrays),
and the per-read live anchors against ops/seeds.collect_seed_hits. Exact
integers, tolerance zero."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import genome_scale as G  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_fastx  # noqa: E402
from minimap2_chaindp_tpu.models.pipeline import seed_unit  # noqa: E402
from minimap2_chaindp_tpu.ops.seeds import collect_seed_hits  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.models.device_flow import (  # noqa: E402
    derive_queries_pos, host_seed_stats)
from minimap2_chaindp_tpu_torch.ops import seeds_device as TS  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("collect")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=13)
    reads = str(d / "r.fa")
    G.simulate(ref, reads, 24, 2000, 0.10, seed=17)
    return ref, reads


@pytest.fixture(scope="module")
def hpc_genome(tmp_path_factory):
    """Homopolymer runs of 2-9 bases make HPC minimizer spans straddle 128
    (tests/test_device_runtime.py:216); queries are forward and reverse
    slices."""
    d = tmp_path_factory.mktemp("collect_hpc")
    rng = np.random.default_rng(5)
    runs = rng.integers(0, 4, 20000)
    seq = "".join("ACGT"[b] * int(rng.integers(2, 10)) for b in runs)
    ref = str(d / "h.fa")
    with open(ref, "w") as f:
        f.write(f">hpc\n{seq}\n")
    comp = str.maketrans("ACGT", "TGCA")
    reads = str(d / "hq.fa")
    with open(reads, "w") as f:
        for i in range(12):
            st = int(rng.integers(0, len(seq) - 2500))
            q = seq[st:st + 2500]
            if i % 2:
                q = q[::-1].translate(comp)
            f.write(f">h{i}\n{q}\n")
    return ref, reads


def setup(ref, reads, preset):
    io, mo = set_opt(preset)
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    infos = [seed_unit(mi, mo, [r], collect_hits=False)
             for r in read_fastx(reads)]
    return mi, mo, [i for i in infos if i.mv is not None and len(i.mv)]


def pack_queries(mi, mo, infos):
    """The flow's H2D-slim inputs (models/device_flow.py run loop)."""
    M = max(len(i.mv) for i in infos)
    R = len(infos)
    qposidx = np.full((R, M), -1, np.int32)
    qpos = np.zeros((R, M), np.int32)
    qspan8 = np.zeros((R, M), np.uint8)
    qls = np.zeros((R, 1), np.int32)
    counts = []
    for r, info in enumerate(infos):
        n, _ss, over, pos, occ = host_seed_stats(mi, info.mv, mo.mid_occ)
        nmv = len(info.mv)
        qposidx[r, :nmv] = np.where((occ > 0) | over, pos, -1)
        qpos[r, :nmv] = (info.mv[:, 1] & np.uint64(0xFFFFFFFF)).astype(
            np.int64)
        qspan8[r, :nmv] = (info.mv[:, 0] & np.uint64(0xFF)).astype(np.int64)
        qls[r, 0] = info.qlen_sum
        counts.append(n)
    cap = 1 << int(np.ceil(np.log2(max(counts) + 1)))
    return qposidx, qpos, qspan8, qls, cap


def port_collect(dx, qposidx, qpos, qspan8, qls, max_occ, cap):
    q = torch.from_numpy(qposidx)
    qtnd, qseg = derive_queries_pos(q)
    out = TS._collect_dev_pos(dx.starts, dx.vhi, dx.vlo, q,
                              torch.from_numpy(qpos),
                              torch.from_numpy(qspan8).to(torch.int32),
                              qseg, qtnd, max_occ, torch.from_numpy(qls),
                              cap=cap)
    return [t.numpy() for t in out]


def test_collect_matches_jax(genome):
    import jax.numpy as jnp
    from minimap2_chaindp_tpu.models import device_flow as JF
    from minimap2_chaindp_tpu.ops import seeds_device as JS
    mi, mo, infos = setup(*genome, "map-ont")
    qposidx, qpos, qspan8, qls, cap = pack_queries(mi, mo, infos)
    jdx = JS.DeviceIndex(mi, with_keys=False)
    dx = TS.DeviceIndex.from_arrays(np.asarray(jdx.starts),
                                    np.asarray(jdx.vhi), np.asarray(jdx.vlo),
                                    "cpu")
    jq = jnp.asarray(qposidx)
    jtnd, jseg = JF.derive_queries_pos(jq)
    want = [np.asarray(v) for v in JS._collect_dev_pos(
        jdx.starts, jdx.vhi, jdx.vlo, jq, jnp.asarray(qpos),
        jnp.asarray(qspan8).astype(jnp.int32), jseg, jtnd,
        jnp.int32(mo.mid_occ), jnp.asarray(qls), cap=cap)]
    got = port_collect(dx, qposidx, qpos, qspan8, qls, mo.mid_occ, cap)
    names = ("xhi", "xlo", "yhi", "ylo", "total", "cnt", "over")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(g, w), name
    # the port's own table upload equals the carried-across tables
    own = TS.DeviceIndex(mi, "cpu")
    for a, b in ((own.starts, dx.starts), (own.vhi, dx.vhi),
                 (own.vlo, dx.vlo)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("preset", ["map-ont", "map-pb"])
def test_collect_matches_host_seed_hits(genome, hpc_genome, preset):
    mi, mo, infos = setup(*(hpc_genome if preset == "map-pb" else genome),
                          preset)
    qposidx, qpos, qspan8, qls, cap = pack_queries(mi, mo, infos)
    if preset == "map-pb":
        assert int(qspan8.max()) > 127   # HPC spans past int8
    dx = TS.device_index_cached(mi, "cpu")
    assert TS.device_index_cached(mi, torch.device("cpu")) is dx
    xhi, xlo, yhi, ylo, total, _cnt, _over = port_collect(
        dx, qposidx, qpos, qspan8, qls, mo.mid_occ, cap)
    n_anchors = n_wide = 0
    for r, info in enumerate(infos):
        t = int(total[r])
        ax = ((xhi[r, :t].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
              << np.uint64(32)) | xlo[r, :t].astype(np.uint64)
        ay = ((yhi[r, :t].astype(np.int64) & 0xFFFFFFFF).astype(np.uint64)
              << np.uint64(32)) | ylo[r, :t].astype(np.uint64)
        sh = collect_seed_hits(mi, mo.flag, mo.mid_occ, info.mv, None,
                               info.qlen_sum)
        assert np.array_equal(np.stack([ax, ay], axis=1), sh.anchors), r
        n_anchors += t
        n_wide += int(((ay >> np.uint64(32)) & np.uint64(0xFF)
                       > np.uint64(127)).sum())
    assert n_anchors > 500
    assert preset != "map-pb" or n_wide > 0


def test_index_fingerprint_sees_content(genome):
    mi, _mo, _ = setup(*genome, "map-ont")
    fp = TS.index_fingerprint(mi)
    assert fp == TS.index_fingerprint(mi)
    vals = mi.values.copy()
    mi.values = vals.copy()
    step = max(1, len(vals) // 4096)
    mi.values[5 * step] ^= np.uint64(2)   # same length, new content
    assert TS.index_fingerprint(mi) != fp
    mi.values = vals
