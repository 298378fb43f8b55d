"""The port's seed collection by key (ops/seeds_device.py: `_collect_dev`,
`DeviceSeedCollector`; plain torch ops on the CPU) against the JAX
package's (jax.jit on the CPU) and against ops/seeds.collect_seed_hits:
seeded queries with over-occurring, tandem and absent keys, HPC spans over
127, and reads at and just past each minimizer bucket. Then TorchRuntime
with device_seeds against HostRuntime on read pairs. Exact integers,
tolerance zero."""
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import genome_scale as G  # noqa: E402
from minimap2_chaindp_tpu import constants as C  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.ops.seeds import (collect_minimizers,  # noqa: E402
                                            collect_seed_hits)
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402
from minimap2_chaindp_tpu_torch.ops import seeds_device as TS  # noqa: E402
from test_torch_staged import write_pairs  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR


def index(ref, preset):
    io, mo = set_opt(preset)
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    return mi, mo


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """2 x 150 kb with repeat families; queries: simulated reads (present
    keys, some over-occurring), a random sequence (absent keys), a tandem
    repeat (adjacent equal keys) and one 25 kb read, cut to each
    minimizer bucket's edges."""
    d = tmp_path_factory.mktemp("seeds_dev")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=61)
    reads = str(d / "r.fa")
    G.simulate(ref, reads, 12, 1500, 0.08, seed=63)
    long_reads = str(d / "l.fa")
    G.simulate(ref, long_reads, 1, 25_000, 0.05, seed=65)
    rng = np.random.default_rng(67)
    seqs = [r.seq for r in read_fastx(reads)]
    seqs.append("".join("ACGT"[b] for b in rng.integers(0, 4, 1200)))
    g = next(iter(read_fastx(ref))).seq
    seqs.append(g[5000:5037] * 30 + g[9000:9400])
    return ref, seqs, next(iter(read_fastx(long_reads))).seq


@pytest.fixture(scope="module")
def hpc(tmp_path_factory):
    """Homopolymer runs of 2-9 bases: HPC spans straddle 128
    (tests/test_device_runtime.py:216); forward and reverse queries."""
    d = tmp_path_factory.mktemp("seeds_dev_hpc")
    rng = np.random.default_rng(5)
    seq = "".join("ACGT"[b] * int(rng.integers(2, 10))
                  for b in rng.integers(0, 4, 12000))
    ref = str(d / "h.fa")
    with open(ref, "w") as f:
        f.write(f">hpc\n{seq}\n")
    comp = str.maketrans("ACGT", "TGCA")
    qs = []
    for i in range(8):
        st = int(rng.integers(0, len(seq) - 2500))
        q = seq[st:st + 2500]
        qs.append(q[::-1].translate(comp) if i % 2 else q)
    return ref, qs


@pytest.mark.parametrize("max_occ", [3, 50])
def test_collect_dev_matches_jax(genome, max_occ):
    """Every output of the key path, pad slots included, equals the JAX
    jit's on the same tables and queries."""
    import jax.numpy as jnp
    from minimap2_chaindp_tpu.ops import seeds_device as JS
    ref, seqs, _long = genome
    mi, mo = index(ref, "map-ont")
    mvs = [collect_minimizers(mo, mi, [s]) for s in seqs]
    q = TS.key_queries(mvs, [len(s) for s in seqs], 512)
    assert q["qtnd"].any()                       # tandem keys
    jdx = JS.DeviceIndex(mi)
    order = TS.KEY_QUERY
    want = [np.asarray(v) for v in JS._collect_dev(
        jdx.khi, jdx.klo, jdx.starts, jdx.vhi, jdx.vlo,
        *(jnp.asarray(q[k]) for k in order), jnp.int32(max_occ),
        jnp.asarray(q["qls"]), cap=2048)]
    dx = TS.DeviceIndex(mi, "cpu")
    assert dx.khi is None                        # no keys until asked
    khi, klo = dx.key_tables()
    assert np.array_equal(khi.numpy(), np.asarray(jdx.khi))
    assert np.array_equal(klo.numpy(), np.asarray(jdx.klo))
    got = [t.numpy() for t in TS._collect_dev(
        khi, klo, dx.starts, dx.vhi, dx.vlo,
        *(torch.from_numpy(q[k]) for k in order), max_occ,
        torch.from_numpy(q["qls"]), cap=2048)]
    names = ("xhi", "xlo", "yhi", "ylo", "total", "cnt", "over")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), name
    over, cnt = got[6], got[5]
    assert over.any() and (cnt[q["qvalid"]] == 0).any()   # over and absent
    assert (got[4] > 0).sum() >= len(seqs) - 1


def check_collector(mi, mo, mvs, qlens, names, expect_none=()):
    """The port's DeviceSeedCollector against the JAX one and against
    collect_seed_hits, read by read. Returns the reads collected."""
    from minimap2_chaindp_tpu.ops.seeds_device import \
        DeviceSeedCollector as JCollector
    got = TS.DeviceSeedCollector(mi, "cpu").collect_batch(mvs, mo.mid_occ,
                                                          qlens)
    want = JCollector(mi).collect_batch(mvs, mo.mid_occ, qlens)
    n = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g is None) == (w is None), i
        assert (g is None) == (i in expect_none), i
        if g is None:
            continue
        host = collect_seed_hits(mi, mo.flag, mo.mid_occ, mvs[i], names[i],
                                 qlens[i])
        for ref_sh in (w, host):
            assert np.array_equal(g.anchors, ref_sh.anchors), i
            assert g.rep_len == ref_sh.rep_len, i
            assert np.array_equal(g.mini_pos, ref_sh.mini_pos), i
        n += 1
    return n


def test_collector_matches_jax_and_host(genome):
    ref, seqs, _long = genome
    mi, mo = index(ref, "map-ont")
    mvs = [collect_minimizers(mo, mi, [s]) for s in seqs]
    assert check_collector(mi, mo, mvs, [len(s) for s in seqs],
                           [f"q{i}" for i in range(len(seqs))]) == len(seqs)


def test_collector_bucket_edges(genome):
    """Reads at and one minimizer past each bucket (256, 1024, 4096): past
    the last one the read is left to the host."""
    ref, _seqs, long_seq = genome
    mi, mo = index(ref, "map-ont")
    mv = collect_minimizers(mo, mi, [long_seq])
    assert len(mv) > 4097
    cuts = (256, 257, 1024, 1025, 4096, 4097)
    mvs = [mv[:n] for n in cuts]
    n = check_collector(mi, mo, mvs, [len(long_seq)] * len(cuts),
                        [f"c{c}" for c in cuts], expect_none={5})
    assert n == 5


def test_collector_hpc_spans_over_127(hpc):
    ref, qs = hpc
    mi, mo = index(ref, "map-pb")          # the HPC preset
    mvs = [collect_minimizers(mo, mi, [q]) for q in qs]
    spans = np.concatenate([mv[:, 0] & np.uint64(0xFF) for mv in mvs])
    assert (spans > 127).any() and (spans < 128).any()
    assert check_collector(mi, mo, mvs, [len(q) for q in qs],
                           [f"h{i}" for i in range(len(qs))]) == len(qs)


def test_runtime_device_seeds_pairs(tmp_path):
    """Paired-end sr through the staged path with device seed collection:
    byte-identical to HostRuntime; units past the collector's anchor cap
    (low-complexity pairs) are collected on the host."""
    ref = str(tmp_path / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=51)
    p1, p2 = str(tmp_path / "r1.fa"), str(tmp_path / "r2.fa")
    write_pairs(ref, p1, p2, 16, seed=57)
    mi, mo = index(ref, "sr")
    mo.flag |= SAM
    frags = [f for b in read_frags([p1, p2], mo.mini_batch_size, True)
             for f in b]
    want = HostRuntime(mi, mo).map_batch(frags)
    rt = TorchRuntime(mi, mo, device="cpu", device_seeds=True)
    got = [ls for b in rt.map_stream([frags[:8], frags[8:]]) for ls in b]
    assert got == want
    c = rt.timers.counters
    assert c["device_seed"] + c.get("host_seed", 0) == len(frags)
    assert c["device_seed"] >= 0.8 * len(frags)
    assert rt._seed_collector.dx.khi is not None
