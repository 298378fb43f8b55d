"""The port in the regime of every genome-scale run, on the CPU at a small
size: an 8 Mbp genome (4 x 2 Mbp, utils/genome_synth, seed 42) has more
than 2^20 keys, which switches the native key lookup to its radix
directory (native.key_lookup_batch), as a human genome's 169M keys do. On
it the port's index, its device-sorted build, host_seed_stats and
TorchRuntime's plain versions equal the JAX package's, exactly. The int32
limit of the device tables raises on stand-in counts past 2^31 - 1, and the
chunked upload of the tables equals the whole-array split."""
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu import constants as JC  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index as jax_build  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_frags as jax_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt as jax_opt  # noqa: E402
from minimap2_chaindp_tpu_torch import constants as C  # noqa: E402
from minimap2_chaindp_tpu_torch import native  # noqa: E402
from minimap2_chaindp_tpu_torch.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402
from minimap2_chaindp_tpu_torch.ops import seeds_device as TS  # noqa: E402
from minimap2_chaindp_tpu_torch.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.utils import genome_synth as G  # noqa: E402

torch.set_num_threads(1)

SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR
N_READS, READ_LEN = 40, 5000
TABLES = ("keys", "starts", "values")


@pytest.fixture(scope="module")
def scale(tmp_path_factory):
    d = tmp_path_factory.mktemp("scale")
    ref, reads = str(d / "g.fa"), str(d / "r.fa")
    G.make_genome(ref, n_contigs=4, contig_len=2_000_000, seed=42)
    G.simulate(ref, reads, N_READS, READ_LEN, 0.10, seed=5)
    recs = list(read_fastx(ref))
    names = [r.name for r in recs]
    io, mo = set_opt("map-ont")
    mo.flag |= SAM
    mi = build_index(names, [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    assert len(mi.keys) >= 1 << 20, "the fixture must force the directory"
    mo.update(mi)
    jio, jmo = jax_opt("map-ont")
    jmo.flag |= JC.MM_F_OUT_SAM | JC.MM_F_CIGAR
    jmi = jax_build(names, [r.seq for r in recs], jio.w, jio.k, jio.flag,
                    jio.bucket_bits)
    jmo.update(jmi)
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    jfrags = [f for b in jax_frags([reads], jmo.mini_batch_size, False)
              for f in b]
    return dict(recs=recs, io=io, mi=mi, mo=mo, jmi=jmi, jmo=jmo,
                frags=frags, jfrags=jfrags)


def test_index_equals_jax_build(scale):
    mi, jmi = scale["mi"], scale["jmi"]
    for t in TABLES:
        a, b = getattr(mi, t), getattr(jmi, t)
        assert a.dtype == b.dtype and np.array_equal(a, b), t
    assert scale["mo"].mid_occ == scale["jmo"].mid_occ


def test_device_build_equals_native(scale):
    """build_index(device="cpu"): the pair sort by torch.sort, its pairs
    uploaded contig by contig, equals the native streaming build."""
    io, recs = scale["io"], scale["recs"]
    md = build_index([r.name for r in recs],
                     [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits, n_threads=2, device="cpu")
    for t in TABLES:
        a, b = getattr(md, t), getattr(scale["mi"], t)
        assert a.dtype == b.dtype and np.array_equal(a, b), t


def test_host_seed_stats_match_jax(scale):
    """The flow's host statistics through the radix directory equal the
    JAX package's, read by read."""
    from minimap2_chaindp_tpu.models.device_flow import \
        host_seed_stats as jax_stats
    from minimap2_chaindp_tpu_torch.models.device_flow import \
        host_seed_stats
    from minimap2_chaindp_tpu_torch.models.pipeline import (prepare_frag,
                                                             seed_unit)
    mi, mo, jmi = scale["mi"], scale["mo"], scale["jmi"]
    probe = mi.keys[:4]
    assert native.key_lookup_batch(mi.keys, probe) is not None
    n_any = 0
    for fr in scale["frags"]:
        _w, _f, us = prepare_frag(mo, fr.segs)
        mv = seed_unit(mi, mo, us[0], collect_hits=False).mv
        got = host_seed_stats(mi, mv, mo.mid_occ)
        want = jax_stats(jmi, mv, scale["jmo"].mid_occ)
        assert got[:2] == tuple(int(x) for x in want[:2])
        for g, w in zip(got[2:], want[2:]):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        n_any += got[0] > 0
    assert n_any == len(scale["frags"])


def test_torch_runtime_matches_jax_host(scale):
    """TorchRuntime on its plain versions writes the JAX HostRuntime's
    lines for the 5 kb reads, exactly; the fused flow took them."""
    rt = TorchRuntime(scale["mi"], scale["mo"], device="cpu", n_threads=2)
    got = rt.map_batch(scale["frags"])
    rt.close()
    want = HostRuntime(scale["jmi"], scale["jmo"]).map_batch(scale["jfrags"])
    assert got == want
    assert rt.timers.counters["device_reads"] >= 0.9 * N_READS


def test_device_index_upload_equals_split(scale, monkeypatch):
    """The chunked upload of the tables (several chunks here) gives the
    JAX DeviceIndex's int32 tables, and the whole-array numpy split of
    values with every high bit pattern."""
    from minimap2_chaindp_tpu.ops import seeds_device as JS
    monkeypatch.setattr(TS, "UPLOAD_CHUNK", 100_003)
    mi = scale["mi"]
    dx = TS.DeviceIndex(mi, "cpu")
    jdx = JS.DeviceIndex(scale["jmi"], with_keys=False)
    for t in ("starts", "vhi", "vlo"):
        assert np.array_equal(getattr(dx, t).numpy(),
                              np.asarray(getattr(jdx, t))), t
    rng = np.random.default_rng(3)
    vals = rng.integers(0, 2**64 - 1, 250_000, dtype=np.uint64, endpoint=True)
    vals[:4] = [0, 2**31, 2**63, 2**64 - 1]
    fake = SimpleNamespace(keys=np.arange(3, dtype=np.uint64),
                           starts=np.array([0, 1, 2, len(vals)], np.int64),
                           values=vals)
    dx = TS.DeviceIndex(fake, "cpu")
    want_hi = (vals >> np.uint64(32)).astype(np.int64).astype(np.int32)
    want_lo = (vals & np.uint64(0xFFFFFFFF)).astype(np.int64).astype(np.int32)
    assert np.array_equal(dx.vhi.numpy(), want_hi)
    assert np.array_equal(dx.vlo.numpy(), want_lo)
    assert np.array_equal(dx.starts.numpy(), fake.starts.astype(np.int32))


def _zero_stride(n, dtype):
    """An array of n elements that allocates one."""
    return np.lib.stride_tricks.as_strided(np.zeros(1, dtype), (n,), (0,))


@pytest.mark.parametrize("n_keys, n_pos, ok", [
    (2**31 - 1, 2**31 - 1, True), (2**31, 5, False), (5, 2**31, False)],
    ids=["at-limit", "keys-past", "positions-past"])
def test_int32_limit_counts(n_keys, n_pos, ok):
    if ok:
        TS.check_int32_tables(n_keys, n_pos)
    else:
        with pytest.raises(ValueError, match=r"2\^31 - 1"):
            TS.check_int32_tables(n_keys, n_pos)


def test_int32_limit_device_index_and_shards():
    """DeviceIndex and shard_index_tables raise on an index past the
    limit (stand-in arrays of 2^31 + 4 positions that allocate nothing)
    before they split or upload a table; from_arrays does too."""
    n = 2**31 + 4
    big = SimpleNamespace(keys=np.array([7, 9], np.uint64),
                          starts=np.array([0, 2, n], np.int64),
                          values=_zero_stride(n, np.uint64))
    with pytest.raises(ValueError, match="2147483647"):
        TS.DeviceIndex(big, "cpu")
    with pytest.raises(ValueError, match="index shard of 2"):
        TS.shard_index_tables(big, 2)
    with pytest.raises(ValueError, match=r"2\^31 - 1"):
        TS.DeviceIndex.from_arrays(np.zeros(3, np.int32),
                                   _zero_stride(n, np.int32),
                                   _zero_stride(n, np.int32), "cpu")
