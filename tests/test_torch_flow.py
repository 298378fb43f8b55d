"""The port's fused flow (CPU, plain versions) against the JAX package's
DeviceFlow in interpret mode, in the pattern of tests/test_mesh_e2e.py:34-80
on a synthetic genome: the same units handled, identical Chains and
SeedHits, the same buckets. Then TorchRuntime against HostRuntime on a batch that mixes
single- and two-segment fragments: byte-identical lines in input order,
the two-segment fragments through the staged path."""
import copy
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import genome_scale as G  # noqa: E402
from minimap2_chaindp_tpu import constants as C  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import Frag, SeqRecord, read_fastx  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.models.pipeline import seed_unit  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu.utils.timers import Timers  # noqa: E402
from minimap2_chaindp_tpu_torch.models.device_flow import DeviceFlow  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def mapped(tmp_path_factory):
    d = tmp_path_factory.mktemp("flow")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=21)
    reads = str(d / "r.fa")
    G.simulate(ref, reads, 24, 2000, 0.10, seed=23)
    io_, mo = set_opt("map-ont")
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.update(mi)
    return mi, mo, list(read_fastx(reads))


def units_of(mi, mo, recs):
    return [([r], seed_unit(mi, mo, [r], collect_hits=False)) for r in recs]


def test_flow_matches_jax_flow(mapped):
    from minimap2_chaindp_tpu.models import device_flow as JDF
    from minimap2_chaindp_tpu.models.device_flow import DeviceFlow as JFlow
    from minimap2_chaindp_tpu.ops import chain_pallas as JCP
    mi, mo, recs = mapped
    u1 = units_of(mi, mo, recs)
    r1, _cold = JFlow(mi, mo, interpret=True).run(u1, Timers())
    for ship in (True, False):
        u2 = units_of(mi, mo, recs)
        timers = Timers()
        r2 = DeviceFlow(mi, mo, device="cpu", ship_anchors=ship).run(
            u2, timers)
        assert set(r1) == set(r2)
        assert len(r2) >= 0.8 * len(recs)
        assert timers.counters["device_reads"] >= 0.8 * len(recs)
        for k in r1:
            a, b = r1[k], r2[k]
            assert np.array_equal(a.anchors, b.anchors), f"unit {k} anchors"
            assert np.array_equal(a.u, b.u), f"unit {k} chain scores"
            sh1, sh2 = u1[k][1].sh, u2[k][1].sh
            assert np.array_equal(sh1.anchors, sh2.anchors)
            assert sh1.rep_len == sh2.rep_len
            assert np.array_equal(sh1.mini_pos, sh2.mini_pos)
    # the buckets the flow groups the reads into, each row's slope and
    # exceptions: the JAX flow's rule (its run(), through the JAX
    # package's own functions) on the same units
    u3, want = units_of(mi, mo, recs), {}
    for k, (_segs, info) in enumerate(u3):
        if not 0 < len(info.mv) <= JDF.M_BUCKETS[-1]:
            continue
        n, span_sum, *_ = JDF.host_seed_stats(mi, info.mv, mo.mid_occ)
        if not 0 < n <= JDF.CAP_BUCKETS[-1]:
            continue
        avg = np.float32(span_sum) / np.float32(n)
        w1, excl = JCP.clin_slope_exc(avg)
        if avg < 1.6 or excl is None:
            continue
        key = (next(m for m in JDF.M_BUCKETS if len(info.mv) <= m),
               next(c for c in JDF.CAP_BUCKETS if n <= c),
               info.gap_qry, info.gap_ref)
        want.setdefault(key, []).append((k, w1, excl))
    _res, _stats, got = DeviceFlow(mi, mo, device="cpu").buckets(u3)
    assert sum(map(len, want.values())) >= 0.8 * len(recs)
    assert [((q["qpos"].shape[1], kw["cap"], kw["gq"], kw["gr"]), entries)
            for entries, q, kw in got] == sorted(want.items())


def test_runtime_matches_host_runtime(mapped):
    mi, mo, recs = mapped
    mo = copy.copy(mo)
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    comp = str.maketrans("ACGT", "TGCA")
    frags = []
    for i, r in enumerate(recs[:16]):
        if i % 4 == 3:   # a two-segment fragment: staged path
            s = r.seq
            frags.append(Frag([SeqRecord(f"p{i}", s[:600]),
                               SeqRecord(f"p{i}",
                                         s[-600:][::-1].translate(comp))]))
        else:
            frags.append(Frag([r]))
    want = HostRuntime(mi, mo).map_batch(frags)
    rt = TorchRuntime(mi, mo, device="cpu")
    got = [ls for batch in rt.map_stream([frags[:9], frags[9:]])
           for ls in batch]
    assert got == want
    c = rt.timers.counters
    assert c["device_reads"] >= 8
    assert c["native_finish"] == c["device_reads"]
    assert c["staged_frags"] == len(frags) - c["native_finish"]
