"""The stealing lane's guard and final-batch reserve (models/steal.py) on a
utils/genome_synth index, the behaviours of tests/test_steal.py:106 and
:160, which read a reference tree: on a forced unprofitable state (1 s of
CPU a device read against 1 ms a host read) the lane pauses and pulls
nothing while PROBE_S (3600 s) runs, and with PROBE_S at 0 probes and
pulls; in the draining posture with a chunk-wall estimate of 10000 s the
reserve keeps every read on the host lane. Each runs through the port's
TorchRuntime (plain versions) and the JAX package's DeviceRuntime (its
steal module, the same forced state and environment as
tests/test_steal.py), with the same counters' verdicts and the JAX
HostRuntime's bytes. The host lane waits (at most 120 s) until the
device lane has reached the state under test, so that neither lane wins
by a race. The device lane's hand-back of a failed chunk is not ported:
the port re-raises (tests/test_torch_lanes.py
test_steal_device_error_propagates)."""
import os
import sys
import threading
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu import constants as C  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.models import steal as TSteal  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402
from minimap2_chaindp_tpu_torch.utils import genome_synth as G  # noqa: E402

torch.set_num_threads(1)

N_READS = 140           # a batch the stealing lane takes (>= 128)
WAIT_S = 120.0


@pytest.fixture(scope="module")
def lane(tmp_path_factory):
    d = tmp_path_factory.mktemp("steal_guard")
    ref, reads = str(d / "g.fa"), str(d / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=71)
    G.simulate(ref, reads, N_READS, 700, 0.08, seed=3)
    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    return dict(mi=mi, mo=mo, frags=frags,
                want=HostRuntime(mi, mo).map_batch(frags))


def _steal_module(side):
    if side == "port":
        return TSteal
    from minimap2_chaindp_tpu.models import steal
    return steal


def _runtime(side, lane, monkeypatch):
    """A stealing runtime of `side` with its flow built, mid-stream."""
    if side == "port":
        rt = TorchRuntime(lane["mi"], lane["mo"], device="cpu",
                          routing="steal")
    else:
        from minimap2_chaindp_tpu.models.runtime import DeviceRuntime
        monkeypatch.setenv("MM2TPU_NATIVE_CHAIN_MAX", "2048")
        monkeypatch.setenv("MM2TPU_STEAL", "1")
        rt = DeviceRuntime(lane["mi"], lane["mo"])
    rt._get_flow()
    rt._draining = False
    return rt


def _forced(side, rt, **state):
    """A fresh StealState on `rt` with `state` set (the JAX one marked as
    having consumed its persisted verdict, as tests/test_steal.py does)."""
    st = _steal_module(side).StealState()
    if side == "jax":
        st.adopted = True
    for k, v in state.items():
        setattr(st, k, v)
    rt._steal_state = st
    return st


def _hold_host_lane(monkeypatch, mod, reached):
    """The host lane of `mod` waits for `reached()` (polled) before its
    first chunk."""
    real = mod._host_map_chunk

    def host(rt, frags, idxs, rg_id):
        end = time.monotonic() + WAIT_S
        while not reached() and time.monotonic() < end:
            time.sleep(0.01)
        assert reached(), "the device lane did not reach the state"
        return real(rt, frags, idxs, rg_id)
    monkeypatch.setattr(mod, "_host_map_chunk", host)


def _map(rt, lane):
    got = rt.map_batch(lane["frags"])
    assert got == lane["want"]
    return rt.timers.counters


@pytest.mark.parametrize("side", ["port", "jax"])
def test_guard_pauses(lane, monkeypatch, side):
    """An unprofitable lane pauses (steal_paused) and pulls nothing while
    the probe timer runs."""
    mod = _steal_module(side)
    monkeypatch.setattr(mod, "PROBE_S", 3600.0)
    rt = _runtime(side, lane, monkeypatch)
    _forced(side, rt, dev_cpu_per_read=1.0, host_per_read=0.001)
    _hold_host_lane(monkeypatch, mod,
                    lambda: rt.timers.counters.get("steal_paused", 0) >= 1)
    c = _map(rt, lane)
    assert c["steal_paused"] >= 1
    assert c.get("steal_device_reads", 0) == 0
    assert c.get("steal_probe", 0) == 0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_guard_probes(lane, monkeypatch, side):
    """With the probe timer at 0 the paused lane probes: it pulls a chunk
    and maps it on the device."""
    mod = _steal_module(side)
    monkeypatch.setattr(mod, "PROBE_S", 0.0)
    monkeypatch.setattr(mod, "DEV_CH", 8)
    rt = _runtime(side, lane, monkeypatch)
    _forced(side, rt, dev_cpu_per_read=1.0, host_per_read=0.001,
            dev_ch=8)
    pulled = threading.Event()
    real = mod._dev_map_chunk

    def dev(*a, **kw):
        pulled.set()
        return real(*a, **kw)
    monkeypatch.setattr(mod, "_dev_map_chunk", dev)
    _hold_host_lane(monkeypatch, mod, pulled.is_set)
    c = _map(rt, lane)
    assert c["steal_paused"] >= 1 and c["steal_probe"] >= 1
    assert c["steal_device_reads"] > 0


@pytest.mark.parametrize("side", ["port", "jax"])
def test_final_batch_reserve(lane, monkeypatch, side):
    """Draining, with a chunk-wall estimate of 10000 s: any pull would
    strand the join, so the lane leaves every read to the host lane. The
    host lane starts once the device lane's loop has returned."""
    mod = _steal_module(side)
    rt = _runtime(side, lane, monkeypatch)
    rt._draining = True
    _forced(side, rt, chunk_wall_ema=10_000.0, host_per_read=0.001)
    left = threading.Event()
    real = mod._dev_loop_body

    def body(*a, **kw):
        try:
            return real(*a, **kw)
        finally:
            left.set()
    monkeypatch.setattr(mod, "_dev_loop_body", body)
    _hold_host_lane(monkeypatch, mod, left.is_set)
    c = _map(rt, lane)
    assert c.get("steal_device_reads", 0) == 0
    assert c.get("steal_paused", 0) == 0


def test_reserve_lets_a_mid_stream_lane_pull(lane, monkeypatch):
    """The same estimate mid-stream (not draining): the reserve is two
    chunks, and the lane pulls."""
    rt = _runtime("port", lane, monkeypatch)
    _forced("port", rt, chunk_wall_ema=10_000.0, host_per_read=0.001)
    pulled = threading.Event()
    real = TSteal._dev_map_chunk

    def dev(*a, **kw):
        pulled.set()
        return real(*a, **kw)
    monkeypatch.setattr(TSteal, "_dev_map_chunk", dev)
    _hold_host_lane(monkeypatch, TSteal, pulled.is_set)
    c = _map(rt, lane)
    assert c["steal_device_reads"] > 0
