"""The port's routings (models/runtime.py, models/steal.py) on the CPU with
the kernels' plain versions: every routing, with the crossovers at 0 and
at values that split the test reads, writes HostRuntime's lines through
map_stream, as does the JAX DeviceRuntime under the environment the CLI
maps to that routing; the stealing lane really steals, covers every read
once and lets a device-lane error out; its economics equal the JAX
module's on seeded sequences; the extension crossover of
CudaAlignExecutor; and the CLI under MM2TPU_FLOW_SHARE and MM2TPU_STEAL.
Every comparison is exact."""
import copy
import os
import random
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, ROOT)

import genome_scale as G  # noqa: E402
from minimap2_chaindp_tpu import constants as C  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags  # noqa: E402
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.cli import runtime_kwargs  # noqa: E402
from minimap2_chaindp_tpu_torch.models import steal as TSteal  # noqa: E402
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime  # noqa: E402

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR
N_STEAL = 140           # a batch the stealing lane takes (>= 128)
N_ROUTE = 24            # the routing cases: three batches of 8
CHAIN_SPLIT = 60        # anchors: about the 300 bp reads' own count
EXT_SPLIT = 100         # bases of query plus target of a job


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    d = tmp_path_factory.mktemp("lanes")
    ref, reads = str(d / "g.fa"), str(d / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=71)
    G.simulate(ref, reads, N_STEAL, 300, 0.03, seed=73)
    io, mo = set_opt("map-ont")
    mo.flag |= SAM
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io.w, io.k, io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for b in read_frags([reads], mo.mini_batch_size, False)
             for f in b]
    want = HostRuntime(mi, mo).map_batch(frags)
    return dict(ref=ref, reads=reads, mi=mi, mo=mo, frags=frags, want=want)


ROUTING_ENV = {
    "device": {},
    "share": {"MM2TPU_FLOW_SHARE": "0.5"},
    "steal": {"MM2TPU_STEAL": "1"},
    "host": {"MM2TPU_DEVICE_FLOW": "0"},
}
SPLIT_ENV = {"MM2TPU_NATIVE_CHAIN_MAX": str(CHAIN_SPLIT),
             "MM2TPU_NATIVE_EXT_MAX": str(EXT_SPLIT)}


def route_batches(frags):
    return [frags[i:i + 8] for i in range(0, N_ROUTE, 8)]


@pytest.mark.parametrize("split", [False, True], ids=["cross0", "split"])
@pytest.mark.parametrize("routing", list(ROUTING_ENV))
def test_routing_matches_host(lanes, routing, split):
    env = dict(ROUTING_ENV[routing], **(SPLIT_ENV if split else {}))
    kw = runtime_kwargs(env)
    assert kw["routing"] == routing
    rt = TorchRuntime(lanes["mi"], lanes["mo"], device="cpu", n_threads=3,
                      **kw)
    got = [ls for b in rt.map_stream(route_batches(lanes["frags"]))
           for ls in b]
    assert got == lanes["want"][:N_ROUTE]
    assert rt._draining            # map_stream restores the final posture
    c = rt.timers.counters
    if routing == "host":
        assert c["fast_native"] == N_ROUTE
    else:
        assert c["native_finish"] > 0
    if routing == "share" and split:
        # the host lane takes the reads under 5 bases an anchor of the
        # crossover, the flow half of the rest
        assert 0 < c["fast_native"] < N_ROUTE
    if split and routing in ("device", "steal"):
        assert c["host_chain"] + c["ext_native"] > 0
    if not split and routing != "host":
        assert c.get("fast_native", 0) == 0 and c.get("host_chain", 0) == 0


@pytest.mark.parametrize("routing", list(ROUTING_ENV))
def test_jax_runtime_under_same_env(lanes, routing, monkeypatch):
    """The JAX DeviceRuntime under the environment the CLI maps to the
    routing (the split chain crossover; MM2TPU_STEAL=1 also sets the JAX
    conftest's MM2TPU_NATIVE_CHAIN_MAX=2048, as tests/test_steal.py:59-66
    does). Its extension crossover stays at its default: below it every
    job would run the Pallas kernel in interpret mode, minutes on the
    CPU."""
    from minimap2_chaindp_tpu.models.runtime import DeviceRuntime
    env = dict(ROUTING_ENV[routing],
               MM2TPU_NATIVE_CHAIN_MAX="2048" if routing == "steal"
               else str(CHAIN_SPLIT))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("MM2TPU_NATIVE_EXT_MAX", raising=False)
    rt = DeviceRuntime(lanes["mi"], copy.copy(lanes["mo"]), n_threads=3)
    got = [ls for b in rt.map_stream(route_batches(lanes["frags"]))
           for ls in b]
    assert got == lanes["want"][:N_ROUTE]


def _hold_host_lane(monkeypatch, pulled: threading.Event, record=None):
    """Make the host lane wait (at most 120 s) until the device lane has
    entered its first chunk, so the race between the lanes always leaves
    the device lane work; record which reads each lane maps."""
    real_host, real_dev = TSteal._host_map_chunk, TSteal._dev_map_chunk

    def host(rt, frags, idxs, rg_id):
        pulled.wait(120)
        if record is not None:
            record["host"].extend((id(frags), i) for i in idxs)
        return real_host(rt, frags, idxs, rg_id)

    def dev(rt, frags, idxs, rg_id):
        pulled.set()
        if record is not None:
            record["dev"].extend((id(frags), i) for i in idxs)
        return real_dev(rt, frags, idxs, rg_id)
    monkeypatch.setattr(TSteal, "_host_map_chunk", host)
    monkeypatch.setattr(TSteal, "_dev_map_chunk", dev)


def test_steal_lane_steals(lanes, monkeypatch):
    """Two batches through map_stream: the first while more input is
    coming (the lane pulls with the mid-stream reserve), the second as the
    stream's last. Byte-identical, the device lane took reads, and the two
    lanes together mapped every read of each batch exactly once."""
    monkeypatch.setattr(TSteal, "DEV_CH", 8)
    pulled = threading.Event()
    record = {"host": [], "dev": []}
    _hold_host_lane(monkeypatch, pulled, record)
    rt = TorchRuntime(lanes["mi"], lanes["mo"], device="cpu", n_threads=3,
                      routing="steal")
    frags = lanes["frags"]
    b1, b2 = list(frags), list(frags)

    def batches():
        yield b1
        pulled.wait(120)      # more input arrives once the lane has pulled
        yield b2
    got = [ls for b in rt.map_stream(batches()) for ls in b]
    assert got == lanes["want"] + lanes["want"]
    c = rt.timers.counters
    assert c["steal_device_reads"] > 0 and c["steal_chunks"] > 0
    assert c["native_finish"] + c.get("steal_dev_fallback", 0) \
        == c["steal_device_reads"]
    for b in (b1, b2):
        mapped = [i for lane in ("host", "dev") for f, i in record[lane]
                  if f == id(b)]
        assert sorted(mapped) == list(range(N_STEAL))
    assert "steal_cpu_prep_ms" in c and "steal_cpu_finish_ms" in c


def test_steal_device_error_propagates(lanes, monkeypatch):
    """An exception inside the device lane's chunk leaves map_batch."""
    pulled = threading.Event()
    _hold_host_lane(monkeypatch, pulled)

    def broken(rt, frags, idxs, rg_id):
        pulled.set()
        raise RuntimeError("device lane failed")
    monkeypatch.setattr(TSteal, "_dev_map_chunk", broken)
    rt = TorchRuntime(lanes["mi"], lanes["mo"], device="cpu",
                      routing="steal")
    rt._draining = False
    with pytest.raises(RuntimeError, match="device lane failed"):
        rt.map_batch(lanes["frags"])


def test_steal_concurrent_first_chunks_are_cold(lanes, monkeypatch):
    """map_stream's two batch threads each start a lane, and their first
    chunks run at the same time (held behind a barrier): both were pulled
    before any chunk returned, so neither feeds the lane's estimate, and
    the two threads end with one StealState between them."""
    real_dev = TSteal._dev_map_chunk
    barrier = threading.Barrier(2, timeout=120)
    n_back, both_back = [], threading.Event()
    made = []

    class CountedState(TSteal.StealState):
        def __init__(self):
            made.append(self)
            threading.Event().wait(0.2)   # widen the creation race
            super().__init__()

    def dev(rt, frags, idxs, rg_id):
        barrier.wait()
        try:
            return real_dev(rt, frags, idxs, rg_id)
        finally:
            n_back.append(1)
            if len(n_back) >= 2:
                both_back.set()

    def host(rt, frags, idxs, rg_id):
        # the host lanes start once both first chunks have returned; the
        # lanes, then at DEV_CH_MAX, find too little left to pull again
        assert both_back.wait(120)
        return real_host(rt, frags, idxs, rg_id)
    real_host = TSteal._host_map_chunk
    monkeypatch.setattr(TSteal, "StealState", CountedState)
    monkeypatch.setattr(TSteal, "_dev_map_chunk", dev)
    monkeypatch.setattr(TSteal, "_host_map_chunk", host)
    rt = TorchRuntime(lanes["mi"], lanes["mo"], device="cpu", n_threads=3,
                      routing="steal")
    frags = lanes["frags"]
    got = [ls for b in rt.map_stream([list(frags), list(frags)])
           for ls in b]
    assert got == lanes["want"] + lanes["want"]
    assert len(made) == 1 and rt._steal_state is made[0]
    st, c = rt._steal_state, rt.timers.counters
    assert c["steal_chunks"] == 2 and c["steal_cold_chunks"] == 2
    assert st.dev_cpu_per_read is None
    assert st.chunk_wall_ema == TSteal.CHUNK_EST_S


def test_steal_economics_match_jax(monkeypatch):
    """_ema, _unprofitable and the host lane's cost estimates (EMA and the
    fast-down/slow-up best) equal the JAX module's on seeded sequences."""
    from minimap2_chaindp_tpu.models import steal as JSteal
    from minimap2_chaindp_tpu.utils.timers import Timers
    rng = random.Random(5)
    prev = None
    for _ in range(400):
        x = rng.choice([rng.uniform(1e-4, 1e-2), rng.uniform(0.05, 0.2)])
        assert TSteal._ema(prev, x) == JSteal._ema(prev, x)
        prev = TSteal._ema(prev, x) if rng.random() < 0.8 else None
    for _ in range(400):
        ts, js = TSteal.StealState(), JSteal.StealState()
        dev, host, best = (None if rng.random() < p
                           else rng.uniform(1e-4, 5e-3)
                           for p in (0.1, 0.1, 0.3))
        for st in (ts, js):
            st.dev_cpu_per_read, st.host_per_read = dev, host
            st.host_best = best
        assert TSteal._unprofitable(ts) == JSteal._unprofitable(js)
    assert (TSteal.GUARD, TSteal.PROBE_S, TSteal.DEV_CH, TSteal.DEV_CH_MAX,
            TSteal.HOST_CH, TSteal._ALPHA) == (
        JSteal.GUARD, JSteal.PROBE_S, JSteal.DEV_CH, JSteal.DEV_CH_MAX,
        JSteal.HOST_CH, JSteal._ALPHA)

    # the host-lane update, driven through both run_steal_batch with the
    # chunks mapped instantly and the clock replaying one seeded sequence
    clock = [0.0]
    for _ in range(40):
        clock.append(clock[-1] + rng.choice([0.001, 0.02, 0.5, 3.0, 90.0]))

    def fake_time():
        it = iter(clock)
        return SimpleNamespace(monotonic=lambda: next(it),
                               thread_time=lambda: 0.0)
    frags = [SimpleNamespace(segs=[SimpleNamespace(seq="A" * 100)])
             for _ in range(24 * 20)]
    chunk = lambda rt, fr, idxs, rg: {i: [f"r{i}"] for i in idxs}
    states = []
    for mod, rt in (
            (JSteal, SimpleNamespace(_interpret=True, device_flow=False,
                                     timers=Timers(), mi=None)),
            (TSteal, SimpleNamespace(opt=set_opt("splice")[1],
                                     timers=Timers(), _draining=True))):
        st = mod.StealState()
        st.adopted = True
        rt._steal_state = st
        monkeypatch.setattr(mod, "_host_map_chunk", chunk)
        monkeypatch.setattr(mod, "time", fake_time())
        out = mod.run_steal_batch(rt, frags)
        assert out == [[f"r{i}"] for i in range(len(frags))]
        states.append((st.host_per_read, st.host_best, st.host_best_t))
    assert states[0] == states[1]
    assert states[1][0] is not None


def test_align_executor_native_crossover():
    """CudaAlignExecutor(native_max=k): the same results as native_max=0,
    the jobs of at most k bases counted native, and opt.native_skeleton as
    the JAX executor's _sync_native_skeleton leaves it."""
    from chip_smoke import _ext_jobs
    from minimap2_chaindp_tpu.models.batch_align import DeviceAlignExecutor
    from minimap2_chaindp_tpu_torch.models.batch_align import (
        NATIVE_MAX_DEFAULT, CudaAlignExecutor)
    from minimap2_chaindp_tpu_torch.options import set_opt as tset_opt
    _, opt = tset_opt("map-ont")
    jobs = _ext_jobs(np.random.default_rng(21), 24, (20, 160))
    sizes = [len(j["qseq"]) + len(j["tseq"]) for j in jobs]
    k = int(np.median(sizes))
    key = lambda g: (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe,
                     g.mqe_t, g.mte, g.mte_q, g.reach_end, list(g.cigar))
    ex0 = CudaAlignExecutor(copy.copy(opt), device="cpu", native_max=0)
    exk = CudaAlignExecutor(copy.copy(opt), device="cpu", native_max=k)
    got0 = [key(t()) for t in ex0.run(jobs)]
    gotk = [key(t()) for t in exk.run(jobs)]
    assert got0 == gotk
    n_small = sum(s <= k for s in sizes)
    assert 0 < n_small < len(jobs)
    assert exk.n_native == n_small and exk.n_device == len(jobs) - n_small
    assert ex0.n_native == 0 and ex0.n_device == len(jobs)
    for v in (0, k, NATIVE_MAX_DEFAULT - 1, NATIVE_MAX_DEFAULT, 200000):
        for start in (True, False):
            t_opt, j_opt = copy.copy(opt), copy.copy(opt)
            t_opt.native_skeleton = j_opt.native_skeleton = start
            CudaAlignExecutor(t_opt, device="cpu", native_max=v)
            DeviceAlignExecutor(j_opt, interpret=True).native_max = v
            assert t_opt.native_skeleton == j_opt.native_skeleton, (v, start)


@pytest.mark.parametrize("env", [{"MM2TPU_FLOW_SHARE": "0.5"},
                                 {"MM2TPU_STEAL": "1"}],
                         ids=["share", "steal"])
def test_cli_routing_env(lanes, env, tmp_path):
    reads = str(tmp_path / "r.fa")
    with open(reads, "w") as f:
        for fr in lanes["frags"][:N_ROUTE]:
            f.write(f">{fr.segs[0].name}\n{fr.segs[0].seq}\n")

    def cli(device, extra):
        out = subprocess.run(
            [sys.executable, "-m", "minimap2_chaindp_tpu_torch.cli", "-a",
             "-x", "map-ont", "-t", "3", "--device", device, lanes["ref"],
             reads], capture_output=True, text=True, cwd=ROOT,
            env=dict(os.environ, OMP_NUM_THREADS="1", **extra))
        assert out.returncode == 0, out.stderr
        return ([ln for ln in out.stdout.split("\n")
                 if not ln.startswith("@PG")], out.stderr)
    port, err = cli("cpu", env)
    host, _ = cli("host", {})
    assert port == host and len(port) > N_ROUTE
    timers = [ln for ln in err.split("\n") if ln.startswith("[timers]")]
    routing = "share" if "MM2TPU_FLOW_SHARE" in env else "steal"
    assert timers and f"routing={routing}" in timers[-1]


@pytest.mark.parametrize("env, kw", [
    ({"MM2TPU_FLOW_SHARE": "1.5"}, None),
    ({"MM2TPU_FLOW_SHARE": "0"}, None),
    ({}, dict(routing="sideways")),
    ({}, dict(routing="share")),
], ids=["share-1.5", "share-0", "unknown-routing", "share-without-fraction"])
def test_routing_rejects_bad_settings(lanes, env, kw):
    """Out-of-range settings from the environment or the caller raise."""
    with pytest.raises(ValueError):
        kw = runtime_kwargs(env) if kw is None else kw
        TorchRuntime(lanes["mi"], lanes["mo"], device="cpu", **kw)
