"""The index-sharded mesh on torch.distributed (parallel/mesh.py,
models/device_pipeline.py, DeviceFlow(mesh=...), TorchRuntime(mesh_shape),
the CLI's --mesh) on the CPU: gloo groups of spawned CPU ranks against the
port's single-device flow and the JAX package's shard_map steps on its
virtual CPU mesh (tests/conftest.py), with the Pallas kernel in interpret
mode. Every comparison is exact; a hung collective fails at the mesh's
timeout."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import check_mesh_bucket  # noqa: E402

from minimap2_chaindp_tpu.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu.io.fastx import read_fastx  # noqa: E402
from minimap2_chaindp_tpu.models.pipeline import seed_unit  # noqa: E402
from minimap2_chaindp_tpu.ops import seeds_device as JS  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu.utils.timers import Timers  # noqa: E402
from minimap2_chaindp_tpu_torch.models import device_pipeline as TP  # noqa: E402
from minimap2_chaindp_tpu_torch.models.device_flow import DeviceFlow  # noqa: E402
from minimap2_chaindp_tpu_torch.ops import seeds_device as TS  # noqa: E402
from minimap2_chaindp_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from minimap2_chaindp_tpu_torch.utils import genome_synth as G  # noqa: E402

torch.set_num_threads(1)

TIMEOUT_S = 120.0       # a collective that waits longer fails the test
CLI_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh")
    ref, reads = str(d / "g.fa"), str(d / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=200_000, seed=21)
    G.simulate(ref, reads, 24, 2000, 0.10, seed=23)
    io_, mo = set_opt("map-ont")
    recs = list(read_fastx(ref))
    mi = build_index([r.name for r in recs], [r.seq for r in recs],
                     io_.w, io_.k, io_.flag, io_.bucket_bits)
    mo.update(mi)
    return dict(d=d, ref=ref, reads=reads, mi=mi, mo=mo,
                recs=list(read_fastx(reads)))


@pytest.fixture(scope="module")
def mesh_of():
    """One mesh at a time (a process holds one default group): asking for
    another shape, or for None, closes the current one, which must report
    its byte totals."""
    cur = {}

    def get(shape):
        if cur.get("shape") != shape:
            if "mesh" in cur:
                assert cur.pop("mesh").close() is not None
            cur["shape"] = shape
            if shape is not None:
                cur["mesh"] = Mesh(*shape, device="cpu", timeout_s=TIMEOUT_S)
        return cur.get("mesh")
    yield get
    get(None)


def units_of(g):
    return [([r], seed_unit(g["mi"], g["mo"], [r], collect_hits=False))
            for r in g["recs"]]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_shard_index_tables_match_jax(genome, n_shards):
    mi = genome["mi"]
    got, want = TS.shard_index_tables(mi, n_shards), \
        JS.shard_index_tables(mi, n_shards)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    assert got[7][-1] == len(mi.keys)
    # a tiny index: cuts collapse, shards pad to one sentinel entry
    tiny = build_index(["t"], ["ACGTTGCAAGCTTAGCCATGGAACGTAGCTAGCA"], 10,
                       15, 0, 14)
    for g, w in zip(TS.shard_index_tables(tiny, n_shards),
                    JS.shard_index_tables(tiny, n_shards)):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.fixture(scope="module")
def flows(genome):
    """The port's single-device flow and the JAX mesh flow (4 x 2 virtual
    CPU devices, interpret mode) on the same units."""
    import jax
    from jax.sharding import Mesh as JMesh
    from minimap2_chaindp_tpu.models.device_flow import DeviceFlow as JFlow
    mi, mo = genome["mi"], genome["mo"]
    u1 = units_of(genome)
    r1 = DeviceFlow(mi, mo, device="cpu").run(u1, Timers())
    devs = np.asarray(jax.devices()[:8]).reshape(4, 2)
    uj = units_of(genome)
    rj, _cold = JFlow(mi, mo, interpret=True,
                      mesh=JMesh(devs, ("data", "index"))).run(uj, Timers())
    return (u1, r1), (uj, rj)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_sharded_flow_matches_single_and_jax_mesh(genome, flows, mesh_of,
                                                  shape):
    """Unit for unit: the same units handled, the same anchors, SeedHits
    and chain scores u as the single-device flow and the JAX mesh flow;
    the raw f/p/flag of each bucket equal the single-device launch's."""
    mi, mo = genome["mi"], genome["mo"]
    mesh = mesh_of(shape)
    flow = DeviceFlow(mi, mo, mesh=mesh)
    launched = []
    real = flow._launch

    def record(q, **kw):
        out = real(q, **kw)
        launched.append((q, kw, out))
        return out
    flow._launch = record
    u2 = units_of(genome)
    timers = Timers()
    r2 = flow.run(u2, timers)
    assert timers.counters["device_reads"] >= 0.8 * len(u2)
    for (u_ref, r_ref) in flows:
        assert set(r_ref) == set(r2)
        for k in r_ref:
            a, b = r_ref[k], r2[k]
            assert np.array_equal(a.anchors, b.anchors), f"unit {k} anchors"
            assert np.array_equal(a.u, b.u), f"unit {k} chain scores"
            sh1, sh2 = u_ref[k][1].sh, u2[k][1].sh
            assert np.array_equal(sh1.anchors, sh2.anchors)
            assert sh1.rep_len == sh2.rep_len
            assert np.array_equal(sh1.mini_pos, sh2.mini_pos)
    # each bucket's outputs against the single-device step on its reads
    single = DeviceFlow(mi, mo, device="cpu")
    rows = sum(check_mesh_bucket(mi, single, *b) for b in launched)
    assert rows == timers.counters["device_reads"] \
        + timers.counters.get("fallback", 0)


def test_sharded_collect_and_map_steps_match_jax(genome, mesh_of):
    """The sharded collect step (every output, pad slots included) and the
    dry run's sharded map step against the JAX steps, on 2 x 2 ranks."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JMesh
    from minimap2_chaindp_tpu.models import device_pipeline as JP
    from minimap2_chaindp_tpu.models.pipeline import seed_unit as jseed
    from minimap2_chaindp_tpu_torch.entry import pack_example
    mi, mo = genome["mi"], genome["mo"]
    mesh = mesh_of((2, 2))
    jmesh = JMesh(np.asarray(jax.devices()[:4]).reshape(2, 2),
                  ("data", "index"))
    # collect: real minimizers of the reads, over-occurring keys masked
    mvs = [jseed(mi, mo, [r], collect_hits=False).mv
           for r in genome["recs"][:8]]
    q = TS.key_queries(mvs, [len(r.seq) for r in genome["recs"][:8]], 512)
    tables = TS.shard_index_tables(mi, 2)[:5]
    mesh.put("csr", dict(zip(("khi", "klo", "starts", "vhi", "vlo"),
                             tables)))
    cap, max_occ = 2048, 10
    data = {k: q[k].astype(np.int32) for k in TS.KEY_QUERY}
    data["qls"] = q["qls"]
    got = mesh.step(TP.sharded_collect_step, data, table="csr",
                    max_occ=max_occ, cap=cap)
    jstep = JP.make_sharded_collect_step(jmesh, cap=cap)
    want = jstep(*(jnp.asarray(t) for t in tables),
                 *(jnp.asarray(q[k]) for k in TS.KEY_QUERY),
                 jnp.int32(max_occ), jnp.asarray(q["qls"]))
    for name, g, w in zip(("xhi", "xlo", "yhi", "ylo", "total", "cnt",
                           "over"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        assert np.array_equal(g.numpy().astype(np.int64),
                              w.astype(np.int64)), name
    assert np.asarray(want[6]).any() and (np.asarray(want[4]) > 0).all()

    # the map step on the dry run's shapes (__graft_entry__.py:80-100)
    packed, nn, w1, exc, max_n = pack_example(16, 128)
    rng = np.random.default_rng(0)
    qkeys = rng.integers(0, 1 << 30, (16, 128)).astype(np.int32)
    keys = np.sort(rng.integers(0, 1 << 30, 2048).astype(np.int32))
    qkeys[:, :64] = keys[rng.integers(0, 2048, 64)]   # some hits
    mesh.put("keys", dict(keys=keys))
    fields = ("xhi", "rpos", "qpos", "span", "sid", "stw")
    got = mesh.step(TP.sharded_map_step,
                    dict(qkeys=qkeys, **{k: packed[k] for k in fields},
                         nn=nn, w1=w1, exc=exc), table="keys", max_n=max_n,
                    max_dist=5000, bw=500, max_skip=25)
    jstep = JP.make_sharded_map_step(jmesh, max_n=max_n, max_dist=5000,
                                     bw=500, max_skip=25, interpret=True)
    want = jstep(qkeys, *(packed[k] for k in fields), nn, w1, exc, keys)
    for name, g, w in zip(("f", "p", "flag", "occ"), got, want):
        assert np.array_equal(g.numpy(), np.asarray(w)), name
    assert int(got[4][0]) == int(want[4])
    assert (got[3].numpy() > 0).any()


def test_dead_rank_raises(mesh_of):
    """A rank that dies fails the next step on rank 0; close() then
    terminates the rest and reports no totals."""
    mesh_of(None)
    mesh = Mesh(1, 2, device="cpu", timeout_s=TIMEOUT_S)
    mesh._procs[0].kill()
    mesh._procs[0].join(30)
    with pytest.raises(RuntimeError, match="exited with code"):
        mesh.step(TP.sharded_map_step, {}, table="keys", max_n=128,
                  max_dist=5000, bw=500, max_skip=25)
    assert mesh.close() is None
    assert not any(p.is_alive() for p in mesh._procs)


def _cli(args, extra_env=None):
    env = dict(os.environ, OMP_NUM_THREADS="1", **(extra_env or {}))
    return subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=ROOT, env=env,
        timeout=CLI_TIMEOUT_S)


def _sam(out):
    assert out.returncode == 0, out.stderr
    return [ln for ln in out.stdout.split("\n") if not ln.startswith("@PG")]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """300 bp map-ont reads and 2 x 150 bp sr pairs on a 2 x 150 kb
    genome: small jobs for the plain versions."""
    d = tmp_path_factory.mktemp("mesh_cli")
    ref, reads = str(d / "g.fa"), str(d / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=150_000, seed=71)
    G.simulate(ref, reads, 16, 300, 0.03, seed=73)
    g = next(iter(read_fastx(ref))).seq
    comp = str.maketrans("ACGT", "TGCA")
    rng = np.random.default_rng(5)
    r1, r2 = str(d / "p1.fa"), str(d / "p2.fa")
    with open(r1, "w") as f1, open(r2, "w") as f2:
        for i in range(6):
            st = int(rng.integers(0, len(g) - 400))
            frag = g[st:st + int(rng.integers(300, 400))]
            f1.write(f">p{i}\n{frag[:150]}\n")
            f2.write(f">p{i}\n{frag[-150:][::-1].translate(comp)}\n")
    return dict(ref=ref, reads=reads, r1=r1, r2=r2)


@pytest.mark.parametrize("preset", ["map-ont", "sr"])
def test_cli_mesh_2x2_matches_host(small, preset):
    q = [small["reads"]] if preset == "map-ont" else [small["r1"],
                                                      small["r2"]]
    args = ["-a", "-x", preset, "-t", "2", small["ref"], *q]
    got = _cli(["--device", "cpu", "--mesh", "2x2", *args])
    want = _sam(_cli(["--device", "host", *args]))
    assert _sam(got) == want and len(want) > 6
    timers = [ln for ln in got.stderr.split("\n")
              if ln.startswith("[timers]")][-1]
    assert "mesh=2x2" in timers and "routing=device" in timers
    if preset == "map-ont":      # the flow ran on the mesh
        assert "device_reads=" in timers and "mesh_bytes=" in timers


def test_cli_mesh_needs_devices(small):
    """--device cuda --mesh 2x1 on a machine with fewer than two cards
    exits non-zero with the "needs N devices" line."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two cards")
    out = _cli(["-a", "--device", "cuda", "--mesh", "2x1", small["ref"],
                small["reads"]])
    assert out.returncode != 0 and out.stdout == ""
    assert "[ERROR] --mesh of 2 ranks needs 2 devices; found" in out.stderr


@pytest.mark.parametrize("bad, why", [("1x3", "power of two"),
                                      ("2by2", "expects DATAxINDEX")])
def test_cli_mesh_rejects_bad_shapes(small, bad, why):
    out = _cli(["-a", "--device", "cpu", "--mesh", bad, small["ref"],
                small["reads"]])
    assert out.returncode != 0 and why in out.stderr
    assert "Traceback" not in out.stderr


def test_dryrun_multichip_cpu():
    """The port's dry run on 2 CPU ranks (1 x 2): the sharded map and
    collect steps and an end-to-end map byte-identical to HostRuntime."""
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.entry", "dryrun",
         "2", "cpu"], capture_output=True, text=True, cwd=ROOT,
        env=dict(os.environ, OMP_NUM_THREADS="1"), timeout=CLI_TIMEOUT_S)
    assert out.returncode == 0, out.stderr
    assert "dryrun_multichip OK: mesh=1x2 (gloo, cpu)" in out.stdout
    assert "e2e byte-identical" in out.stdout
