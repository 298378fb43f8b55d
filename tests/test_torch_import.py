"""The port imports torch, never jax and nothing of the JAX package
(minimap2_chaindp_tpu), not even a module there that does not import jax.
Checked in a subprocess, because tests/conftest.py imports jax into this
process, in the ranks a mesh spawns, and by a scan of the sources' import
lines."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

PORT_MODULES = (
    "minimap2_chaindp_tpu_torch",
    "minimap2_chaindp_tpu_torch.align",
    "minimap2_chaindp_tpu_torch.bench",
    "minimap2_chaindp_tpu_torch.cli",
    "minimap2_chaindp_tpu_torch.constants",
    "minimap2_chaindp_tpu_torch.entry",
    "minimap2_chaindp_tpu_torch.esterr",
    "minimap2_chaindp_tpu_torch.hits",
    "minimap2_chaindp_tpu_torch.index.build",
    "minimap2_chaindp_tpu_torch.index.build_device",
    "minimap2_chaindp_tpu_torch.index.serialize",
    "minimap2_chaindp_tpu_torch.index.sketch",
    "minimap2_chaindp_tpu_torch.io.fastx",
    "minimap2_chaindp_tpu_torch.io.native_fastx",
    "minimap2_chaindp_tpu_torch.io.output",
    "minimap2_chaindp_tpu_torch.mappy",
    "minimap2_chaindp_tpu_torch.models.batch_align",
    "minimap2_chaindp_tpu_torch.models.device_flow",
    "minimap2_chaindp_tpu_torch.models.device_pipeline",
    "minimap2_chaindp_tpu_torch.models.host_runtime",
    "minimap2_chaindp_tpu_torch.models.pipeline",
    "minimap2_chaindp_tpu_torch.models.runtime",
    "minimap2_chaindp_tpu_torch.models.steal",
    "minimap2_chaindp_tpu_torch.native",
    "minimap2_chaindp_tpu_torch.ops._build",
    "minimap2_chaindp_tpu_torch.ops.chain",
    "minimap2_chaindp_tpu_torch.ops.chain_dp",
    "minimap2_chaindp_tpu_torch.ops.chain_host",
    "minimap2_chaindp_tpu_torch.ops.chain_pack",
    "minimap2_chaindp_tpu_torch.ops.ksw2",
    "minimap2_chaindp_tpu_torch.ops.ksw2_backtrack",
    "minimap2_chaindp_tpu_torch.ops.ksw2_ext",
    "minimap2_chaindp_tpu_torch.ops.ksw2_pack",
    "minimap2_chaindp_tpu_torch.ops.ksw2_splice",
    "minimap2_chaindp_tpu_torch.ops.seeds",
    "minimap2_chaindp_tpu_torch.ops.seeds_device",
    "minimap2_chaindp_tpu_torch.options",
    "minimap2_chaindp_tpu_torch.parallel.mesh",
    "minimap2_chaindp_tpu_torch.pe",
    "minimap2_chaindp_tpu_torch.sdust",
    "minimap2_chaindp_tpu_torch.tools.e2e_bench",
    "minimap2_chaindp_tpu_torch.tools.flow_projection",
    "minimap2_chaindp_tpu_torch.tools.genome_scale",
    "minimap2_chaindp_tpu_torch.tools.paftools",
    "minimap2_chaindp_tpu_torch.utils.chain_corpus",
    "minimap2_chaindp_tpu_torch.utils.chain_sweep",
    "minimap2_chaindp_tpu_torch.utils.genome_synth",
    "minimap2_chaindp_tpu_torch.utils.kernel_inputs",
    "minimap2_chaindp_tpu_torch.utils.ksw_sweep",
    "minimap2_chaindp_tpu_torch.utils.mesh_sweep",
    "minimap2_chaindp_tpu_torch.utils.mlog",
    "minimap2_chaindp_tpu_torch.utils.prefetch",
    "minimap2_chaindp_tpu_torch.utils.route_sweep",
    "minimap2_chaindp_tpu_torch.utils.synth",
    "minimap2_chaindp_tpu_torch.utils.timers",
)

# printed by the subprocess: the modules it must not have loaded
FOREIGN = ("print(sorted(m for m in sys.modules if m == 'jax' "
           "or m == 'minimap2_chaindp_tpu' "
           "or m.startswith('minimap2_chaindp_tpu.')))\n")


def _foreign_modules(code: str) -> str:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code + FOREIGN], cwd=ROOT,
                         capture_output=True, text=True, env=env)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()[-1]


def _import_code(modules) -> str:
    return ("import importlib, sys\n"
            f"for m in {list(modules)!r}:\n"
            "    importlib.import_module(m)\n")


def _port_sources():
    import minimap2_chaindp_tpu_torch as pkg
    pkg_dir = os.path.dirname(pkg.__file__)
    return pkg_dir, [os.path.join(d, f) for d, _, fs in os.walk(pkg_dir)
                     for f in fs if f.endswith(".py")]


def test_port_modules_import_no_jax():
    pkg_dir, paths = _port_sources()
    found = {
        "minimap2_chaindp_tpu_torch." + os.path.relpath(
            p, pkg_dir)[:-3].replace(os.sep, ".")
        for p in paths if not p.endswith("__init__.py")}
    assert found <= set(PORT_MODULES)   # every module is listed here
    assert _foreign_modules(_import_code(PORT_MODULES)) == "[]"


def test_chip_smoke_imports_no_jax():
    assert _foreign_modules(_import_code(["chip_smoke"])) == "[]"


def test_cli_map_loads_nothing_foreign():
    """One small --device cpu map through the port's CLI, in the process
    that is then asked what it loaded."""
    code = ("import contextlib, io, sys\n"
            "from minimap2_chaindp_tpu_torch import cli\n"
            "buf = io.StringIO()\n"
            "with contextlib.redirect_stdout(buf):\n"
            "    rc = cli.main(['-a', '-x', 'splice', '--device', 'cpu', "
            f"{os.path.join(DATA, 'splice_genome.fa')!r}, "
            f"{os.path.join(DATA, 'splice_cdna.fa')!r}])\n"
            "assert rc == 0, rc\n"
            "assert buf.getvalue().count('\\n') > 3\n")
    assert _foreign_modules(code) == "[]"


def test_sources_import_nothing_foreign():
    """No import line of the port or of chip_smoke.py names the JAX package
    or jax."""
    bad = re.compile(r"^\s*(from|import)\s+(minimap2_chaindp_tpu(?!_torch)"
                     r"|jax)\b")
    _pkg_dir, paths = _port_sources()
    hits = []
    for path in paths + [os.path.join(ROOT, "chip_smoke.py")]:
        with open(path) as fh:
            hits += [f"{path}:{n}: {line.strip()}"
                     for n, line in enumerate(fh, 1) if bad.match(line)]
    assert not hits, "\n".join(hits)


# started in every Python process of a run (PYTHONPATH): at exit each one
# writes the foreign modules it loaded to a file of its own
_RECORDER = """import atexit, os, sys
def _record():
    bad = sorted(m for m in sys.modules if m == "jax"
                 or m == "minimap2_chaindp_tpu"
                 or m.startswith("minimap2_chaindp_tpu."))
    with open(os.path.join(os.environ["PORT_IMPORT_LOG"],
                           f"{os.getpid()}.txt"), "w") as fh:
        fh.write(repr(bad))
atexit.register(_record)
"""


def test_mesh_ranks_load_nothing_foreign(tmp_path):
    """The CLI's --mesh 1x2 on the CPU: the process and the rank it spawns
    load neither jax nor the JAX package (each records what it loaded as
    it exits)."""
    site, log = tmp_path / "site", tmp_path / "log"
    site.mkdir()
    log.mkdir()
    (site / "sitecustomize.py").write_text(_RECORDER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PORT_IMPORT_LOG=str(log),
               PYTHONPATH=os.pathsep.join(
                   [str(site), ROOT, os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run(
        [sys.executable, "-m", "minimap2_chaindp_tpu_torch.cli", "-a",
         "--device", "cpu", "--mesh", "1x2",
         os.path.join(DATA, "splice_genome.fa"),
         os.path.join(DATA, "splice_cdna.fa")],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "mesh=1x2" in out.stderr and "device_reads=" in out.stderr
    records = {p.name: p.read_text() for p in log.iterdir()}
    assert len(records) >= 2, records       # the CLI and its rank 1
    assert set(records.values()) == {"[]"}, records
