"""The port imports torch, never jax and nothing of the JAX package
(minimap2_chaindp_tpu), not even a module there that does not import jax.
Checked in a subprocess, because tests/conftest.py imports jax into this
process, and by a scan of the sources' import lines."""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")

PORT_MODULES = (
    "minimap2_chaindp_tpu_torch",
    "minimap2_chaindp_tpu_torch.align",
    "minimap2_chaindp_tpu_torch.cli",
    "minimap2_chaindp_tpu_torch.constants",
    "minimap2_chaindp_tpu_torch.esterr",
    "minimap2_chaindp_tpu_torch.hits",
    "minimap2_chaindp_tpu_torch.index.build",
    "minimap2_chaindp_tpu_torch.index.serialize",
    "minimap2_chaindp_tpu_torch.index.sketch",
    "minimap2_chaindp_tpu_torch.io.fastx",
    "minimap2_chaindp_tpu_torch.io.native_fastx",
    "minimap2_chaindp_tpu_torch.io.output",
    "minimap2_chaindp_tpu_torch.models.batch_align",
    "minimap2_chaindp_tpu_torch.models.device_flow",
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
    "minimap2_chaindp_tpu_torch.pe",
    "minimap2_chaindp_tpu_torch.sdust",
    "minimap2_chaindp_tpu_torch.utils.chain_corpus",
    "minimap2_chaindp_tpu_torch.utils.chain_sweep",
    "minimap2_chaindp_tpu_torch.utils.genome_synth",
    "minimap2_chaindp_tpu_torch.utils.ksw_sweep",
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
