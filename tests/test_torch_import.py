"""The port imports torch and never jax. Checked in a subprocess, because
tests/conftest.py imports jax into this process."""
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_MODULES = (
    "minimap2_chaindp_tpu_torch",
    "minimap2_chaindp_tpu_torch.cli",
    "minimap2_chaindp_tpu_torch.models.batch_align",
    "minimap2_chaindp_tpu_torch.models.device_flow",
    "minimap2_chaindp_tpu_torch.models.runtime",
    "minimap2_chaindp_tpu_torch.ops._build",
    "minimap2_chaindp_tpu_torch.ops.chain_dp",
    "minimap2_chaindp_tpu_torch.ops.chain_host",
    "minimap2_chaindp_tpu_torch.ops.chain_pack",
    "minimap2_chaindp_tpu_torch.ops.ksw2_ext",
    "minimap2_chaindp_tpu_torch.ops.ksw2_pack",
    "minimap2_chaindp_tpu_torch.ops.seeds_device",
)


def _imports_jax(modules) -> str:
    code = ("import importlib, sys\n"
            f"for m in {list(modules)!r}:\n"
            "    importlib.import_module(m)\n"
            "print('jax' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_port_modules_import_no_jax():
    import minimap2_chaindp_tpu_torch as pkg
    pkg_dir = os.path.dirname(pkg.__file__)
    found = {
        "minimap2_chaindp_tpu_torch." + os.path.relpath(
            os.path.join(d, f), pkg_dir)[:-3].replace(os.sep, ".")
        for d, _, fs in os.walk(pkg_dir) for f in fs
        if f.endswith(".py") and f != "__init__.py"}
    assert found <= set(PORT_MODULES)   # every module is listed here
    assert _imports_jax(PORT_MODULES) == "False"


def test_chip_smoke_imports_no_jax():
    assert _imports_jax(["chip_smoke"]) == "False"
