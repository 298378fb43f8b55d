"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark import run as R

BENCH = os.path.join(R.ROOT, "benchmark")
REF = os.path.join(BENCH, "reference")


def modules(root):
    for d, _dirs, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported(path):
    """Top-level names of every absolute import in a file."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(modules(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_forbidden_import(path):
    bad = set(imported(path)) & set(R.FORBIDDEN)
    assert not bad, f"{path} imports {bad}"
    if path.startswith(REF + os.sep):
        assert not set(imported(path)) & {"minimap2_chaindp_tpu_torch",
                                           "torch", "benchmark"}, path


def test_the_whole_name_is_compared():
    import minimap2_chaindp_tpu_torch  # noqa: F401  (the port, loaded)
    assert "minimap2_chaindp_tpu_torch" in sys.modules
    assert "minimap2_chaindp_tpu_torch" not in R.forbidden_modules()


def test_sys_modules_after_a_cpu_run():
    """A tiny cell run end to end on the CPU, the reference included, in a
    process of its own: no forbidden module is loaded after the window."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from benchmark import run as R\n"
        "from benchmark.tests import tiny\n"
        "res = R.run_cell(tiny.cell(), tiny.CONFIGS['ont'], tiny.MIXES['ont'],"
        " 3, 0.5, True, device='cpu')\n"
        "print(json.dumps([res['correct'], R.forbidden_modules()]))\n"
        % R.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=R.ROOT, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    correct, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct and bad == []


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "sr-pairs-150",
         "--seed", "1", "--seconds", "10", "--trace", "0"],
        capture_output=True, text=True, cwd=R.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
