"""The port's copy of paftools (minimap2_chaindp_tpu_torch/tools/paftools.py)
against the JAX package's: the sources are line for line the same, and
every case of tests/test_paftools.py and tests/test_paftools_deep.py
passes with the module's paftools replaced by the port's copy (each
original test function runs, parametrised by name; the original files are
not changed)."""
import difflib
import inspect
import os

import pytest

import minimap2_chaindp_tpu as JP
import minimap2_chaindp_tpu_torch as TP
import test_paftools as T1
import test_paftools_deep as T2
from minimap2_chaindp_tpu_torch.tools import paftools as port_paftools

# module -> the name under which it holds paftools
MODULES = ((T1, "pt"), (T2, "paftools"))


def _cases():
    out = []
    for mod, attr in MODULES:
        for name in sorted(n for n in dir(mod) if n.startswith("test_")):
            fn = getattr(mod, name)
            marks = [m for m in getattr(fn, "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                out.append(pytest.param(mod, attr, name, {},
                                        id=f"{mod.__name__}::{name}"))
                continue
            arg, values = marks[0].args
            out += [pytest.param(mod, attr, name, {arg: v},
                                 id=f"{mod.__name__}::{name}[{v}]")
                    for v in values]
    return out


CASES = _cases()


def test_cases_cover_the_originals():
    names = {(p.values[0].__name__, p.values[2]) for p in CASES}
    assert len({n for m, n in names if m == "test_paftools"}) == 19
    assert len({n for m, n in names if m == "test_paftools_deep"}) == 4


def test_copy_is_the_original():
    def src(pkg):
        path = os.path.join(os.path.dirname(pkg.__file__), "tools",
                            "paftools.py")
        with open(path) as fh:
            return fh.read().splitlines()
    diff = [ln for ln in difflib.unified_diff(src(JP), src(TP), lineterm="",
                                              n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert diff == []
    assert port_paftools.__name__.startswith("minimap2_chaindp_tpu_torch.")


@pytest.mark.parametrize("mod, attr, name, params", CASES)
def test_case_on_port_copy(mod, attr, name, params, monkeypatch, request):
    monkeypatch.setattr(mod, attr, port_paftools)
    fn = getattr(mod, name)
    kw = dict(params)
    for arg in inspect.signature(fn).parameters:
        if arg not in kw:
            kw[arg] = request.getfixturevalue(arg)
    fn(**kw)
