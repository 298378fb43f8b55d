"""The four input edges of tests/test_input_edges.py on synthetic input
(that file reads a reference tree or runs the JAX CLI alone): a lowercase
(soft-masked) query maps like its uppercase copy apart from SEQ's case;
IUPAC codes map like N apart from SEQ and the MD/cs tags; a read with more
output lines than the native text buffers' first 258 (-N 300 -p 0.1 on a
tandem repeat, small enough that the fused flow's chain kernel takes it and
its native finish grows the buffers); -x splice --MD, whose MD spans sum to
the CIGAR's M total. Each case runs the port's CLI (--device cpu) against
the JAX CLI (--device host) here, and TorchRuntime on its plain versions
against the JAX HostRuntime in tests/test_torch_edges_runtime.py. The cases
are chip_smoke.OPTION_CASES entries, which smoke phase 10 runs on the card;
the inputs are chip_smoke.edge_queries'."""
import re

import pytest
import torch

from test_torch_options import assert_same, cases, files, make_inputs

torch.set_num_threads(1)

IDS = ("lowercase-query", "iupac-query", "many-lines-N300", "splice-MD")
LINE_SLOTS = 258            # the native text buffers' first line slots


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("edges")))


def records(lines):
    return [ln for ln in lines if ln and ln[0] != "@"]


def md_covers_m(line):
    """The MD tag's runs and substituted bases cover exactly the CIGAR's
    M columns (tests/test_input_edges.py:140-148)."""
    f = line.split("\t")
    md = next(x[5:] for x in f[11:] if x.startswith("MD:Z:"))
    m_total = sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSH])", f[5])
                  if op == "M")
    md_total = sum(int(n) for n in re.findall(r"\d+", md)) \
        + len(re.findall(r"(?<!\^)[A-Z]", md.replace("^", "^ "))) \
        - sum(len(d) for d in re.findall(r"\^([A-Z]+)", md))
    return md_total == m_total


def strip_iupac(line):
    t = line.split("\t")
    return [x for x in t[:9] + t[10:] if not x.startswith(("MD:Z", "cs:Z"))]


@pytest.mark.parametrize("opts,qry", cases(IDS))
def test_edge_case_matches_jax_cli(inputs, request, opts, qry):
    out, _err, timers = assert_same([*opts, *files(inputs, qry)])
    recs = records(out.split("\n"))
    name = request.node.callspec.id
    if name == "many-lines-N300":
        assert len(recs) > LINE_SLOTS
        assert " device_reads=1" in timers and " native_finish=1" in timers
    elif name == "splice-MD":
        assert " staged_frags=" in timers
        assert any("N" in ln.split("\t")[5] for ln in recs)
        assert all(md_covers_m(ln) for ln in recs if "MD:Z:" in ln)
    elif name == "lowercase-query":
        assert any(ln.split("\t")[9].islower() for ln in recs)
        assert " native_finish=" in timers
    else:
        assert any(set(ln.split("\t")[9]) & set("RYSWKMBDHV")
                   for ln in recs)
