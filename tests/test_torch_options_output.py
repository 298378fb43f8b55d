"""The output and batching options of the JAX package's CLI through the
port's CLI on the CPU against the JAX CLI on the host path, lines equal
apart from @PG (helpers and inputs of tests/test_torch_options.py): PAF
with and without CIGAR, --cs, --MD, -L, -K (batch splits through
map_stream), -I (a multi-part index, each part mapped in turn) and -G
with -x splice (the staged path's exts2)."""
import pytest

from test_torch_options import assert_same, cases, files, make_inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("options_output")))


# the output options' cases: id -> (a tag, whether the output has it)
TAG = {"paf": ("cg:Z:", False), "paf-cigar": ("cg:Z:", True),
       "cs": ("cs:Z:", True), "md": ("MD:Z:", True),
       "long-cigar-L": ("\tMD:Z:", False), "tiny-K": ("cg:Z:", True)}
IDS = (*TAG, "multipart-I", "intron-G")


@pytest.mark.parametrize("opts,qry", cases(TAG))
def test_output_option_matches_jax_cli(inputs, request, opts, qry):
    out, _err, timers = assert_same([*opts, *files(inputs, qry)])
    tag, has_tag = TAG[request.node.callspec.id]
    assert (tag in out) == has_tag
    assert " device_reads=" in timers, timers


def test_multipart_index_matches_jax_cli(inputs):
    """-I 100k splits the 200 kb genome into two parts, each mapped in
    turn (no @SQ lines for a multi-part index)."""
    (opts, qry), = [p.values for p in cases(["multipart-I"])]
    out, err, _t = assert_same([*opts, *files(inputs, qry)])
    assert err.count("loaded/built the index") == 2
    assert not any(ln.startswith("@SQ") for ln in out.split("\n"))


def test_splice_intron_bound_matches_jax_cli(inputs):
    """-G 5k under -x splice: the staged path, exts2 on the ksw2 path."""
    (opts, qry), = [p.values for p in cases(["intron-G"])]
    _out, _err, timers = assert_same([*opts, *files(inputs, qry)])
    assert " ext_device=" in timers and " staged_frags=" in timers
