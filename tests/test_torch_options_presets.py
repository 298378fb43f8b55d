"""The JAX package's presets through the port's CLI on the CPU
(`--device cpu`, the plain versions) against the JAX CLI on the host path
(`--device host`), lines equal apart from @PG: -x ava-pb on reads that
overlap each other (PAF, the staged path), -x asm5 -c on contigs of low
divergence and -x sr on single-end short reads (helpers, inputs and the
cases' options of tests/test_torch_options.py). TorchRuntime under every
preset is held against the JAX package's HostRuntime in
tests/test_torch_presets.py; here the CLI's own parsing of -x is."""
import pytest

from test_torch_options import assert_same, cases, files, make_inputs


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs(str(tmp_path_factory.mktemp("options_presets")))


# the preset cases: id -> a counter the port's run must show
COUNTER = {"preset-ava-pb": "staged_frags", "preset-asm5": "ext_device",
           "preset-sr": "device_reads"}
IDS = tuple(COUNTER)


@pytest.mark.parametrize("opts,qry", cases(COUNTER))
def test_preset_matches_jax_cli(inputs, request, opts, qry):
    _out, _err, timers = assert_same([*opts, *files(inputs, qry)])
    counter = COUNTER[request.node.callspec.id]
    assert f" {counter}=" in timers, timers
