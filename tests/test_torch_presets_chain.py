"""The staged chain kernel's inputs under the presets of
tests/test_torch_presets.py that set new chain parameters (ava-ont and
ava-pb: max_dist 10000, bw 2000 under ava-pb; sr single-end: bw and
max_dist 100, the gap bound per read): every launch the port's staged
pass makes over the preset's units, through the port's plain version and
through the JAX package's Pallas kernel in interpret mode, must give the
same f, p and flag, exactly (the pattern of
tests/test_torch_staged.py:test_chain_batch_matches_jax). The asm presets
and map10k take the same check in tests/test_torch_presets_asm.py (the
interpreter's time splits the presets over two files)."""
import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.ops import chain_pallas as CPJ
from minimap2_chaindp_tpu_torch.models import runtime as RT
from test_torch_presets import load, seeded_units

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("presets_chain"))


def check_chain_inputs(workdir, preset, monkeypatch):
    """Every staged launch over the preset's units: the plain version's f,
    p and flag against the Pallas kernel's in interpret mode."""
    mi, mo, frags = load(workdir, preset)
    launches = []
    real = RT.chain_scores_batch

    def keep(*a, **kw):
        out = real(*a, **kw)
        launches.append((a, kw, out))
        return out
    monkeypatch.setattr(RT, "chain_scores_batch", keep)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    rt._chain_batch(seeded_units(mi, mo, frags))
    assert launches
    for a, kw, (tf, tp, tflag) in launches:
        assert kw["bw"] == mo.bw and kw["max_skip"] == mo.max_chain_skip
        jf, jp, jflag = (np.asarray(v) for v in CPJ.chain_scores_batch(
            *(t.numpy() for t in a), interpret=True, **kw))
        what = f"R={a[0].shape[0]} max_n={kw['max_n']}"
        assert np.array_equal(tf.numpy(), jf), f"f, {what}"
        assert np.array_equal(tp.numpy(), jp), f"p, {what}"
        assert np.array_equal(tflag[:, 0].numpy(), jflag[:, 0]), \
            f"flag, {what}"
    c = rt.timers.counters
    assert c["staged_device_reads"] + c["fallback"] == sum(
        int((a[6][:, 0] > 0).sum()) for a, _kw, _out in launches)


@pytest.mark.parametrize("preset", ["ava-ont", "ava-pb", "sr"])
def test_preset_chain_inputs_match_pallas(workdir, preset, monkeypatch):
    check_chain_inputs(workdir, preset, monkeypatch)
