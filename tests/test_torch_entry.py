"""The port's entry point (minimap2_chaindp_tpu_torch/entry.py) on the CPU:
entry("cpu")'s f equals the JAX __graft_entry__.entry()'s, run with
jax.jit on the CPU (the Pallas kernel in interpret mode), on the same
synthetic batch; the batch itself equals _pack_example's. Exact: f is
int32."""
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import __graft_entry__ as G  # noqa: E402
from minimap2_chaindp_tpu_torch import entry as E  # noqa: E402

torch.set_num_threads(1)


def test_example_batch_is_the_jax_one():
    want = G._pack_example(64, 512)
    got = E.pack_example(64, 512)
    for k in ("xhi", "rpos", "qpos", "span", "sid", "stw"):
        assert np.array_equal(want[0][k], got[0][k]), k
    for a, b in zip(want[1:4], got[1:4]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert want[4] == got[4]


def test_entry_matches_jax_entry():
    import jax
    jfn, jargs = G.entry()
    want = np.asarray(jax.jit(jfn)(*jargs))
    fn, args = E.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    f = fn(*args)
    assert f.dtype == torch.int32 and tuple(f.shape) == (64, 512)
    assert np.array_equal(f.numpy(), want)
    assert (want > 0).any()
