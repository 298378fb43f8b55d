"""CudaAlignExecutor on the CPU (the plain ksw2 versions) against the JAX
package's DeviceAlignExecutor(opt, use_device=False) (native host batches)
through the shared run_scheduler: identical Ez results wave by wave and
identical regions, on the splice fixture and on synthetic paired-end
reads. A failing kernel launch raises."""
import copy

import pytest
import torch

from minimap2_chaindp_tpu.models.batch_align import DeviceAlignExecutor
from minimap2_chaindp_tpu.models.pipeline import (finish_unit_gen,
                                                  format_frag, host_chain,
                                                  prepare_frag, seed_unit)
from minimap2_chaindp_tpu_torch.models.batch_align import (CudaAlignExecutor,
                                                           run_scheduler)
from minimap2_chaindp_tpu_torch.ops import _build
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from test_torch_ksw2 import ez_key
from test_torch_staged import (SPLICE_READS, SPLICE_REF, load,  # noqa: F401
                               pe_inputs)

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)


class Recording:
    """Wraps an executor and keeps every wave's Ez results."""

    def __init__(self, inner):
        self.inner, self.waves = inner, []

    def run(self, jobs):
        thunks = self.inner.run(jobs)
        self.waves.append([ez_key(t()) for t in thunks])
        return thunks


def drive(mi, mo, frags, executor):
    """The staged align stage of every fragment through run_scheduler;
    returns the output lines."""
    opt = copy.copy(mo)
    opt.native_skeleton = False   # the Python skeleton yields the waves
    metas, units = [], []
    for f in frags:
        work, flipped, us = prepare_frag(mo, f.segs)
        metas.append((f.segs, work, flipped, len(units), len(us)))
        units.extend((u, seed_unit(mi, mo, u)) for u in us)
    gens = [finish_unit_gen(mi, opt, info, host_chain(mo, info, len(u)))
            for u, info in units]
    regs = run_scheduler(gens, executor)
    return [format_frag(mi, mo, segs, work, flipped,
                        [r for rr in regs[s:s + n] for r in rr])
            for segs, work, flipped, s, n in metas]


@pytest.fixture(scope="module")
def splice_case():
    return load("splice", SPLICE_REF, [SPLICE_READS])


@pytest.fixture(scope="module")
def pe_case(pe_inputs):
    ref, p1, p2 = pe_inputs
    mi, mo, frags = load("sr", ref, [p1, p2], frag_mode=True)
    return mi, mo, frags[:12]


@pytest.mark.parametrize("case", ["splice_case", "pe_case"])
def test_executor_matches_host_executor(case, request):
    mi, mo, frags = request.getfixturevalue(case)
    host = Recording(DeviceAlignExecutor(mo, use_device=False))
    want = drive(mi, mo, frags, host)
    cuda = CudaAlignExecutor(mo, device="cpu")
    port = Recording(cuda)
    got = drive(mi, mo, frags, port)
    assert port.waves == host.waves
    assert got == want
    assert cuda.n_device > 0
    assert cuda.n_device + cuda.n_native + cuda.n_host == \
        sum(len(w) for w in port.waves)


def test_failed_launch_raises(splice_case, monkeypatch):
    """A non-zero return from the C entry point raises RuntimeError out of
    the executor: no fallback hides the card. (The splice signal's entry,
    launched first, returns 0 here.)"""
    class FailingLib:
        @staticmethod
        def mm2tpu_ksw_splice_signal(*args):
            return 0

        @staticmethod
        def mm2tpu_ksw_forward(*args):
            return 700   # cudaErrorIllegalAddress

    monkeypatch.setattr(KE, "_kernel_device", lambda t: True)
    monkeypatch.setattr(KE, "_stream", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(_build, "load", lambda: FailingLib)
    mi, mo, frags = splice_case
    before = KE.ksw_forward.launches, KE.splice_signal.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        drive(mi, mo, frags, CudaAlignExecutor(mo, device="cpu"))
    assert KE.ksw_forward.launches == before[0]
    assert KE.splice_signal.launches == before[1] + 1


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
