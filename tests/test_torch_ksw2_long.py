"""Extension jobs past 16384 bases. The executor's domain rule
(models/batch_align.py): with the batch calls stubbed, jobs with a side
past 16384 bases go to the ksw2 kernels when their backtrack bytes fit
one launch's P_BUDGET and to the native host batch when they do not,
waves of fewer than MIN_DEV_JOBS such jobs stay native, and the counters
ext_device, ext_long_device and ext_native count each job once. The
plain ksw2 versions on a spliced job whose target passes 16384 bases
against the native SSE build and the JAX package's numpy model, at
tolerance zero. A wave whose offsets pass int32 is refused."""
import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.ops.ksw2_splice import exts2
from minimap2_chaindp_tpu_torch import native
from minimap2_chaindp_tpu_torch.models import batch_align as BA
from minimap2_chaindp_tpu_torch.ops import ksw2 as K
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK
from minimap2_chaindp_tpu_torch.options import set_opt
from minimap2_chaindp_tpu_torch.utils.timers import Timers
from test_torch_ksw2 import SPLICE, ez_key

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)


def _job(ql, tl, splice, seed=0):
    rng = np.random.default_rng(seed + ql + tl)
    return dict(qseq=rng.integers(0, 4, ql).astype(np.uint8),
                tseq=rng.integers(0, 4, tl).astype(np.uint8),
                w=-1 if splice else 500, zdrop=400, end_bonus=-1,
                flag=K.KSW_EZ_SPLICE_FOR if splice else 0)


class _Calls:
    """Stands in for the kernels' batch call and the native batch call,
    recording the (qlen, tlen) of every job each is handed."""

    def __init__(self):
        self.device, self.native = [], []

    def _record(self, into, jobs):
        into.extend((len(j["qseq"]), len(j["tseq"])) for j in jobs)
        return [K.Ez() for _ in jobs]

    def kernels(self, jobs, *args, **kw):
        return self._record(self.device, jobs)

    def host(self, jobs, *args):
        return self._record(self.native, jobs)


@pytest.fixture
def stubbed(monkeypatch):
    calls = _Calls()
    for name in ("exts2_batch", "extd2_batch"):
        monkeypatch.setattr(KE, name, calls.kernels)
    for name in ("exts2_batch_native", "extd2_batch_native"):
        monkeypatch.setattr(native, name, calls.host)
    return calls, monkeypatch


SHORT = [(300, 2000), (150, 900), (420, 5000), (128, 16384)]
# a side past 16384: the spliced fills of the cdna cell (query 128-422,
# targets 16.7 k to 155 k bases), and one whose query passes 16384
LONG = [(300, 16385), (250, 32769), (400, 155_000), (17_000, 17_000)]
# backtrack bytes past the 2 GiB budget unbanded; banded (extd2, w 500)
# the same shape fits it
HUGE = (20_000, 100_000)


@pytest.mark.parametrize("splice", [True, False], ids=["exts2", "extd2"])
def test_long_jobs_routed_by_their_backtrack_bytes(stubbed, splice):
    calls, monkeypatch = stubbed
    _io, opt = set_opt("splice" if splice else "map-ont")
    timers = Timers()
    ex = BA.CudaAlignExecutor(opt, device="cpu", timers=timers)
    shapes = SHORT + LONG + [HUGE]
    jobs = [_job(ql, tl, splice) for ql, tl in shapes]
    p_bytes = KPK._p_sizes(*KPK._job_fields(jobs, splice), splice)[1]
    assert (p_bytes[-1] > KE.P_BUDGET) == splice
    thunks = ex.run(jobs)
    assert all(t() is not None for t in thunks)
    on_card = SHORT + LONG + ([] if splice else [HUGE])
    assert calls.device == on_card
    assert calls.native == ([HUGE] if splice else [])
    n_long = len(LONG) + (0 if splice else 1)
    assert (ex.n_device, ex.n_long_device, ex.n_native, ex.n_host) == \
        (len(on_card), n_long, len(shapes) - len(on_card), 0)
    # a budget between the short jobs' bytes and the long ones' sends the
    # long ones to the host, the short ones still to the card
    calls.device.clear()
    calls.native.clear()
    monkeypatch.setattr(KE, "P_BUDGET", int(p_bytes[:len(SHORT)].max()))
    ex.run(jobs)
    assert calls.device == SHORT
    assert calls.native == LONG + [HUGE]
    # a wave of fewer than MIN_DEV_JOBS jobs the card would take stays on
    # the host, long or not
    monkeypatch.setattr(KE, "P_BUDGET", 2 << 30)
    calls.device.clear()
    calls.native.clear()
    small = LONG[:BA.MIN_DEV_JOBS - 1]
    ex.run([_job(ql, tl, splice) for ql, tl in small])
    assert calls.device == [] and calls.native == small
    c = timers.counters
    assert c["ext_device"] == ex.n_device == len(on_card) + len(SHORT)
    assert c["ext_long_device"] == ex.n_long_device == n_long
    assert c["ext_native"] == ex.n_native == \
        len(shapes) - len(on_card) + len(LONG) + 1 + len(small)
    assert "ext_host" not in c


def test_budget_split_puts_the_long_jobs_together():
    """A wave over the backtrack budget is cut longest first: a budget of
    the two longest jobs' bytes gives them the first launch together,
    wherever they stand in the wave, and the rest the next."""
    shapes = SHORT[:2] + LONG + SHORT[2:]
    jobs = [_job(ql, tl, True) for ql, tl in shapes]
    sizes = KPK._p_sizes(*KPK._job_fields(jobs, True), True)[1]
    rows = [ql + tl for ql, tl in shapes]
    top = sorted(range(len(jobs)), key=lambda i: -rows[i])
    budget = int(sizes[top[0]] + sizes[top[1]])
    assert budget < sizes.sum() - max(sizes[top[2:]])
    groups = KPK.split_by_budget(jobs, True, budget)
    assert groups[0] == top[:2] == [4, 5]
    assert sorted(i for g in groups for i in g) == list(range(len(jobs)))


def test_disabled_scoring_routes_nothing_to_the_card(stubbed):
    """Outside the kernels' scoring domain no job goes to the card,
    however short."""
    calls, _ = stubbed
    _io, opt = set_opt("map-ont")
    opt.q2, opt.e2 = opt.q, opt.e          # single-affine: no kernel mode
    ex = BA.CudaAlignExecutor(opt, device="cpu")
    assert not ex.enabled
    ex.run([_job(ql, tl, False) for ql, tl in SHORT + LONG])
    assert calls.device == [] and ex.n_long_device == 0


def _spliced_long_job(seed, tlen, flag):
    """A query of two exons and the target that holds them around one
    intron, GT..AG on the forward strand (CT..AC on the reverse), so
    that the target has `tlen` bases; the query carries a substitution,
    a deletion and an insertion."""
    rng = np.random.default_rng(seed)
    ex1 = rng.integers(0, 4, 120).astype(np.uint8)
    ex2 = rng.integers(0, 4, 130).astype(np.uint8)
    intron = rng.integers(0, 4, tlen - 250).astype(np.uint8)
    rev = flag & K.KSW_EZ_SPLICE_REV
    intron[:2] = (1, 3) if rev else (2, 3)      # CT or GT
    intron[-2:] = (0, 1) if rev else (0, 2)     # AC or AG
    t = np.concatenate([ex1, intron, ex2]).astype(np.uint8)
    q = np.concatenate([ex1, ex2]).astype(np.uint8)
    q[10] = (q[10] + 1) % 4
    q = np.insert(np.delete(q, 50), 200, 3).astype(np.uint8)
    return dict(qseq=q, tseq=t, zdrop=200, end_bonus=-1, flag=flag, w=-1)


def test_plain_exts2_past_16384_matches_native_and_numpy():
    """One spliced job on the reverse strand with a 16390-base target
    (16639 rows: the longest the CPU affords) through the plain
    versions, against the native SSE build and the numpy model: every Ez
    field and the CIGAR, with its 16 kb intron."""
    q, e, q2, noncan, a, b = SPLICE
    job = _spliced_long_job(7, 16390, K.KSW_EZ_SPLICE_REV)
    assert len(job["tseq"]) > BA.LONG_SIDE
    mat = K.gen_simple_mat(5, a, b)
    got = KE.exts2_batch([job], mat, q, e, q2, noncan, device="cpu")[0]
    want = exts2(job["qseq"], job["tseq"], mat, q, e, q2, noncan,
                 job["zdrop"], job["flag"])
    assert ez_key(got) == ez_key(want)
    nat = native.exts2_batch_native([job], mat, q, e, q2, noncan)
    assert nat is not None, "the native host library did not load"
    assert ez_key(got) == ez_key(nat[0])
    ops = [(c >> 4, "MIDN"[c & 0xF]) for c in got.cigar]
    assert (16390 - 250, "N") in ops


def test_pack_refuses_offsets_past_int32():
    """Two jobs of 2^30-base targets (zero-stride stand-ins: no memory)
    overflow meta's int32 target offsets: the pack raises instead."""
    big = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8),
                                          shape=(1 << 30,), strides=(0,))
    jobs = [dict(qseq=np.zeros(4, np.uint8), tseq=big, zdrop=-1,
                 end_bonus=-1, flag=K.KSW_EZ_SCORE_ONLY, w=-1)] * 2
    with pytest.raises(ValueError, match="int32"):
        KPK.pack_jobs(jobs, splice=True)
