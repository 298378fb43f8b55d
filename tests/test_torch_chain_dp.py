"""The port's chaining-DP score pass (plain PyTorch version, CPU) against
the Pallas kernel in interpret mode: f, p and flag[:, 0] must be equal
(exact integers, tolerance zero). Unflagged reads, after the host bottom
half, must also equal ops/chain.py:chain_dp. The CUDA kernel is held
against the same plain version on the card in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.ops import chain_pallas as CP
from minimap2_chaindp_tpu.ops.chain import chain_backtrack, chain_dp
from minimap2_chaindp_tpu.options import set_opt
from minimap2_chaindp_tpu.utils.synth import synth_batch
from minimap2_chaindp_tpu_torch.ops import chain_dp as TD
from minimap2_chaindp_tpu_torch.ops.chain_host import (_v_from_fp,
                                                       compact_from_fpv,
                                                       split_anchors)
from minimap2_chaindp_tpu_torch.ops.chain_pack import pack_reads

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

FIELDS = ("xhi", "rpos", "qpos", "span", "sid", "stw")


def synth_anchors(rng, n, seg_split=None, big_gaps=False):
    """tests/test_chain_pallas.py:110-120."""
    rp = np.sort(rng.integers(0, 60000 if big_gaps else 3000, n))
    qp = np.maximum(rp // (30 if big_gaps else 1)
                    + rng.integers(-200, 200, n), 0)
    span = rng.integers(13, 20, n)
    y = span.astype(np.uint64) << np.uint64(32) | qp.astype(np.uint64)
    if seg_split is not None:
        seg = (np.arange(n) >= seg_split).astype(np.uint64)
        y |= seg << np.uint64(48)
    anchors = np.stack([rp.astype(np.uint64), y], axis=1)
    return anchors[np.argsort(anchors[:, 0], kind="stable")]


def noisy_anchors(rng, n, noise, read_len=3000):
    """A diagonal chain buried in dense off-diagonal noise: many valid
    non-improving candidates sit above the best predecessor, so a small
    max_skip flags reads."""
    n_noise = int(n * noise)
    qp_d = np.sort(rng.choice(read_len, n - n_noise, replace=False))
    jitter = 30 if noise else 1   # a clean read is an exact diagonal
    rp_d = qp_d + rng.integers(-jitter + 1, jitter, n - n_noise) + 100
    qp_n = rng.integers(0, read_len, n_noise)
    rp_n = rng.integers(0, read_len + 200, n_noise)
    rp = np.maximum(np.concatenate([rp_d, rp_n]), 0)
    qp = np.concatenate([qp_d, qp_n])
    y = (np.uint64(15) << np.uint64(32)) | qp.astype(np.uint64)
    a = np.stack([rp.astype(np.uint64), y], axis=1)
    return a[np.argsort(a[:, 0], kind="stable")]


def corpus(case):
    """(anchor list, kwargs, n_segs) for one case."""
    _, mo = set_opt(None)
    if case == "many_segs":
        _, mo = set_opt("sr")
        rng = np.random.default_rng(4)
        batch = []
        for _ in range(6):
            n = int(rng.integers(30, 200))
            batch.append(synth_anchors(rng, n, seg_split=n // 2))
        return batch, dict(max_dist_x=800, max_dist_y=600, bw=mo.bw,
                           max_skip=mo.max_chain_skip, is_cdna=False,
                           many_segs=True), mo, 2
    if case == "is_cdna":
        _, mo = set_opt("splice")
        rng = np.random.default_rng(3)
        batch = [synth_anchors(rng, int(rng.integers(30, 250)),
                               big_gaps=True) for _ in range(6)]
        return batch, dict(max_dist_x=200000, max_dist_y=2000, bw=mo.bw,
                           max_skip=mo.max_chain_skip, is_cdna=True,
                           many_segs=False), mo, 1
    if case == "flagged":
        rng = np.random.default_rng(11)
        batch = [noisy_anchors(rng, int(rng.integers(150, 400)),
                               noise=0.5 if r % 2 else 0.0)
                 for r in range(8)]
        return batch, dict(max_dist_x=mo.max_gap, max_dist_y=mo.max_gap,
                           bw=mo.bw, max_skip=2, is_cdna=False,
                           many_segs=False), mo, 1
    # single-seg: the benchmark's long-read shape plus random windows
    rng = np.random.default_rng(1)
    batch = synth_batch(8, 900, seed=7)
    batch += [synth_anchors(rng, int(rng.integers(20, 1000)))
              for _ in range(8)]
    return batch, dict(max_dist_x=mo.max_gap, max_dist_y=mo.max_gap,
                       bw=mo.bw, max_skip=mo.max_chain_skip, is_cdna=False,
                       many_segs=False), mo, 1


def pack(batch, max_dist_x):
    reads = []
    for a in batch:
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(max(len(a), 1))))
    max_n = (max(len(a) for a in batch) + 127) // 128 * 128
    packed, nn, w1, exc, host_flag = pack_reads(reads, max_n, max_dist_x)
    assert not host_flag.any()
    return packed, nn, w1, exc, max_n


CASES = [
    ("single", False, None),
    ("single", False, 20000),
    ("single", True, None),
    ("single", True, 20000),
    ("many_segs", None, None),
    ("is_cdna", None, None),
    ("flagged", None, None),
]


@pytest.mark.parametrize("case,use_exc,score_bound", CASES,
                         ids=["single", "single-bound", "single-exc",
                              "single-exc-bound", "many_segs", "is_cdna",
                              "flagged"])
def test_chain_ref_matches_pallas(case, use_exc, score_bound):
    batch, kw, mo, n_segs = corpus(case)
    packed, nn, w1, exc, max_n = pack(batch, kw["max_dist_x"])
    patched = bool(use_exc)
    if patched:
        # exception patches that DIFFER from the slope value, on gaps that
        # occur, so both sides must apply the (dd, value) table
        for r in range(0, len(batch), 2):
            exc[r, 0:4] = (3, 7, 11, 0)
    ins = [packed[k] for k in FIELDS]
    jf, jp, jflag = (np.asarray(v) for v in CP.chain_scores_batch(
        *ins, nn, w1, exc, max_n=max_n, interpret=True, use_exc=use_exc,
        score_bound=score_bound, **kw))
    tf, tp, tflag = (v.numpy() for v in TD.chain_scores_batch(
        *(torch.from_numpy(a) for a in ins + [nn, w1, exc]), max_n=max_n,
        use_exc=use_exc, score_bound=score_bound, **kw))
    assert tf.shape == jf.shape == (len(nn), max_n)
    assert tflag.shape == (len(nn), 128)
    assert np.array_equal(tf, jf)
    assert np.array_equal(tp, jp)
    assert np.array_equal(tflag[:, 0], jflag[:, 0])
    n_flagged = int(tflag[:len(batch), 0].sum())
    if case == "flagged":
        assert n_flagged >= 1
    if patched:
        return   # the injected patches change scores on purpose
    n_checked = 0
    for r, a in enumerate(batch):
        if tflag[r, 0]:
            continue
        n = len(a)
        host = chain_dp(kw["max_dist_x"], kw["max_dist_y"], kw["bw"],
                        kw["max_skip"], mo.min_cnt, mo.min_chain_score,
                        kw["is_cdna"], n_segs, a)
        cx, cy, cf, cp = compact_from_fpv(a, tf[r, :n], tp[r, :n],
                                          _v_from_fp(tf[r, :n], tp[r, :n]),
                                          mo.min_chain_score)
        dev = chain_backtrack(cx, cy, cf, cp, mo.min_cnt, mo.min_chain_score)
        assert np.array_equal(host.u, dev.u), f"read {r} u"
        assert np.array_equal(host.anchors, dev.anchors), f"read {r} anchors"
        n_checked += 1
    assert n_checked >= 1


def test_chain_wrapper_rejects_bad_inputs():
    batch, kw, _, _ = corpus("many_segs")
    packed, nn, w1, exc, max_n = pack(batch, kw["max_dist_x"])
    ts = [torch.from_numpy(packed[k]) for k in FIELDS] + [
        torch.from_numpy(a) for a in (nn, w1, exc)]
    with pytest.raises(TypeError):      # w1 must be float32
        TD.chain_scores_batch(*ts[:7], ts[7].double(), ts[8], max_n=max_n,
                              **kw)
    with pytest.raises(ValueError):     # sid must be (R, max_n)
        TD.chain_scores_batch(*ts[:4], ts[4][:, :128].contiguous(),
                              *ts[5:], max_n=max_n, **kw)
    with pytest.raises(ValueError):     # gap-cost domain beyond the table
        TD.chain_scores_batch(*ts, max_n=max_n, **{**kw, "bw": 4096})
    before = TD.chain_scores_batch.launches
    TD.chain_scores_batch(*ts, max_n=max_n, **kw)
    assert TD.chain_scores_batch.launches == before   # CPU: no launch
