"""The port's ksw2 extension (CPU: the plain versions ksw_forward_ref and
ksw_walk_ref behind ops/ksw2_ext.extd2_batch / exts2_batch) against the
JAX package: the numpy models K.extd2 and ksw2_splice.exts2 on the corpora
of tests/test_ksw2_pallas.py, test_ksw2_backtrack.py and
test_ksw2_splice_pallas.py, and the Pallas kernel itself in interpret mode
on small cases. Tolerance zero: every Ez field and every CIGAR equal."""
import numpy as np
import pytest
import torch

import chip_smoke as S
import test_ksw2_pallas as TP
import test_ksw2_splice_pallas as TS
from minimap2_chaindp_tpu.ops import ksw2 as K
from minimap2_chaindp_tpu.ops.ksw2_splice import exts2, make_donor_acceptor
from minimap2_chaindp_tpu_torch.ops import ksw2_ext as KE
from minimap2_chaindp_tpu_torch.ops import ksw2_pack as KPK

# the plain versions run loops of small torch ops: an intra-op thread
# pool in every test worker only spins against the other workers
torch.set_num_threads(1)

EXTD2 = (4, 2, 24, 1, 2, 4)
SR = (12, 2, 24, 1, 2, 8)
ASM = (16, 2, 41, 1, 1, 9)
SPLICE = (2, 1, 32, 9, 1, 2)


def ez_key(g):
    return (g.score, g.max, g.zdropped, g.max_q, g.max_t, g.mqe, g.mqe_t,
            g.mte, g.mte_q, g.reach_end, list(g.cigar))


def tiny_and_divergent():
    rng = np.random.default_rng(5)
    jobs = []
    for _ in range(4):   # unrelated sequences: z-drop fires early
        t = rng.integers(0, 4, 400).astype(np.uint8)
        qv = rng.integers(0, 4, 380).astype(np.uint8)
        jobs.append(dict(qseq=qv, tseq=t, w=100, zdrop=100, end_bonus=-1,
                         flag=K.KSW_EZ_EXTZ_ONLY))
    for _ in range(4):
        t = rng.integers(0, 4, int(rng.integers(3, 10))).astype(np.uint8)
        q = TP.mut(rng, t)
        jobs.append(dict(qseq=q if len(q) else np.array([0], np.uint8),
                         tseq=t, w=25, zdrop=400, end_bonus=-1, flag=0))
    return jobs


def width1_band():
    """tests/test_ksw2_pallas.py:114-134: qlen 1, unbanded."""
    rng = np.random.default_rng(2)
    return [dict(qseq=rng.integers(0, 4, 1).astype(np.uint8),
                 tseq=rng.integers(0, 4, tlen).astype(np.uint8),
                 w=-1, zdrop=-1, end_bonus=0, flag=0) for tlen in (135, 200)]


def long_gaps():
    """tests/test_ksw2_backtrack.py:96-114: a 30I and a 30D through the
    second affine profile (88M30I62M30D20M)."""
    rng = np.random.default_rng(17)
    t = rng.integers(0, 4, 200).astype(np.uint8)
    ins = rng.integers(0, 4, 30).astype(np.uint8)
    q = np.concatenate([t[:90], ins, t[90:150], t[180:]]).astype(np.uint8)
    return [dict(qseq=q, tseq=t, w=80, zdrop=400, end_bonus=-1, flag=0)]


EXTD2_CORPORA = {
    "default": (lambda: TP.gen_jobs(0, 16), EXTD2),
    "small": (lambda: TP.gen_jobs(5, 8, tlen_rng=(10, 60)), EXTD2),
    "sr": (lambda: TP.gen_jobs(1, 8), SR),
    "asm": (lambda: TP.gen_jobs(2, 8), ASM),
    "mixed_sizes": (lambda: TP.gen_jobs(3, 4, tlen_rng=(10, 60))
                    + TP.gen_jobs(4, 4, tlen_rng=(300, 600)), EXTD2),
    "tiny_divergent": (tiny_and_divergent, EXTD2),
    "width1_band": (width1_band, EXTD2),
    "long_gaps": (long_gaps, EXTD2),
}


def splice_mixed():
    """tests/test_ksw2_splice_pallas.py:65-76."""
    jobs = TS.gen_jobs(1, 4)
    rng = np.random.default_rng(2)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    qv = rng.integers(0, 4, 280).astype(np.uint8)
    jobs.append(dict(qseq=qv, tseq=t, zdrop=100, end_bonus=-1,
                     flag=K.KSW_EZ_SPLICE_FOR, w=-1))
    jobs.append(dict(qseq=t[:9].copy(), tseq=t[:12].copy(), zdrop=200,
                     end_bonus=-1, flag=K.KSW_EZ_SPLICE_FOR, w=-1))
    return jobs


EXTS2_CORPORA = {
    "splice_scoring": lambda: TS.gen_jobs(0, 8),
    "mixed_sizes": splice_mixed,
    "backtrack_corpus": lambda: TS.gen_jobs(2, 8),
}


@pytest.mark.parametrize("corpus", sorted(EXTD2_CORPORA))
def test_plain_extd2_matches_numpy_model(corpus):
    make, (q, e, q2, e2, a, b) = EXTD2_CORPORA[corpus]
    jobs = make()
    mat = K.gen_simple_mat(5, a, b)
    got = KE.extd2_batch(jobs, mat, q, e, q2, e2, device="cpu")
    for j, (job, g) in enumerate(zip(jobs, got)):
        want = K.extd2(job["qseq"], job["tseq"], mat, q, e, q2, e2,
                       job["w"], job["zdrop"], job["end_bonus"], job["flag"])
        assert ez_key(g) == ez_key(want), (
            f"job {j} flag={job['flag']} w={job['w']} "
            f"qlen={len(job['qseq'])} tlen={len(job['tseq'])}")
    if corpus == "long_gaps":
        cig = "".join(f"{c >> 4}{'MIDN'[c & 0xF]}" for c in got[0].cigar)
        assert cig == "88M30I62M30D20M"


@pytest.mark.parametrize("corpus", sorted(EXTS2_CORPORA))
def test_plain_exts2_matches_numpy_model(corpus):
    q, e, q2, noncan, a, b = SPLICE
    jobs = EXTS2_CORPORA[corpus]()
    mat = K.gen_simple_mat(5, a, b)
    got = KE.exts2_batch(jobs, mat, q, e, q2, noncan, device="cpu")
    for j, (job, g) in enumerate(zip(jobs, got)):
        want = exts2(job["qseq"], job["tseq"], mat, q, e, q2, noncan,
                     job["zdrop"], job["flag"])
        assert ez_key(g) == ez_key(want), (
            f"job {j} flag={job['flag']} "
            f"qlen={len(job['qseq'])} tlen={len(job['tseq'])}")


def test_p_budget_splits_launches(monkeypatch):
    """A one-byte budget gives every job its own launch and changes no
    result; score-only jobs need no backtrack bytes; launches take the
    jobs longest first."""
    jobs = TP.gen_jobs(0, 6)
    jobs[0] = dict(jobs[0], flag=K.KSW_EZ_SCORE_ONLY)
    sizes = KPK._p_sizes(*KPK._job_fields(jobs, False), False)[1]
    assert sizes[0] == 0
    total = int(sizes.sum())
    rows = [len(j["qseq"]) + len(j["tseq"]) for j in jobs]
    longest_first = sorted(range(6), key=lambda i: -rows[i])
    assert longest_first != list(range(6))
    assert KPK.split_by_budget(jobs, False, total) == [longest_first]
    assert KPK.split_by_budget(jobs, False, 1) == \
        [[i] for i in longest_first]
    mat = K.gen_simple_mat(5, 2, 4)
    one = KE.extd2_batch(jobs, mat, 4, 2, 24, 1, device="cpu")
    groups = []
    real_pack = KE.pack_jobs

    def pack(grp, **kw):
        groups.append(len(grp))
        return real_pack(grp, **kw)
    monkeypatch.setattr(KE, "P_BUDGET", 1)
    monkeypatch.setattr(KE, "pack_jobs", pack)
    cut = KE.extd2_batch(jobs, mat, 4, 2, 24, 1, device="cpu")
    assert groups == [1] * 6
    assert [ez_key(g) for g in one] == [ez_key(g) for g in cut]


def test_decode_cigar_holding_the_lock_matches():
    """ksw2_pack._decode_cigar, whose native call keeps the interpreter
    lock (a PyDLL handle), equals ksw2_backtrack.decode_cigar on step codes
    of every state, with and without a tail, reversed or not, with and
    without the intron threshold, and on walks of no step."""
    import ctypes
    from minimap2_chaindp_tpu_torch.ops.ksw2_backtrack import decode_cigar
    fn = KPK._held_decode()
    assert fn is not None and fn._flags_ & ctypes._FUNCFLAG_PYTHONAPI
    rng = np.random.default_rng(11)
    for k in range(400):
        n = int(rng.integers(0, 300)) if k % 10 else 0
        ops = np.repeat(rng.integers(0, 5, 40).astype(np.int8),
                        rng.integers(1, 30, 40))[:n + 5]
        fin_i, fin_j = (int(x) for x in rng.integers(-1, 40, 2))
        args = (ops, n, fin_i, fin_j, bool(k % 2), (0, 20)[k % 3 > 0])
        assert KPK._decode_cigar(*args) == decode_cigar(*args), k


def test_out_of_domain_raises():
    mat = K.gen_simple_mat(5, 2, 40)   # -min(mat) > 2 * (q + e)
    with pytest.raises(ValueError):
        KE.extd2_batch(TP.gen_jobs(0, 1), mat, 4, 2, 24, 1, device="cpu")
    with pytest.raises(ValueError):
        KE.extd2_batch([dict(qseq=np.zeros(0, np.uint8),
                             tseq=np.zeros(5, np.uint8), w=-1, zdrop=-1,
                             end_bonus=0, flag=0)],
                       K.gen_simple_mat(5, 2, 4), 4, 2, 24, 1, device="cpu")


@pytest.mark.parametrize("flag", [
    0, K.KSW_EZ_SPLICE_FOR, K.KSW_EZ_SPLICE_REV,
    K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV,
    K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_FLANK,
    K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV | K.KSW_EZ_SPLICE_FLANK])
def test_donor_acceptor_matches_shared(flag):
    """The vectorized splice signals equal the shared per-base model on
    every length from 0 to 40 and on long GT/AG-rich targets."""
    rng = np.random.default_rng(flag)
    targets = [rng.integers(0, 4, n).astype(np.uint8) for n in range(41)]
    targets += [rng.choice(np.array([0, 1, 2, 3], np.uint8), 3000,
                           p=[0.3, 0.2, 0.3, 0.2]) for _ in range(3)]
    for t in targets:
        for noncan in (9, 0, 15):
            got = KPK.donor_acceptor(t, noncan, flag)
            want = make_donor_acceptor(t, noncan, flag)
            assert all(np.array_equal(g, w) and g.dtype == w.dtype
                       for g, w in zip(got, want)), (len(t), noncan)


@pytest.mark.parametrize("wave", range(3), ids=["noncan0", "noncan9",
                                                  "noncan15"])
def test_splice_signal_matches_donor_acceptor(wave):
    """The plain splice signal of a whole wave equals donor_acceptor job
    by job, at every position of every job's slot, on chip_smoke's mixed
    waves (every splice flag set on targets of 1 to 40 bases, at 16k - 1,
    16k and 16k + 1, and GT/AG-rich ones of 3000 bases); junk in the
    slack between the jobs' targets changes nothing, so no job reads its
    neighbour's bases."""
    name, jobs, noncan = S.splice_signal_waves()[wave]
    pk = KPK.pack_jobs(jobs, splice=True, noncan=noncan)
    assert pk["noncan"] == noncan
    want = _pack_model(jobs, splice=True, noncan=noncan)["dac"]
    ts = KE.device_inputs(pk, "cpu", splice=True)
    got = ts["dac"]
    assert got.dtype == torch.int16 and np.array_equal(got.numpy(), want)
    for j, job in enumerate(jobs):
        to, tl = int(pk["meta"][j, KPK.M_TOFF]), len(job["tseq"])
        donor, acceptor = KPK.donor_acceptor(job["tseq"], noncan, job["flag"])
        sig = got.numpy()[to:to + len(donor)]
        assert np.array_equal(sig.view(np.uint16) & 0xFF,
                              donor.view(np.uint8)), (name, j, tl)
        assert np.array_equal(sig.view(np.uint16) >> 8,
                              acceptor.view(np.uint8)), (name, j, tl)
    # the bytes between the targets (each job's tlen16 - tlen and T_PAD)
    # made to read as splice sites
    junk = pk["tseq"].copy()
    inside = np.zeros(len(junk), bool)
    for j, job in enumerate(jobs):
        to = int(pk["meta"][j, KPK.M_TOFF])
        inside[to:to + len(job["tseq"])] = True
    junk[~inside] = np.resize(np.array([2, 3, 0, 2], np.uint8),
                              int((~inside).sum()))
    again = KE.splice_signal(torch.from_numpy(junk), ts["meta"],
                             t_total=pk["t_total"], noncan=noncan)
    assert torch.equal(again, got)


def _ncol_model(qlen, tlen, w, splice):
    if splice:
        return (min(qlen, tlen) + 15) // 16 * 16 + 16
    return ((min(qlen, tlen, w + 1) + 15) // 16 + 1) * 16


def _plan_model(meta):
    """ksw2_pack.launch_plan as it was, unforced: a ring a job."""
    rows = meta[:, KPK.M_QLEN].astype(np.int64) + meta[:, KPK.M_TLEN] - 1
    by_len = np.argsort(-rows, kind="stable").astype(np.int32)
    rings = np.array([KPK._pow2_at_least(int(x), KPK.RING_MIN)
                      for x in meta[:, KPK.M_LANES]], dtype=np.int64)
    on_chip = rings <= KPK.SMEM_RING_MAX
    order, groups = [], []
    for variant, mask in (("global", ~on_chip), ("block", on_chip)):
        idx = by_len[mask[by_len]]
        if not len(idx):
            continue
        ring = int(rings[idx].max())
        threads = KPK.block_threads(ring) if variant == "block" else min(
            KPK.MAX_THREADS,
            KPK._pow2_at_least(int(meta[idx, KPK.M_LANES].max()), 64))
        groups.append(dict(variant=variant, ring=ring, threads=threads,
                           start=sum(map(len, order)), count=len(idx)))
        order.append(idx)
    order.append(by_len)
    return np.concatenate(order).astype(np.int32), groups


def _pack_model(jobs, *, splice, noncan=0):
    """ksw2_pack.pack_jobs as it was, a loop over the jobs, the splice
    signal `dac` packed on the host: the model of the whole-wave pack."""
    R = len(jobs)
    qlen = np.array([len(j["qseq"]) for j in jobs], dtype=np.int64)
    tlen = np.array([len(j["tseq"]) for j in jobs], dtype=np.int64)
    tsz = (tlen + 15) // 16 * 16 + KPK.T_PAD
    toff = np.cumsum(tsz) - tsz
    qsz = qlen + KPK.Q_PAD
    qoff = np.cumsum(qsz) - qsz
    nrows = qlen + tlen - 1
    opoff = np.cumsum(nrows + 1) - (nrows + 1)
    meta = np.zeros((R, KPK.META_COLS), dtype=np.int32)
    tseq = np.zeros(int(tsz.sum()), dtype=np.uint8)
    qrev = np.zeros(int(qsz.sum()), dtype=np.uint8)
    dac = np.zeros(int(tsz.sum()), dtype=np.int16)
    poff = np.zeros(R, dtype=np.int64)
    p_bytes = band_max = 0
    for j, job in enumerate(jobs):
        qs, ts = job["qseq"], job["tseq"]
        ql, tl = len(qs), len(ts)
        to, qo = int(toff[j]), int(qoff[j])
        tseq[to:to + tl] = ts
        qrev[qo:qo + ql] = qs[::-1]
        flag = job["flag"]
        w = max(ql, tl) if splice or job["w"] < 0 else job["w"]
        if splice:
            donor, acceptor = KPK.donor_acceptor(ts, noncan, flag)
            dac[to:to + len(donor)] = ((donor.astype(np.int16) & 0xFF)
                                       | ((acceptor.astype(np.int16) & 0xFF)
                                          << 8))
        ncol = _ncol_model(ql, tl, w, splice)
        band_max = max(band_max, ncol + 16)
        sconly = bool(flag & K.KSW_EZ_SCORE_ONLY)
        meta[j, KPK.M_QLEN] = ql
        meta[j, KPK.M_TLEN] = tl
        meta[j, KPK.M_W] = w
        meta[j, KPK.M_ZDROP] = job["zdrop"]
        meta[j, KPK.M_RIGHT] = 1 if flag & K.KSW_EZ_RIGHT else 0
        meta[j, KPK.M_APPROX] = 1 if flag & K.KSW_EZ_APPROX_MAX else 0
        meta[j, KPK.M_ADROP] = 1 if flag & K.KSW_EZ_APPROX_DROP else 0
        meta[j, KPK.M_EXTZ] = 1 if flag & K.KSW_EZ_EXTZ_ONLY else 0
        meta[j, KPK.M_SCONLY] = 1 if sconly else 0
        meta[j, KPK.M_ENDB] = 0 if splice else job["end_bonus"]
        meta[j, KPK.M_NCOL] = 0 if sconly else ncol
        meta[j, KPK.M_TOFF] = to
        meta[j, KPK.M_QOFF] = qo
        meta[j, KPK.M_OPOFF] = int(opoff[j])
        meta[j, KPK.M_LANES] = ncol + 16
        poff[j] = p_bytes
        if not sconly:
            p_bytes += (ql + tl - 1) * ncol
    order, groups = _plan_model(meta)
    return dict(tseq=tseq, qrev=qrev, dac=dac, meta=meta, poff=poff,
                order=order, groups=groups, p_bytes=p_bytes,
                ops_total=int((nrows + 1).sum()),
                t_total=int(tsz.sum()), band_max=band_max,
                rows_max=int(nrows.max()) if R else 0)


def pack_waves():
    """(name, jobs, splice, noncan): mixed extd2 and exts2 waves with
    score-only, extz-only, w < 0, approximate-maximum and RIGHT jobs,
    code 4 among the bases; and an empty wave."""
    rng = np.random.default_rng(29)
    odd = (K.KSW_EZ_SCORE_ONLY, K.KSW_EZ_EXTZ_ONLY, K.KSW_EZ_APPROX_MAX,
           K.KSW_EZ_APPROX_MAX | K.KSW_EZ_APPROX_DROP, K.KSW_EZ_RIGHT,
           K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_RIGHT | K.KSW_EZ_REV_CIGAR, 0)
    extd2 = mixed_wave() + TP.gen_jobs(8, 12, tlen_rng=(1, 40))
    for i, job in enumerate(extd2):
        job["flag"] |= odd[i % len(odd)]
        job["w"] = -1 if i % 4 == 0 else job["w"]
        job["end_bonus"] = int(rng.integers(-1, 20))
    extd2[5]["tseq"] = np.where(rng.random(len(extd2[5]["tseq"])) < 0.1, 4,
                                extd2[5]["tseq"]).astype(np.uint8)
    exts2 = TS.gen_jobs(1, 6) + splice_mixed()
    fl = (K.KSW_EZ_SPLICE_REV, K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_FLANK,
          K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_SPLICE_REV)
    for i, job in enumerate(exts2):
        job["flag"] |= odd[i % len(odd)] | fl[i % len(fl)]
    return [("extd2", extd2, False, 0), ("exts2", exts2, True, 9),
            ("exts2 noncan 15", exts2, True, 15),
            ("signal wave", S.splice_signal_waves(3)[1][1], True, 9),
            ("empty extd2", [], False, 0), ("empty exts2", [], True, 9)]


@pytest.mark.parametrize("wave", range(6))
def test_pack_jobs_matches_per_job_model(wave):
    """The whole-wave pack equals the per-job one it replaced on every key
    and dtype; its meta's M_SPLICE column holds each job's splice flags
    (0 in extd2 waves), and the splice signal that the per-job pack made
    on the host comes from tseq and meta (`device_inputs`) bit for bit."""
    name, jobs, splice, noncan = pack_waves()[wave]
    got = KPK.pack_jobs(jobs, splice=splice, noncan=noncan)
    want = _pack_model(jobs, splice=splice, noncan=noncan)
    assert set(got) == set(want) - {"dac"} | {"noncan"}
    assert got["noncan"] == (noncan if splice else 0)
    for k, v in want.items():
        if k == "dac":
            continue
        g = got[k]
        if isinstance(v, np.ndarray):
            assert g.dtype == v.dtype and g.shape == v.shape, (name, k)
            if k == "meta":
                g, v = g[:, :KPK.M_SPLICE], v[:, :KPK.M_SPLICE]
            assert np.array_equal(g, v), (name, k)
        else:
            assert g == v and type(g) is type(v), (name, k)
    flags = np.array([j["flag"] for j in jobs], dtype=np.int64)
    assert got["meta"][:, KPK.M_SPLICE].tolist() == (
        (flags & KPK.SPLICE_BITS) if splice else 0 * flags).tolist()
    ts = KE.device_inputs(got, "cpu", splice=splice)
    assert set(ts) == set(KE.FORWARD_KEYS)
    if splice:
        assert np.array_equal(ts["dac"].numpy(), want["dac"]), name
    else:
        assert ts["dac"] is None and not want["dac"].any()


# ------------------------------------------------- launch plan (off the card)
@pytest.mark.parametrize("lanes,ring,variant", [
    (31, 64, "block"), (32, 64, "block"), (33, 64, "block"),
    (64, 64, "block"), (65, 128, "block"), (256, 256, "block"),
    (257, 512, "block"), (512, 512, "block"), (513, 1024, "block"),
    (16383, 16384, "block"), (16384, 16384, "block"),
    (16385, 32768, "global")])
def test_variant_of_lanes(lanes, ring, variant):
    assert KPK.ring_of(lanes) == ring
    assert KPK.variant_of(lanes) == variant
    # 14 bytes a lane: the widest shared-memory ring fits one block's 227 KB
    assert variant == "global" or ring * 14 <= 232448
    # half a ring of threads, 64 to 512
    assert KPK.block_threads(ring) == min(512, max(64, ring // 2))


@pytest.mark.parametrize("n,w,splice,lanes,variant", [
    (224, -1, False, 256, "block"),      # a ring boundary
    (225, -1, False, 272, "block"),
    (250, 223, False, 256, "block"),     # the band, not the length, sets
    (250, 224, False, 272, "block"),     # the ring
    (253, 100, False, 144, "block"),
    (254, 100, False, 144, "block"),
    (224, -1, True, 256, "block"),
    (225, -1, True, 272, "block"),
    (16352, -1, False, 16384, "block"),  # the shared-memory limit
    (16353, -1, False, 16400, "global"),
    (16352, -1, True, 16384, "block"),
    (16353, -1, True, 16400, "global")])
def test_variant_of_packed_job(n, w, splice, lanes, variant):
    rng = np.random.default_rng(n)
    job = dict(qseq=rng.integers(0, 4, n).astype(np.uint8),
               tseq=rng.integers(0, 4, n + 7).astype(np.uint8), w=w,
               zdrop=100, end_bonus=-1,
               flag=K.KSW_EZ_SPLICE_FOR if splice else 0)
    pk = KPK.pack_jobs([job], splice=splice, noncan=9 if splice else 0)
    assert int(pk["meta"][0, KPK.M_LANES]) == lanes
    # the rows of one anti-diagonal never outgrow the ring: the widest
    # aligned band and the score block tail
    assert lanes >= KPK.n_col_of(n, n + 7, max(n, n + 7) if w < 0 else w,
                                 splice) + 16
    (g,) = pk["groups"]
    assert g["variant"] == variant == KPK.variant_of(lanes)
    assert g["count"] == 1 and g["ring"] == KPK.ring_of(lanes)
    assert g["threads"] == {"global": 512,
                            "block": KPK.block_threads(g["ring"])}[variant]


def test_block_threads():
    assert [KPK.block_threads(r) for r in (64, 128, 512, 1024, 2048, 16384)] \
        == [64, 64, 256, 512, 512, 512]


def mixed_wave():
    """Narrow, wide and tiny jobs in the caller's order: rings of 64 to
    1024 lanes, short and long jobs, equal lengths among them."""
    rng = np.random.default_rng(23)
    jobs = TP.gen_jobs(6, 5, tlen_rng=(20, 90))
    for n, w in ((260, -1), (40, 10), (300, 250), (260, -1), (30, 25),
                 (520, 600)):
        t = rng.integers(0, 4, n).astype(np.uint8)
        jobs.append(dict(qseq=TP.mut(rng, t), tseq=t, w=w, zdrop=400,
                         end_bonus=-1, flag=0))
    jobs[3] = dict(jobs[3], flag=K.KSW_EZ_SCORE_ONLY)
    return jobs


def test_launch_plan_orders_longest_first():
    pk = KPK.pack_jobs(mixed_wave(), splice=False)
    meta, order, groups = (pk[k] for k in ("meta", "order", "groups"))
    R = len(meta)
    rows = meta[:, KPK.M_QLEN] + meta[:, KPK.M_TLEN] - 1
    assert order.dtype == np.int32 and len(order) == 2 * R
    # the groups partition the jobs; the walk takes every job once more
    assert sorted(order[:R]) == list(range(R)) == sorted(order[R:])
    # one block-per-job launch with the ring of the widest job
    assert [(g["variant"], g["ring"], g["threads"], g["start"], g["count"])
            for g in groups] == [("block", 1024, 512, 0, R)]
    for sl in (order[:R], order[R:]):
        r = rows[sl]
        assert (np.diff(r) <= 0).all()                 # longest first
        ties = np.diff(r) == 0
        assert (np.diff(sl)[ties] > 0).all()           # stable among equals
    rings = [KPK.ring_of(x) for x in meta[:, KPK.M_LANES]]
    assert max(rings) == 1024 and min(rings) == 64
    # the narrow jobs alone: a launch sized for them
    narrow = [j for j in range(R) if rings[j] <= 128]
    assert 4 < len(narrow) < R
    _o, (g,) = KPK.launch_plan(meta[narrow])
    assert (g["variant"], g["ring"], g["threads"], g["count"]) == \
        ("block", 128, 64, len(narrow))
    # the inverse: every job keeps its own row, offsets and bytes
    inv = np.empty(R, dtype=np.int64)
    inv[order[:R]] = np.arange(R)
    assert (order[:R][inv] == np.arange(R)).all()
    assert (np.diff(meta[:, KPK.M_OPOFF]) == rows[:-1] + 1).all()
    assert (np.diff(pk["poff"]) == [
        0 if meta[j, KPK.M_SCONLY] else rows[j] * meta[j, KPK.M_NCOL]
        for j in range(R - 1)]).all()
    with pytest.raises(ValueError):
        KPK.launch_plan(meta, force="warp")       # no such variant
    o, (g,) = KPK.launch_plan(meta, force="global")
    assert (g["variant"], g["count"], g["start"]) == ("global", R, 0)
    assert (o[R:] == order[R:]).all()
    # a job too wide for shared memory takes the device-memory launch,
    # first; the others keep theirs
    wide = meta.copy()
    wide[2, KPK.M_LANES] = KPK.SMEM_RING_MAX + 1
    o, gs = KPK.launch_plan(wide)
    assert [(g["variant"], g["ring"], g["start"], g["count"]) for g in gs] \
        == [("global", 2 * KPK.SMEM_RING_MAX, 0, 1),
            ("block", 1024, 1, R - 1)]
    assert o[0] == 2 and sorted(o[:R]) == list(range(R))
    with pytest.raises(ValueError):
        KPK.launch_plan(wide, force="block")      # job 2 does not fit
    o, gs = KPK.launch_plan(wide[[2] + narrow])
    assert [(g["variant"], g["ring"]) for g in gs] == \
        [("global", 2 * KPK.SMEM_RING_MAX), ("block", 128)]


def _raw(pk, gaps, mat, splice, groups, order):
    """Plain forward and walk over `pk` under the given launch groups:
    (p, ez with fin, ops)."""
    q, e, q2, e2, lt, ld = gaps
    ts = KE.device_inputs(pk, "cpu", splice=splice)
    ts["order"] = torch.from_numpy(order)
    scoring = (q, e, q2, e2, int(mat[0]), int(mat[1]),
               -e if splice else -e2, lt, ld)
    p, ez = KE.ksw_forward(*(ts[k] for k in KE.FORWARD_KEYS), groups=groups,
                           scoring=scoring, splice=splice,
                           p_bytes=pk["p_bytes"], t_total=pk["t_total"],
                           band_max=pk["band_max"], rows_max=pk["rows_max"])
    ops = KE.ksw_walk(p, ts["poff"], ts["meta"], ts["order"], ez,
                      splice=splice, ops_total=pk["ops_total"])
    return p.numpy(), ez.numpy(), ops.numpy()


def test_split_wave_equals_unsplit_wave():
    """A mixed wave cut into its launch groups gives the ez rows, the
    backtrack bytes, the step codes and the CIGARs of the same wave as one
    group, in the caller's order, and the numpy model's results."""
    q, e, q2, e2, a, b = EXTD2
    jobs = mixed_wave()
    mat = K.gen_simple_mat(5, a, b)
    pk = KPK.pack_jobs(jobs, splice=False)
    assert len(pk["groups"]) == 1
    gaps = KPK.gap_params(q, e, q2, e2, False)
    whole = _raw(pk, gaps, mat, False, pk["groups"], pk["order"])
    # the plan of the same wave had two of its jobs been too wide for
    # shared memory: two launches
    wide = pk["meta"].copy()
    wide[[1, 7], KPK.M_LANES] = KPK.SMEM_RING_MAX + 1
    order2, groups2 = KPK.launch_plan(wide)
    assert [(g["variant"], g["count"]) for g in groups2] == \
        [("global", 2), ("block", len(jobs) - 2)]
    split = _raw(pk, gaps, mat, False, groups2, order2)
    for name, x, y in zip(("p", "ez", "ops"), split, whole):
        assert np.array_equal(x, y), name
    got = KE.extd2_batch(jobs, mat, q, e, q2, e2, device="cpu")
    for j, (job, g) in enumerate(zip(jobs, got)):
        want = K.extd2(job["qseq"], job["tseq"], mat, q, e, q2, e2,
                       job["w"], job["zdrop"], job["end_bonus"], job["flag"])
        assert ez_key(g) == ez_key(want), f"job {j}"
