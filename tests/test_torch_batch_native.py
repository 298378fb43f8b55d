"""The port's batched native mapping drivers (native.map_batch_text_native,
map_batch_pe_native: one C call a batch) against its per-read and per-pair
native paths (map_unit_text_native, map_frag_pe_native): the three
behaviours of tests/test_batch_native.py (which reads a reference tree) on
a utils/genome_synth genome. The same lines read for read, including the
entries the batch declines (an empty read, a non-ASCII name); pairs;
and the buffer-grow protocol on a read whose output overflows the first
258 line slots (-N 300 on chip_smoke.edge_queries' tandem repeat). The
stealing lane's host lane maps through these drivers; each batch is also
held against the JAX package's drivers on the same inputs."""
import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from minimap2_chaindp_tpu import native as JN  # noqa: E402
from minimap2_chaindp_tpu.index.build import build_index as jax_build  # noqa: E402
from minimap2_chaindp_tpu.options import set_opt as jax_opt  # noqa: E402
from minimap2_chaindp_tpu_torch import constants as C  # noqa: E402
from minimap2_chaindp_tpu_torch import native as TN  # noqa: E402
from minimap2_chaindp_tpu_torch.index.build import build_index  # noqa: E402
from minimap2_chaindp_tpu_torch.io.fastx import SeqRecord, read_fastx  # noqa: E402
from minimap2_chaindp_tpu_torch.options import set_opt  # noqa: E402
from minimap2_chaindp_tpu_torch.utils import genome_synth as G  # noqa: E402
from chip_smoke import edge_queries  # noqa: E402

SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR


def _both(ref, preset, **opt):
    """((port mi, mo), (JAX mi, mo)) of the genome at `ref`."""
    recs = list(read_fastx(ref))
    names = [r.name for r in recs]
    io, mo = set_opt(preset)
    jio, jmo = jax_opt(preset)
    mi = build_index(names, [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    jmi = jax_build(names, [r.seq for r in recs], jio.w, jio.k, jio.flag,
                    jio.bucket_bits)
    for m, i in ((mo, mi), (jmo, jmi)):
        m.flag |= SAM
        for k, v in opt.items():
            setattr(m, k, v)
        m.update(i)
    assert TN.map_unit_ok(mo, mi), "the native driver did not build"
    return (mi, mo), (jmi, jmo)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("batch_native")
    ref = str(d / "g.fa")
    G.make_genome(ref, n_contigs=2, contig_len=100_000, seed=19)
    return dict(d=d, ref=ref, seq=next(iter(read_fastx(ref))).seq)


def _sim(seq, n, length, err, seed, prefix="b"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        st = int(rng.integers(0, len(seq) - length))
        s = "".join(c if rng.random() > err
                    else "ACGT"[int(rng.integers(0, 4))]
                    for c in seq[st:st + length])
        if rng.random() < 0.5:
            s = C.revcomp_str(s)
        out.append(SeqRecord(f"{prefix}{i}", s, "I" * len(s)))
    return out


def test_batch_se_matches_per_read(genome):
    (mi, mo), (jmi, jmo) = _both(genome["ref"], "map-ont")
    recs = _sim(genome["seq"], 40, 1000, 0.1, 3)
    recs.insert(5, SeqRecord("empty", ""))            # qlen 0: declined
    recs.insert(9, SeqRecord("née7", recs[0].seq))   # non-ASCII name
    got = TN.map_batch_text_native(mi, mo, recs, "")
    assert got is not None and len(got) == len(recs)
    assert got == JN.map_batch_text_native(jmi, jmo, recs, "")
    n_ok = 0
    for rec, lines in zip(recs, got):
        want = TN.map_unit_text_native(mi, mo, rec, "")
        if lines is None:
            # the batch declines only what the per-read path declines and
            # the documented fallbacks: an empty read, a non-ASCII name
            assert want is None or rec.name == "née7" or not rec.seq
            continue
        assert lines == want, rec.name
        n_ok += 1
    assert n_ok >= 38


def test_batch_pe_matches_per_pair(genome):
    (mi, mo), (jmi, jmo) = _both(genome["ref"], "sr")
    seq = genome["seq"]
    rng = np.random.default_rng(11)
    pairs = []
    for i in range(30):
        ins = int(rng.integers(300, 700))
        st = int(rng.integers(0, len(seq) - ins))
        pairs.append((SeqRecord(f"pp{i}/1", seq[st:st + 150], "I" * 150),
                      SeqRecord(f"pp{i}/2", C.revcomp_str(
                          seq[st + ins - 150:st + ins]), "I" * 150)))
    got = TN.map_batch_pe_native(mi, mo, pairs, "")
    assert got is not None and len(got) == len(pairs)
    assert got == JN.map_batch_pe_native(jmi, jmo, pairs, "")
    n_ok = 0
    for segs, lines in zip(pairs, got):
        want = TN.map_frag_pe_native(mi, mo, list(segs), "")
        if lines is None:
            assert want is None
            continue
        assert lines == want, segs[0].name
        n_ok += 1
    assert n_ok >= 25           # nearly all pairs take the native path


def test_batch_grow_protocol(genome, monkeypatch):
    """A read whose output overflows the first text and line buffers comes
    back complete after the grow-and-rerun loop, the per-read path's lines
    (which grows its own buffers), eight times in one batch."""
    grows, rcs = [], []
    real_grow, real_run = TN._MapUnitCtx._grow_text, TN._run_batch_call

    def grow(self, code, n):
        grows.append(code)
        return real_grow(self, code, n)

    def run(call, n, total_q):
        def counted(*a):
            rcs.append(call(*a))
            return rcs[-1]
        return real_run(counted, n, total_q)
    monkeypatch.setattr(TN._MapUnitCtx, "_grow_text", grow)
    monkeypatch.setattr(TN, "_run_batch_call", run)
    ref, qry = edge_queries(genome["ref"], str(genome["d"]))["tandem"]
    (mi, mo), (jmi, jmo) = _both(ref, "map-ont", best_n=300, pri_ratio=0.0)
    rec = next(iter(read_fastx(qry)))
    recs = [rec] * 8
    got = TN.map_batch_text_native(mi, mo, recs, "")
    assert got is not None
    assert rcs[0] < 0 and rcs[-1] == 0        # overflowed, grown, rerun
    want = TN.map_unit_text_native(mi, mo, rec, "")
    assert grows                               # the per-read path grew
    assert len([ln for ln in want if ln[0] != "@"]) > 258
    assert all(lines == want for lines in got)
    assert got == JN.map_batch_text_native(jmi, jmo, recs, "")
