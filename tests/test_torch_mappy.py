"""The port's copy of the mappy surface (minimap2_chaindp_tpu_torch/mappy.py)
against the JAX package's: the source differs only in the docstring's
import line, and Aligner.map gives the same hits, field for field, on
seeded reads: the splice fixtures of tests/data (with cs and MD), a small
synthetic map-ont case with single reads and read pairs, and an index
built from a sequence. Exact."""
import dataclasses
import difflib
import os

import numpy as np
import pytest

import minimap2_chaindp_tpu as JP
import minimap2_chaindp_tpu.mappy as jmp
import minimap2_chaindp_tpu_torch as TP
import minimap2_chaindp_tpu_torch.mappy as tmp_
from minimap2_chaindp_tpu_torch.utils import genome_synth as G

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")


def _src(pkg):
    with open(os.path.join(os.path.dirname(pkg.__file__), "mappy.py")) as fh:
        return fh.read().splitlines()


def test_copy_is_the_original():
    diff = [ln for ln in difflib.unified_diff(_src(JP), _src(TP),
                                              lineterm="", n=0)
            if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert diff == ["-    import minimap2_chaindp_tpu.mappy as mp",
                    "+    import minimap2_chaindp_tpu_torch.mappy as mp"]


def _hits(aligner, seq, **kw):
    return [dataclasses.astuple(h) for h in aligner.map(seq, **kw)]


def test_splice_hits_equal():
    ref = os.path.join(DATA, "splice_genome.fa")
    a_j, a_t = (m.Aligner(ref, preset="splice") for m in (jmp, tmp_))
    assert a_j.seq_names == a_t.seq_names and a_j.k == a_t.k
    n = 0
    for name, seq, _q in tmp_.fastx_read(os.path.join(DATA,
                                                      "splice_cdna.fa")):
        got = _hits(a_t, seq, name=name, cs=True, MD=True)
        assert got == _hits(a_j, seq, name=name, cs=True, MD=True), name
        n += len(got)
    assert n > 0
    name = a_t.seq_names[0]
    assert a_t.seq(name, 10, 90) == a_j.seq(name, 10, 90)


def test_map_ont_hits_equal(tmp_path):
    ref, reads = str(tmp_path / "g.fa"), str(tmp_path / "r.fa")
    G.make_genome(ref, n_contigs=2, contig_len=80_000, seed=41)
    G.simulate(ref, reads, 10, 800, 0.05, seed=43)
    a_j, a_t = (m.Aligner(ref, preset="map-ont") for m in (jmp, tmp_))
    recs = list(tmp_.fastx_read(reads))
    n = 0
    for name, seq, _q in recs:
        got = _hits(a_t, seq)
        assert got == _hits(a_j, seq), name
        n += len(got)
    # read pairs: the second mate reverse-complemented, as mappy takes it
    for _name, s1, _q in recs[::2]:
        assert _hits(a_t, s1[:300], seq2=tmp_.revcomp(s1[-300:])) \
            == _hits(a_j, s1[:300], seq2=jmp.revcomp(s1[-300:]))
    assert n >= len(recs)


def test_seq_index_hits_equal():
    rng = np.random.default_rng(8)
    genome = "".join("ACGT"[b] for b in rng.integers(0, 4, 30_000))
    read = genome[5000:6500]
    a_j, a_t = (m.Aligner(seq=genome, preset="map-ont") for m in (jmp, tmp_))
    got = _hits(a_t, read)
    assert got and got == _hits(a_j, read)
    assert _hits(a_t, tmp_.revcomp(read)) == _hits(a_j, jmp.revcomp(read))
