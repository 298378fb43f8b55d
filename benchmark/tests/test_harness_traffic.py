"""The generators: deterministic by seed, with the error mix, the length
distribution, the gene structure and the genome's masking they state,
measured on a sample."""
import os

import numpy as np
import pytest

from benchmark.traffic import cdna, ont, sr_pairs, synth


def genome(seed, loci=False):
    recipe = dict(contigs=4, contig_len=300_000, mask=True)
    if loci:
        recipe["loci"] = dict(
            genes=20, exons=dict(median=7, mean=8.8, min=3, max=40),
            exon_len=dict(median=122, mean=145, min=30, max=2000),
            intron_len=dict(median=1023, mean=3365, min=70, max=30000))
    return synth.build(np.random.default_rng([seed, 0]), recipe)


def test_genome_is_deterministic_and_masked():
    (g1, _), (g2, _), (g3, _) = genome(5), genome(5), genome(6)
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(g1, g2))
    assert not all(np.array_equal(a, b) for (_, a), (_, b) in zip(g1, g3))
    a = np.concatenate([x for _n, x in g1])
    lower = ((a >= ord("a")) & (a != ord("n"))).mean()
    n_share = (a == ord("N")).mean()
    assert 0.4 < lower < 0.6            # about half soft-masked
    assert 0.02 < n_share < 0.3         # gaps at both ends and inside
    assert np.isin(a, np.frombuffer(b"RYSWKMBDHVryswkmbdhv", np.uint8)).sum()


def test_mutate_measures_its_error_mix():
    rng = np.random.default_rng(1)
    src = synth.BASES[rng.integers(0, 4, 400_000)]
    lens = np.full(4, 100_000)
    out, new = synth.mutate(rng, src, lens, 0.10, 0.55, 0.25)
    # deletions remove 2.5% and insertions add 2% of the bases
    assert abs(new.sum() / lens.sum() - (1 - 0.025 + 0.02)) < 0.003
    assert len(out) == new.sum()


def test_reverse_complement_keeps_case_and_codes():
    seqs = np.frombuffer(b"ACgtNRacg", np.uint8).copy()
    out = synth.reverse_complement(seqs, np.array([5, 4]), [True, False])
    assert out.tobytes() == b"NacGTRacg"


def test_ont_lengths_are_the_same_set_for_every_seed(tmp_path):
    mix = dict(reads=50, batches=4, length=dict(median=10_000, sigma=0.6,
                                               min=1000, max=50_000),
               error={"rate": 0.1, "sub": 0.55, "del": 0.25})
    L = ont.lengths(200, 10_000, 0.6, 1000, 50_000)
    assert abs(np.median(L) - 10_000) < 300
    assert L.min() >= 1000 and L.max() <= 50_000
    g, _ = genome(3)
    runs = []
    for seed in (1, 1, 2):
        d = tmp_path / str(len(runs))
        d.mkdir()
        r = ont.make(mix, g, None, np.random.default_rng(seed), str(d))
        runs.append(open(r["files"][0], "rb").read())
        assert r["batch_bases"] > 0 and not r["frag_mode"]
    assert runs[0] == runs[1] and runs[0] != runs[2]


SR = dict(pairs=30, batches=2, read_len=150, insert=dict(mean=500, sd=50),
          max_n=0.05, error=0.02,
          mutation=dict(rate=0.001, indel=0.15, extend=0.3))


def test_sr_pairs(tmp_path):
    g, _ = genome(3)
    runs = []
    for seed in (4, 4, 5):
        d = tmp_path / str(len(runs))
        d.mkdir()
        r = sr_pairs.make(SR, g, None, np.random.default_rng(seed), str(d))
        runs.append([open(f, "rb").read() for f in r["files"]])
    assert runs[0] == runs[1] and runs[0] != runs[2]
    assert r["frag_mode"] and len(r["files"]) == 2
    lines = open(r["files"][0]).read().split("\n")
    assert lines[0] == "@pp0" and len(lines[1]) == 150
    assert r["batch_bases"] == 2 * 150 * 30


def test_sr_pairs_hold_wgsims_model(tmp_path):
    """Both mates of an error-free pair lie on one strand of the genome at
    the fragment's ends, the fragment 500 +- 50; the reads' differences from
    the genome are wgsim's 2% errors plus its 0.1% mutations."""
    g, _ = genome(3)
    mix = dict(SR, pairs=2000, batches=1, error=0.0, mutation=dict(
        rate=0.0, indel=0.15, extend=0.3))
    r = sr_pairs.make(mix, g, None, np.random.default_rng(6), str(tmp_path))
    text = {n: a.tobytes().upper() for n, a in g}
    m1 = open(r["files"][0], "rb").read().split(b"\n")[1::4]
    m2 = open(r["files"][1], "rb").read().split(b"\n")[1::4]
    flen = []
    for a, b in zip(m1[:300], m2[:300]):
        a, b = a.upper(), b.upper()
        b_rc = bytes(synth.COMP[np.frombuffer(b, np.uint8)][::-1])
        for seq in text.values():
            i, j = seq.find(a), seq.find(b_rc)
            if i >= 0 and j >= 0:
                flen.append(j + 150 - i)
                break
            i, j = seq.find(b), seq.find(bytes(
                synth.COMP[np.frombuffer(a, np.uint8)][::-1]))
            if i >= 0 and j >= 0:
                flen.append(j + 150 - i)
                break
    # a mate found at another copy of a repeat gives no fragment length
    flen = [f for f in flen if 0 < f < 2000]
    assert len(flen) > 250
    assert abs(np.mean(flen) - 500) < 10 and 40 < np.std(flen) < 60
    rng = np.random.default_rng(7)
    src = synth.BASES[rng.integers(0, 4, 1_000_000)]
    out = synth.substitute(rng, src, 0.02)
    assert abs((out != src).mean() - 0.02) < 0.001
    assert ((out | 0x20) == (src | 0x20)).sum() == (out == src).sum()
    ins = synth.indels(rng, src, 0.001, 0.3)
    # insertions and deletions as likely, 1 / (1 - 0.3) bases each
    assert abs(len(ins) - len(src)) < 300


def test_lognormal_set_is_the_same_for_every_seed():
    spec = dict(median=1023, mean=3365, min=70, max=10**9)
    a = synth.lognormal_set(20_001, spec)
    assert np.median(a) == 1023
    assert abs(a.mean() / 3365 - 1) < 0.05
    clipped = synth.lognormal_set(1000, dict(spec, max=30_000))
    assert clipped.min() >= 70 and clipped.max() == 30_000


def test_cdna_zipf_and_splice_sites(tmp_path):
    g, loci = genome(3, loci=True)
    _, again = genome(3, loci=True)
    assert loci == again
    for ci, ex in loci:
        seq = g[ci][1]
        for (_a, b), (c, _d) in zip(ex, ex[1:]):
            assert seq[b:b + 2].tobytes() == b"GT"
            assert seq[c - 2:c].tobytes() == b"AG"
    n_ex = sorted(len(ex) for _ci, ex in loci)
    assert n_ex == sorted(synth.lognormal_set(20, dict(
        median=7, mean=8.8, min=3, max=40)).tolist())
    mix = dict(reads=200, batches=2, zipf=1.0, skip=0.5,
               error={"rate": 0.15, "sub": 0.10, "del": 0.30})
    r = cdna.make(mix, g, loci, np.random.default_rng(9), str(tmp_path))
    assert os.path.getsize(r["files"][0]) > 0
    with pytest.raises(ValueError):
        cdna.make(mix, g, None, np.random.default_rng(9), str(tmp_path))
