"""Paired-end short reads in FR orientation, simulated as wgsim (Li's
simulator, the samtools project) simulates them with its default options:
fragment lengths normal with "insert" {"mean", "sd"} (-d 500 -s 50), drawn
again below the read length; fragments whose share of N is over "max_n"
(-A 0.05) left out; mutations of the fragment at "mutation" {"rate",
"indel", "extend"} (-r 0.001 -R 0.15 -X 0.3: substitutions, and insertions
or deletions of 1 + a geometric number of bases), here drawn anew for every
fragment; a random strand; the first mate the fragment's first "read_len"
bases and the second the reverse complement of its last; sequencing errors,
substitutions at "error" (-e 0.02) a base, on each mate. The genome's case
is kept, as the port's generators keep it.

The mix file also gives "pairs" (per batch, with "batches" batches in the
pool). Two FASTQ files, read as pairs (fragment mode).
"""
from __future__ import annotations

import os

import numpy as np

from . import synth

# room past the fragment's end for the bases its deletions take away
SLACK = 64


def make(mix: dict, genome, loci, rng, out_dir: str) -> dict:
    n = mix["pairs"] * mix["batches"]
    rl = mix["read_len"]
    ins, mut = mix["insert"], mix["mutation"]
    m = 2 * n + 16               # candidates; those holding N are left out
    d = np.rint(rng.normal(ins["mean"], ins["sd"], m)).astype(np.int64)
    low = d < rl
    while low.any():
        d[low] = np.rint(rng.normal(ins["mean"], ins["sd"], int(low.sum())))
        low = d < rl
    clen = np.asarray([len(a) for _n, a in genome])
    contig = rng.integers(0, len(genome), m)
    span = d + SLACK
    start = (rng.random(m) * (clen[contig] - span)).astype(np.int64)
    src = synth.slices(genome, contig, start, span)
    at = np.concatenate([[0], np.cumsum(span)[:-1]])
    within = np.arange(len(src)) - np.repeat(at, span)
    is_n = ((src | 0x20) == ord("n")) & (within < np.repeat(d, span))
    keep = np.add.reduceat(is_n, at) <= mix["max_n"] * d
    if keep.sum() < n:
        raise ValueError("too many fragments hold N")
    pick = np.flatnonzero(keep)[:n]
    src = synth.substitute(rng, src, mut["rate"] * (1 - mut["indel"]))
    frags = np.split(src, at[1:])
    d = d[pick]
    flat = np.concatenate([
        synth.indels(rng, frags[i], mut["rate"] * mut["indel"],
                     mut["extend"])[:L] for i, L in zip(pick.tolist(), d)])
    flat = synth.reverse_complement(flat, d, rng.random(n) < 0.5)
    fs = np.concatenate([[0], np.cumsum(d)[:-1]])
    cols = np.arange(rl)
    m1 = flat[(fs[:, None] + cols).ravel()]
    m2 = flat[(fs[:, None] + d[:, None] - rl + cols).ravel()]
    lens = np.full(n, rl, np.int64)
    m1 = synth.substitute(rng, m1, mix["error"])
    m2 = synth.substitute(rng, m2, mix["error"])
    m2 = synth.reverse_complement(m2, lens, np.ones(n, bool))
    names = [f"pp{i}" for i in range(n)]
    files = []
    for k, s in ((1, m1), (2, m2)):
        path = os.path.join(out_dir, f"reads_{k}.fq")
        with open(path, "wb") as fh:
            fh.write(synth.records(names, s, lens, fastq=True))
        files.append(path)
    return dict(files=files, frag_mode=True,
                batch_bases=2 * rl * n // mix["batches"])
