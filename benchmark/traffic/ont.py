"""Single-segment long reads (ONT-like) from anywhere in the genome.

The mix file gives "reads" (per batch, with "batches" batches in the pool),
"length": {"median", "sigma", "min", "max"} of a log-normal distribution,
and "error": {"rate", "sub", "del"} (the rest insertions). Every seed gets
the same set of lengths, the log-normal's quantiles at (i + 0.5) / n clipped
to [min, max], in its own order; contig, start and strand are drawn from the
seed. One FASTA file, read one read a fragment.
"""
from __future__ import annotations

import os
from statistics import NormalDist

import numpy as np

from . import synth


def lengths(n: int, median: float, sigma: float, lo: int, hi: int):
    z = NormalDist()
    q = [median * np.exp(sigma * z.inv_cdf((i + 0.5) / n)) for i in range(n)]
    return np.clip(np.rint(q), lo, hi).astype(np.int64)


def make(mix: dict, genome, loci, rng, out_dir: str) -> dict:
    n = mix["reads"] * mix["batches"]
    ln = mix["length"]
    lens = rng.permutation(lengths(n, ln["median"], ln["sigma"], ln["min"],
                                   ln["max"]))
    clen = np.asarray([len(a) for _n, a in genome])
    contig = rng.integers(0, len(genome), n)
    lens = np.minimum(lens, clen[contig] - 1)
    start = (rng.random(n) * (clen[contig] - lens)).astype(np.int64)
    src = synth.slices(genome, contig, start, lens)
    err = mix["error"]
    seqs, new = synth.mutate(rng, src, lens, err["rate"], err["sub"],
                             err["del"])
    seqs = synth.reverse_complement(seqs, new, rng.random(n) < 0.5)
    path = os.path.join(out_dir, "reads.fa")
    with open(path, "wb") as fh:
        fh.write(synth.records([f"r{i}" for i in range(n)], seqs, new,
                               fastq=False))
    return dict(files=[path], frag_mode=False,
                batch_bases=int(new.sum()) // mix["batches"])
