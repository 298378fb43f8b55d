"""Spliced cDNA reads from the gene loci the configuration patches into the
genome (chip_smoke.py:1177-1226, _write_spliced).

The mix file gives "reads" (per batch, with "batches" batches in the pool),
"zipf": the exponent of the genes' expression (gene of rank r drawn with
weight 1 / r^zipf, the ranks a permutation drawn from the seed), "skip": the
share of transcripts of the isoform that skips one internal exon, and
"error": {"rate", "sub", "del"} (the rest insertions). Half the reads are
reverse complemented. One FASTA file, one read a fragment. The mix file's
"sources" name where each number comes from.
"""
from __future__ import annotations

import os

import numpy as np

from . import synth


def make(mix: dict, genome, loci, rng, out_dir: str) -> dict:
    if not loci:
        raise ValueError("cdna traffic needs a genome with gene loci")
    n = mix["reads"] * mix["batches"]
    rank = rng.permutation(len(loci))
    weight = 1.0 / (rank + 1.0) ** mix["zipf"]
    gene = rng.choice(len(loci), n, p=weight / weight.sum())
    skip = rng.random(n) < mix["skip"]
    contig, start, lens = [], [], []
    for g, s in zip(gene, skip):
        ci, exons = loci[g]
        if s and len(exons) > 2:
            drop = int(rng.integers(1, len(exons) - 1))
            exons = exons[:drop] + exons[drop + 1:]
        contig += [ci] * len(exons)
        start += [a for a, _b in exons]
        lens.append([b - a for a, b in exons])
    ex_len = np.asarray([x for ls in lens for x in ls], np.int64)
    src = synth.slices(genome, np.asarray(contig), np.asarray(start), ex_len)
    tx_len = np.asarray([sum(ls) for ls in lens], np.int64)
    err = mix["error"]
    seqs, new = synth.mutate(rng, src, tx_len, err["rate"], err["sub"],
                             err["del"])
    seqs = synth.reverse_complement(seqs, new, rng.random(n) < 0.5)
    path = os.path.join(out_dir, "reads.fa")
    with open(path, "wb") as fh:
        fh.write(synth.records([f"tx{i}" for i in range(n)], seqs, new,
                               fastq=False))
    return dict(files=[path], frag_mode=False,
                batch_bases=int(new.sum()) // mix["batches"])
