"""Synthetic genomes and simulated reads for genome-scale runs of the port.

`make_genome` and `simulate` are copied from tools/genome_scale.py (:34-110)
with the port's own FASTA reader: the same seeds give the same bytes, so
files cached from either are interchangeable.
"""
from __future__ import annotations

import time

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _rand_seq(rng, n):
    return rng.integers(0, 4, n, dtype=np.uint8)


def _diverge(rng, codes, rate):
    out = codes.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def make_genome(path, n_contigs=25, contig_len=2_000_000, seed=42):
    rng = np.random.default_rng(seed)
    line = _rand_seq(rng, 6000)     # LINE-like family consensus
    sine = _rand_seq(rng, 300)      # SINE-like family consensus
    t0 = time.perf_counter()
    with open(path, "w") as f:
        for c in range(n_contigs):
            g = _rand_seq(rng, contig_len)
            # interspersed repeats
            n_line = int(contig_len * 0.08 / len(line))
            for _ in range(n_line):
                p = int(rng.integers(0, contig_len - len(line)))
                g[p:p + len(line)] = _diverge(rng, line,
                                              rng.uniform(0.08, 0.16))
            n_sine = int(contig_len * 0.05 / len(sine))
            for _ in range(n_sine):
                p = int(rng.integers(0, contig_len - len(sine)))
                g[p:p + len(sine)] = _diverge(rng, sine,
                                              rng.uniform(0.05, 0.20))
            # microsatellites
            for _ in range(40):
                unit = _rand_seq(rng, int(rng.integers(2, 7)))
                reps = int(rng.integers(20, 120))
                run = np.tile(unit, reps)
                p = int(rng.integers(0, contig_len - len(run)))
                g[p:p + len(run)] = run
            # segmental duplications (within-contig)
            for _ in range(3):
                L = 30_000
                src = int(rng.integers(0, contig_len - L))
                dst = int(rng.integers(0, contig_len - L))
                g[dst:dst + L] = _diverge(rng, g[src:src + L], 0.02)
            f.write(f">chr{c + 1}\n")
            s = BASES[g].tobytes().decode()
            for i in range(0, len(s), 80):
                f.write(s[i:i + 80] + "\n")
    return time.perf_counter() - t0


def simulate(ref_path, out_path, n, read_len, err, seed, hpc_style=False):
    from ..io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    contigs = [(r.name, r.seq) for r in read_fastx(ref_path)]
    comp = str.maketrans("ACGT", "TGCA")
    with open(out_path, "w") as f:
        for i in range(n):
            name, seq = contigs[int(rng.integers(0, len(contigs)))]
            st = int(rng.integers(0, len(seq) - read_len))
            frag = seq[st:st + read_len]
            out = []
            for ch in frag:
                r = rng.random()
                if r < err * 0.55:
                    out.append("ACGT"[int(rng.integers(0, 4))])
                elif r < err * 0.8:
                    pass
                elif r < err:
                    out.append(ch)
                    out.append("ACGT"[int(rng.integers(0, 4))])
                else:
                    out.append(ch)
            s = "".join(out)
            strand = "+" if rng.random() < 0.5 else "-"
            if strand == "-":
                s = s[::-1].translate(comp)
            f.write(f">r{i}!{name}!{st}!{st + read_len}!{strand}\n{s}\n")
