"""Synthetic genomes and simulated reads for genome-scale runs of the port.

`make_genome` and `simulate` are copied from tools/genome_scale.py (:34-110)
with the port's own FASTA reader, and make_genome cuts its lines with numpy
(`fasta_lines`): the same seeds give the same bytes, so files cached from
either are interchangeable. `simulate_pairs` is its
paired-end generator (:295-318) as a function; `cached_genome` keeps one
genome per (contigs, length, seed) under the temp directory.

The inputs a human reference really has: `mask_genome` writes a copy of a
genome soft-masked (about half its bases lowercased, in runs, as
RepeatMasker leaves GRCh38's UCSC distribution), with N gaps (telomere-like
ones at both contig ends, one long one inside each contig, a few short
ones) and a few IUPAC codes; `transform_reads` puts N runs, single Ns,
IUPAC codes and lowercase stretches into reads at stated rates;
`edge_reads` simulates reads across the edges of a genome's N gaps. The
minus strand of `simulate` and `simulate_pairs` complements every base as
the reference's seq_comp_table does (case, N and IUPAC codes kept), so an
`ACGT` genome gives the same bytes as the JAX tool's generator (whose
table complements ACGT alone).
"""
from __future__ import annotations

import os
import tempfile
import time

import numpy as np

from ..constants import SEQ_COMP_TABLE

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# the reference's complement of raw bases (bseq.c seq_comp_table): ACGT,
# their lowercase, N and the IUPAC codes, each keeping its case
COMP = {i: int(c) for i, c in enumerate(SEQ_COMP_TABLE[:128]) if i != c}
IUPAC = "RYSWKMBDHV"
# mask_genome's soft-masked and plain runs (bases), its short gaps
MASK_RUN = (100, 3000)
SHORT_GAP = 100
# the N runs whose edges edge_reads crosses: at least this long
MIN_GAP = 1000


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
            f.write(fasta_lines(BASES[g]))
    return time.perf_counter() - t0


def fasta_lines(seq: np.ndarray, width: int = 80) -> str:
    """ASCII codes `seq` as FASTA lines of `width` bases, each ended by a
    newline (the bytes of writing seq[i:i + width] + "\\n" in a loop, at
    numpy speed: a 3 Gbp genome has 37.5M lines)."""
    n = len(seq)
    full = n - n % width
    body = np.empty((full // width, width + 1), np.uint8)
    body[:, :width] = seq[:full].reshape(-1, width)
    body[:, width] = ord("\n")
    tail = seq[full:].tobytes() + b"\n" if n % width else b""
    return (body.tobytes() + tail).decode()


def simulate(ref_path, out_path, n, read_len, err, seed, hpc_style=False):
    from ..io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    contigs = [(r.name, r.seq) for r in read_fastx(ref_path)]
    with open(out_path, "w") as f:
        for i in range(n):
            name, seq = contigs[int(rng.integers(0, len(contigs)))]
            st = int(rng.integers(0, len(seq) - read_len))
            _write_read(f, rng, f"r{i}", name, seq, st, read_len, err)


def _write_read(f, rng, rname, name, seq, st, read_len, err):
    """One simulated read of seq[st:st + read_len]: substitutions (55% of
    err), deletions (25%) and insertions (20%), then a strand; named
    rname!contig!start!end!strand."""
    out = []
    for ch in seq[st:st + read_len]:
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
        s = s[::-1].translate(COMP)
    f.write(f">{rname}!{name}!{st}!{st + read_len}!{strand}\n{s}\n")


def simulate_pairs(ref_path, out1, out2, n, seed=21, read_len=150,
                   insert=(300, 700), err=0.005):
    """n FR pairs of read_len-bp FASTQ reads from inserts drawn in
    [insert) with uniform substitutions at rate err; the second mate is the
    reverse complement of the insert's end. Returns the truth, one
    (contig, start1, start2, insert) per pair."""
    from ..io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    contigs = [(r.name, r.seq) for r in read_fastx(ref_path)]
    qual = "I" * read_len
    truth = []
    with open(out1, "w") as f1, open(out2, "w") as f2:
        for i in range(n):
            cname, seq = contigs[int(rng.integers(0, len(contigs)))]
            ins = int(rng.integers(*insert))
            st = int(rng.integers(0, len(seq) - ins))
            r1 = list(seq[st:st + read_len])
            r2 = list(seq[st + ins - read_len:st + ins])
            for r in (r1, r2):
                for j in range(len(r)):
                    if rng.random() < err:
                        r[j] = "ACGT"[int(rng.integers(0, 4))]
            r2 = "".join(r2)[::-1].translate(COMP)
            f1.write(f"@pp{i}\n{''.join(r1)}\n+\n{qual}\n")
            f2.write(f"@pp{i}\n{r2}\n+\n{qual}\n")
            truth.append((cname, st, st + ins - read_len, ins))
    return truth


def _case_of(arr, letters):
    """ASCII `letters` in the case of the bases `arr` they replace."""
    return letters | (arr & 0x20)


def mask_genome(src, dst, seed=7, end_gap=10_000, inner_gap=50_000,
                short_gaps=3, iupac=8):
    """Write a copy of the genome `src` to `dst` with the edges of a real
    reference, contig by contig: runs of lengths drawn from MASK_RUN,
    lowercased and left alone in turn (about half the bases soft-masked);
    then N gaps of end_gap bases at both ends (telomere-like), one of
    inner_gap bases inside, and short_gaps of SHORT_GAP bases; then
    `iupac` IUPAC codes (RYSWKMBDHV) in the case of the base they replace.
    Gaps are cut to fit a short contig. Returns {"lower": soft-masked
    share of the bases, "n": N bases, "iupac": IUPAC bases, "gaps": [(contig,
    start, end)]}."""
    from ..io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(IUPAC.encode(), np.uint8)
    n_low = n_n = n_iu = total = 0
    gaps = []
    with open(dst, "w") as f:
        for rec in read_fastx(src):
            a = np.frombuffer(rec.seq.encode(), np.uint8).copy()
            n = len(a)
            runs = rng.integers(*MASK_RUN, 2 * n // MASK_RUN[0] + 2)
            masked = (np.arange(len(runs)) + int(rng.integers(0, 2))) % 2
            low = np.repeat(masked.astype(bool), runs)[:n]
            a[low] |= 0x20
            end = min(end_gap, n // 8)
            inner = min(inner_gap, n // 8)
            spans = [(0, end), (n - end, n)]
            p = int(rng.integers(n // 4, max(n // 4 + 1, 3 * n // 4 - inner)))
            spans.append((p, p + inner))
            for _ in range(short_gaps):
                p = int(rng.integers(end, max(end + 1, n - end - SHORT_GAP)))
                spans.append((p, p + min(SHORT_GAP, n - end - p)))
            for st, en in spans:
                a[st:en] = ord("N")
                if en > st:
                    gaps.append((rec.name, st, en))
            pos = rng.integers(end, max(end + 1, n - end), iupac)
            keep = a[pos] != ord("N")
            pos = pos[keep]
            a[pos] = _case_of(a[pos], letters[rng.integers(0, len(letters),
                                                           len(pos))])
            n_low += int(((a >= ord("a")) & (a != ord("n"))).sum())
            n_n += int((a == ord("N")).sum())
            n_iu += len(np.unique(pos))
            total += n
            f.write(f">{rec.name}\n")
            f.write(fasta_lines(a))
    return dict(lower=n_low / max(total, 1), n=n_n, iupac=n_iu, gaps=gaps)


def gap_edges(ref_path):
    """The edges between bases and the N runs of at least MIN_GAP bases
    in a genome: [(contig, position)], the first N of a run that follows a
    base and the first base after a run (a contig's ends are no edge)."""
    from ..io.fastx import read_fastx
    edges = []
    for rec in read_fastx(ref_path):
        isn = np.frombuffer(rec.seq.encode(), np.uint8) | 0x20 == ord("n")
        d = np.diff(np.concatenate([[0], isn.astype(np.int8), [0]]))
        for st, en in zip(np.flatnonzero(d == 1), np.flatnonzero(d == -1)):
            if en - st >= MIN_GAP:
                edges += [(rec.name, int(p)) for p in (st, en)
                          if 0 < p < len(isn)]
    return edges


def edge_reads(ref_path, out_path, read_len, err, seed, n=None):
    """Simulated reads (as `simulate` writes them, named e<i>!...) across
    the edges of the genome's N gaps (gap_edges: every edge, or `n` of
    them evenly spaced): each starts half a read before its edge, moved
    inside the contig."""
    from ..io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    seqs = {r.name: r.seq for r in read_fastx(ref_path)}
    edges = gap_edges(ref_path)
    if n is not None:
        edges = edges[::max(1, len(edges) // n)][:n]
    with open(out_path, "w") as f:
        for i, (name, pos) in enumerate(edges):
            seq = seqs[name]
            st = min(max(pos - read_len // 2, 0), len(seq) - read_len)
            _write_read(f, rng, f"e{i}", name, seq, st, read_len, err)


def transform_reads(src, dst, seed, n_rate=0.0, iupac_rate=0.0,
                    run_rate=0.0, run_len=(5, 50), lower_rate=0.0,
                    lower_len=(20, 500)):
    """Copy the reads of `src` (FASTA or FASTQ, written back as read) to
    `dst` with: single Ns at n_rate a base, IUPAC codes at iupac_rate a
    base (each in the case of the base it replaces); one N run of run_len
    bases in a share run_rate of the reads; one lowercase stretch of
    lower_len bases in a share lower_rate of them. Lengths and qualities
    are kept."""
    from ..io.fastx import read_fastx
    rng = np.random.default_rng(seed)
    letters = np.frombuffer(IUPAC.encode(), np.uint8)
    with open(dst, "w") as f:
        for rec in read_fastx(src):
            a = np.frombuffer(rec.seq.encode(), np.uint8).copy()
            n = len(a)
            if n and rng.random() < lower_rate:
                ln = min(int(rng.integers(*lower_len)), n)
                p = int(rng.integers(0, n - ln + 1))
                a[p:p + ln] |= 0x20
            hit = rng.random(n) < n_rate
            a[hit] = _case_of(a[hit], ord("N"))
            hit = rng.random(n) < iupac_rate
            a[hit] = _case_of(a[hit], letters[rng.integers(
                0, len(letters), int(hit.sum()))])
            if n and rng.random() < run_rate:
                ln = min(int(rng.integers(*run_len)), n)
                p = int(rng.integers(0, n - ln + 1))
                a[p:p + ln] = ord("N")
            seq = a.tobytes().decode()
            head = rec.name + (f" {rec.comment}" if rec.comment else "")
            if rec.qual is not None:
                f.write(f"@{head}\n{seq}\n+\n{rec.qual}\n")
            else:
                f.write(f">{head}\n{seq}\n")


def cache_dir() -> str:
    """The directory that caches generated genomes, reads and indexes
    between runs: mm2tpu_torch_cache under the temp directory."""
    d = os.path.join(tempfile.gettempdir(), "mm2tpu_torch_cache")
    os.makedirs(d, exist_ok=True)
    return d


def cached_genome(n_contigs=25, contig_len=2_000_000, seed=42) -> str:
    """The path of make_genome(n_contigs, contig_len, seed), written once
    into cache_dir() (through a temp file, so a reader never sees a part)."""
    path = os.path.join(cache_dir(),
                        f"genome_{n_contigs}x{contig_len}_s{seed}.fa")
    if not os.path.exists(path):
        tmp = f"{path}.{os.getpid()}.tmp"
        make_genome(tmp, n_contigs=n_contigs, contig_len=contig_len,
                    seed=seed)
        os.replace(tmp, path)
    return path
