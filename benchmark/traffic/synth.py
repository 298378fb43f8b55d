"""The benchmark's synthetic genome and the read simulation the traffic kinds
share, in numpy, whole arrays at a time.

Frozen and vectorized from the port's generators at commit 241cda7:
`make_genome` from minimap2_chaindp_tpu_torch/utils/genome_synth.py:54-92
(random contigs with LINE- and SINE-like repeat families, microsatellites
and segmental duplications), `mask_genome` from :188-240 (soft-masked runs,
N gaps at both ends, inside and short, IUPAC codes), the gene loci of
chip_smoke.py:1177-1209 (`_write_spliced`, GT..AG at every intron; here with
exon counts, exon and intron lengths drawn as `lognormal_set` states), and the
error model of chip_smoke.py:1158-1175 (`_mutate`: substitutions, deletions
and insertions in the shares a mix states) with the minus strand complemented
as the reference's seq_comp_table does (case, N and IUPAC codes kept,
genome_synth.py:36). The port's versions loop over bases in Python; these
give the same kinds of sequence, not the same bytes.

A genome is a list of (name, ASCII uint8 array) contigs.
"""
from __future__ import annotations

from statistics import NormalDist

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)
IUPAC = np.frombuffer(b"RYSWKMBDHV", np.uint8)
# the reference's complement of raw bases (bseq.c seq_comp_table)
COMP = np.arange(256, dtype=np.uint8)
for _a, _b in zip(b"ACGTRYSWKMBDHVN", b"TGCAYRSWMKVHDBN"):
    COMP[_a], COMP[_a | 0x20] = _b, _b | 0x20


def _diverge(rng, codes, rate):
    out = codes.copy()
    hit = rng.random(len(out)) < rate
    out[hit] = (out[hit] + rng.integers(1, 4, int(hit.sum()))) % 4
    return out


def make_genome(rng, contigs: int, contig_len: int):
    """Contigs of 2-bit codes with the repeat structure of make_genome:
    8% LINE-like copies (a 6 kb family at 8-16% divergence), 5% SINE-like
    copies (300 bp, 5-20%), 40 microsatellites (units of 2-6 bp, 20-120
    copies) and 3 segmental duplications of 30 kb (2%) per contig."""
    line = rng.integers(0, 4, 6000, dtype=np.uint8)
    sine = rng.integers(0, 4, 300, dtype=np.uint8)
    out = []
    for c in range(contigs):
        g = rng.integers(0, 4, contig_len, dtype=np.uint8)
        for fam, share, lo, hi in ((line, 0.08, 0.08, 0.16),
                                   (sine, 0.05, 0.05, 0.20)):
            n = int(contig_len * share / len(fam))
            pos = rng.integers(0, contig_len - len(fam), n)
            rates = rng.uniform(lo, hi, n)
            # every copy diverges at its own rate
            hit = rng.random((n, len(fam))) < rates[:, None]
            copies = np.where(hit, (fam[None, :] + rng.integers(
                1, 4, (n, len(fam)), dtype=np.uint8)) % 4, fam[None, :])
            for p, cp in zip(pos, copies):
                g[p:p + len(fam)] = cp
        for _ in range(40):
            unit = rng.integers(0, 4, int(rng.integers(2, 7)), dtype=np.uint8)
            run = np.tile(unit, int(rng.integers(20, 120)))
            p = int(rng.integers(0, contig_len - len(run)))
            g[p:p + len(run)] = run
        for _ in range(3):
            L = 30_000
            src = int(rng.integers(0, contig_len - L))
            dst = int(rng.integers(0, contig_len - L))
            g[dst:dst + L] = _diverge(rng, g[src:src + L], 0.02)
        out.append((f"chr{c + 1}", BASES[g]))
    return out


def mask_genome(rng, genome, run=(100, 3000), end_gap=10_000,
                inner_gap=50_000, short_gaps=3, short_gap=100, iupac=8):
    """Soft-mask and gap each contig in place, as mask_genome does: runs of
    lengths drawn from `run`, lowercased and left alone in turn; N gaps of
    end_gap bases at both ends, one of inner_gap inside, short_gaps of
    short_gap bases; `iupac` IUPAC codes in the case of the base they
    replace. Returns {"lower", "n", "iupac"} shares and counts."""
    n_low = n_n = n_iu = total = 0
    for _name, a in genome:
        n = len(a)
        runs = rng.integers(*run, 2 * n // run[0] + 2)
        masked = (np.arange(len(runs)) + int(rng.integers(0, 2))) % 2
        low = np.repeat(masked.astype(bool), runs)[:n]
        a[low] |= 0x20
        end = min(end_gap, n // 8)
        inner = min(inner_gap, n // 8)
        spans = [(0, end), (n - end, n)]
        p = int(rng.integers(n // 4, max(n // 4 + 1, 3 * n // 4 - inner)))
        spans.append((p, p + inner))
        for _ in range(short_gaps):
            p = int(rng.integers(end, max(end + 1, n - end - short_gap)))
            spans.append((p, p + min(short_gap, n - end - p)))
        for st, en in spans:
            a[st:en] = ord("N")
        pos = rng.integers(end, max(end + 1, n - end), iupac)
        pos = np.unique(pos[a[pos] != ord("N")])
        a[pos] = IUPAC[rng.integers(0, len(IUPAC), len(pos))] | (a[pos] & 0x20)
        n_low += int(((a >= ord("a")) & (a != ord("n"))).sum())
        n_n += int((a == ord("N")).sum())
        n_iu += len(pos)
        total += n
    return dict(lower=n_low / max(total, 1), n=n_n, iupac=n_iu)


def lognormal_set(n: int, spec: dict) -> np.ndarray:
    """n whole numbers of a log-normal distribution given by its "median" and
    "mean" (or "sigma"), clipped to ["min", "max"]: its quantiles at
    (i + 0.5) / n, so that every seed gets the same set, in its own order."""
    sigma = spec.get("sigma")
    if sigma is None:
        sigma = float(np.sqrt(2 * np.log(spec["mean"] / spec["median"])))
    z = NormalDist()
    q = [spec["median"] * np.exp(sigma * z.inv_cdf((i + 0.5) / n))
         for i in range(n)]
    return np.clip(np.rint(q), spec["min"], spec["max"]).astype(np.int64)


def patch_loci(rng, genome, genes: int, exons: dict, exon_len: dict,
               intron_len: dict, tries: int = 50):
    """Gene loci patched into the genome in place, as _write_spliced does:
    gene g on contig g mod len(genome), in its own slot of the contig, with
    GT..AG at the edges of every intron. The exon counts, exon lengths and
    intron lengths are `lognormal_set`s of the three specs, in an order drawn
    from the seed; a gene whose span would not fit its slot has its introns
    shortened in proportion. A locus is placed where it holds no N (up to
    `tries` draws in its slot). Returns each gene's (contig index,
    [(start, end) of each exon])."""
    per = -(-genes // len(genome))
    n_ex = rng.permutation(lognormal_set(genes, exons))
    exl_all = rng.permutation(lognormal_set(int(n_ex.sum()), exon_len))
    inl_all = rng.permutation(lognormal_set(int(n_ex.sum()) - genes,
                                            intron_len))
    e_at = np.concatenate([[0], np.cumsum(n_ex)])
    i_at = np.concatenate([[0], np.cumsum(n_ex - 1)])
    loci = []
    for g in range(genes):
        ci = g % len(genome)
        seq = genome[ci][1]
        slot = len(seq) // per
        exl = exl_all[e_at[g]:e_at[g + 1]]
        inl = inl_all[i_at[g]:i_at[g + 1]]
        room = slot * 3 // 4 - int(exl.sum())
        if inl.sum() > room:
            inl = np.maximum(inl * room // inl.sum(), 4)
        span = int(exl.sum() + inl.sum())
        base = (g // len(genome)) * slot
        for _ in range(tries):
            pos = base + int(rng.integers(0, slot - span))
            if not ((seq[pos:pos + span] | 0x20) == ord("n")).any():
                break
        ex = []
        for i in range(len(exl)):
            ex.append((pos, pos + int(exl[i])))
            pos += int(exl[i])
            if i < len(exl) - 1:
                il = int(inl[i])
                seq[pos:pos + 2] = np.frombuffer(b"GT", np.uint8)
                seq[pos + il - 2:pos + il] = np.frombuffer(b"AG", np.uint8)
                pos += il
        loci.append((ci, ex))
    return loci


def mutate(rng, src: np.ndarray, lens: np.ndarray, err: float, sub: float,
           dele: float):
    """Errors at rate `err` over the reads laid end to end in `src` (ASCII),
    `lens` bases each: a share `sub` of them substitutions, `dele`
    deletions, the rest insertions of a random base after the base (the
    _mutate model). Returns (bases, new lengths)."""
    r = rng.random(len(src))
    is_sub = r < err * sub
    is_del = (r >= err * sub) & (r < err * (sub + dele))
    is_ins = (r >= err * (sub + dele)) & (r < err)
    out = src.copy()
    out[is_sub] = BASES[rng.integers(0, 4, int(is_sub.sum()))]
    rep = np.where(is_ins, 2, 1) * ~is_del
    res = np.repeat(out, rep)
    ins_at = np.cumsum(rep)[is_ins] - 1
    res[ins_at] = BASES[rng.integers(0, 4, len(ins_at))]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]])
    new = np.add.reduceat(rep, starts) if len(lens) else np.empty(0, int)
    new[lens == 0] = 0
    return res, new.astype(np.int64)


NT4 = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    NT4[_c] = NT4[_c | 0x20] = _i


def substitute(rng, seqs: np.ndarray, rate: float) -> np.ndarray:
    """Each base replaced at `rate` by one of the other three of ACGT, in its
    case (by any of the four where it is N or an IUPAC code): wgsim's
    sequencing error and its substitution mutation."""
    out = seqs.copy()
    hit = np.flatnonzero(rng.random(len(out)) < rate)
    code = NT4[out[hit]]
    step = rng.integers(1, 4, len(hit))
    new = np.where(code < 4, (code + step) % 4, step)
    out[hit] = BASES[new] | (out[hit] & 0x20)
    return out


def indels(rng, seq: np.ndarray, rate: float, extend: float) -> np.ndarray:
    """wgsim's indel mutations in one sequence: at `rate` a base, an
    insertion after it or a deletion from it, each as likely, of length 1
    plus a geometric number of extensions at `extend`."""
    at = np.flatnonzero(rng.random(len(seq)) < rate)
    if not len(at):
        return seq
    parts, prev = [], 0
    for p in at.tolist():
        if p < prev:
            continue
        n = 1
        while rng.random() < extend:
            n += 1
        parts.append(seq[prev:p + 1])
        if rng.random() < 0.5:
            parts.append(BASES[rng.integers(0, 4, n)])
            prev = p + 1
        else:
            prev = p + 1 + n
    parts.append(seq[prev:])
    return np.concatenate(parts)


def reverse_complement(seqs: np.ndarray, lens: np.ndarray, minus) -> np.ndarray:
    """The reads laid end to end in `seqs` (`lens` bases each), those with
    `minus` set reverse complemented."""
    n = len(seqs)
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    owner = np.repeat(np.arange(len(lens)), lens)
    i = np.arange(n, dtype=np.int64)
    flip = np.asarray(minus, bool)[owner]
    j = np.where(flip, 2 * starts[owner] + lens[owner] - 1 - i, i)
    out = seqs[j]
    out[flip] = COMP[out[flip]]
    return out


def slices(genome, contig: np.ndarray, start: np.ndarray, lens: np.ndarray):
    """The genome's bases [start, start + len) of each contig index, laid
    end to end."""
    flat = np.concatenate([a for _n, a in genome])
    offs = np.concatenate([[0], np.cumsum([len(a) for _n, a in genome])])
    first = offs[contig] + start
    owner = np.repeat(np.arange(len(lens)), lens)
    within = np.arange(int(lens.sum())) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    return flat[first[owner] + within]


def fasta_bytes(genome, width: int = 80) -> bytes:
    """The genome as FASTA, `width` bases a line."""
    parts = []
    for name, a in genome:
        n = len(a)
        full = n - n % width
        body = np.empty((full // width, width + 1), np.uint8)
        body[:, :width] = a[:full].reshape(-1, width)
        body[:, width] = ord("\n")
        parts.append(b">" + name.encode() + b"\n" + body.tobytes())
        if n % width:
            parts.append(a[full:].tobytes() + b"\n")
    return b"".join(parts)


def records(names, seqs: np.ndarray, lens: np.ndarray, fastq: bool) -> bytes:
    """FASTA (or FASTQ at quality I) records of the reads laid end to end."""
    out = []
    off = 0
    for name, n in zip(names, lens.tolist()):
        s = seqs[off:off + n].tobytes()
        off += n
        if fastq:
            out.append(b"@%s\n%s\n+\n%s\n" % (name.encode(), s, b"I" * n))
        else:
            out.append(b">%s\n%s\n" % (name.encode(), s))
    return b"".join(out)


def build(rng, recipe: dict):
    """The genome a configuration states: {"contigs", "contig_len",
    "mask": bool, "loci": {genes, exons, exon_len, intron_len} or absent,
    the last three `lognormal_set` specs}.
    Returns (genome, loci or None)."""
    genome = make_genome(rng, recipe["contigs"], recipe["contig_len"])
    if recipe.get("mask"):
        mask_genome(rng, genome)
    loci = None
    if recipe.get("loci"):
        lc = recipe["loci"]
        loci = patch_loci(rng, genome, lc["genes"], lc["exons"],
                          lc["exon_len"], lc["intron_len"])
    return genome, loci
