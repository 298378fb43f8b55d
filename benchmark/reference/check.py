"""The plain reference that decides a run's `correct`, in a process of its own.

    python3 -m benchmark.reference.check JOB.json OUT.json

JOB names the genome FASTA the run wrote (the raw file both sides read), the
preset and flags of the configuration, and the sampled fragments, each a list
of segments {name, seq, qual}. The reference builds its own minimizer index of
the genome (index/build.py: every key counted, for the occurrence cut-off
`mid_occ`; the occurrences kept for the keys the sample's reads carry, the only
ones their mapping looks up), then maps every fragment with the frozen host
model (models/pipeline.map_fragment_output, numpy and Python only) and writes
{"lines": [[SAM line, ...] per fragment], "seconds": {...}} to OUT. With
"control": true in JOB it maps the sample a second time with the DP's score
differences held in int4 (ops/ksw2.DIFF_BITS) and adds "control_lines".

It imports nothing of the program and loads no native library. Its workers are
forked (the index and genome are shared with them copy-on-write); the process
starts no thread before it forks.
"""
from __future__ import annotations

import json
import multiprocessing as mp
import sys
import time

import numpy as np

from . import constants as C
from .index.build import MinimizerIndex, RefSeq, max_occ, sketch_contigs
from .io.fastx import SeqRecord
from .models.pipeline import map_fragment_output
from .ops import ksw2
from .ops.seeds import collect_minimizers
from .options import set_opt

FLAGS = {"-a": C.MM_F_OUT_SAM | C.MM_F_CIGAR}

# what the forked workers read
_G: dict = {}


def read_genome(path: str):
    """(names, nt4 code arrays) of a FASTA file."""
    with open(path, "rb") as fh:
        data = fh.read()
    names, contigs = [], []
    for rec in data.split(b">")[1:]:
        head, _, body = rec.partition(b"\n")
        names.append(head.split()[0].decode())
        seq = np.frombuffer(body.replace(b"\n", b""), np.uint8)
        contigs.append(C.SEQ_NT4_TABLE[seq])
    return names, contigs


def options(preset: str, flags: list[str]):
    io, mo = set_opt(preset)
    for f in flags:
        if f not in FLAGS:
            raise ValueError(f"flag {f!r} is not modelled")
        mo.flag |= FLAGS[f]
    return io, mo


def _sketch_part(rng_):
    lo, hi = rng_
    io, qkeys = _G["io"], _G["qkeys"]
    x, _y = sketch_contigs(_G["contigs"][lo:hi], io.w, io.k, rid0=lo)
    key = x >> np.uint64(8)
    keep = np.isin(key, qkeys)
    return key, key[keep], _y[keep]


def _parts(contigs, n):
    """Contiguous rid ranges of about equal length, at most n."""
    tot = sum(len(c) for c in contigs)
    cuts, acc = [0], 0
    for i, c in enumerate(contigs):
        acc += len(c)
        if acc >= tot * len(cuts) / n and i + 1 < len(contigs):
            cuts.append(i + 1)
    cuts.append(len(contigs))
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def sample_index(pool, names, contigs, io, qkeys) -> tuple:
    """(MinimizerIndex holding the occurrences of `qkeys`, the counts of
    every key of the genome)."""
    parts = pool.map(_sketch_part, _parts(contigs, _G["workers"] * 2))
    allk = np.concatenate([p[0] for p in parts])
    allk.sort()
    if len(allk):
        edge = np.flatnonzero(allk[1:] != allk[:-1]) + 1
        counts = np.diff(np.concatenate([[0], edge, [len(allk)]]))
    else:
        counts = np.empty(0, np.int64)
    skey = np.concatenate([p[1] for p in parts])
    sval = np.concatenate([p[2] for p in parts])
    order = np.lexsort((sval, skey))
    skey, sval = skey[order], sval[order]
    mi = MinimizerIndex(k=io.k, w=io.w, flag=io.flag, b=io.bucket_bits)
    off = 0
    for name, c in zip(names, contigs):
        mi.seqs.append(RefSeq(name=name, offset=off, length=len(c)))
        off += len(c)
    mi.S = np.concatenate(contigs)
    if len(skey):
        neq = np.empty(len(skey), bool)
        neq[0] = True
        np.not_equal(skey[1:], skey[:-1], out=neq[1:])
        st = np.flatnonzero(neq)
        mi.keys = skey[st]
        mi.starts = np.concatenate([st, [len(sval)]]).astype(np.int64)
        mi.values = sval
    srt = sorted(range(len(names)), key=lambda i: names[i])
    mi.sorted_names = [names[i] for i in srt]
    mi.name_rank = np.empty(len(names), np.int64)
    mi.name_rank[np.asarray(srt, np.int64)] = np.arange(len(names))
    return mi, counts


def _map_one(arg):
    i, bits = arg
    ksw2.DIFF_BITS = bits
    segs = [SeqRecord(s["name"], s["seq"], s.get("qual")) for s in
            _G["frags"][i]]
    return i, map_fragment_output(_G["mi"], _G["mo"], segs)


def map_all(pool, n: int, bits: int) -> list:
    order = sorted(range(n), key=lambda i: -sum(len(s["seq"]) for s in
                                                _G["frags"][i]))
    out = [None] * n
    for i, lines in pool.imap_unordered(_map_one,
                                      [(i, bits) for i in order]):
        out[i] = lines
    return out


def run(job: dict) -> dict:
    t0 = time.perf_counter()
    secs = {}
    names, contigs = read_genome(job["genome"])
    io, mo = options(job["preset"], job.get("flags", []))
    frags = job["frags"]
    q = MinimizerIndex(k=io.k, w=io.w, flag=io.flag)
    # both strands of every segment: a mate is mapped reverse complemented
    qk = [collect_minimizers(mo, q, [seq]) for fr in frags for s in fr
          for seq in (s["seq"], C.revcomp_str(s["seq"]))]
    qkeys = np.unique(np.concatenate(
        [m[:, 0] >> np.uint64(8) for m in qk if len(m)] or
        [np.empty(0, np.uint64)]))
    secs["read"] = time.perf_counter() - t0
    workers = max(1, int(job.get("workers", 8)))
    _G.update(io=io, contigs=contigs, qkeys=qkeys, workers=workers)
    ctx = mp.get_context("fork")
    with ctx.Pool(workers) as pool:
        t = time.perf_counter()
        mi, counts = sample_index(pool, names, contigs, io, qkeys)
        if mo.mid_occ <= 0:
            mo.mid_occ = max_occ(counts, mo.mid_occ_frac)
        mo.update(mi)
        secs["index"] = time.perf_counter() - t
        pool.close()
        pool.join()
    _G.update(mi=mi, mo=mo, frags=frags, contigs=None)
    out = {"mid_occ": int(mo.mid_occ), "keys": int(len(counts))}
    with ctx.Pool(workers) as pool:
        t = time.perf_counter()
        out["lines"] = map_all(pool, len(frags), 8)
        secs["map"] = time.perf_counter() - t
        if job.get("control"):
            t = time.perf_counter()
            out["control_lines"] = map_all(pool, len(frags), 4)
            secs["control"] = time.perf_counter() - t
        pool.close()
        pool.join()
    secs["all"] = time.perf_counter() - t0
    out["seconds"] = secs
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print("usage: python3 -m benchmark.reference.check JOB.json OUT.json",
              file=sys.stderr)
        return 2
    with open(argv[0]) as fh:
        job = json.load(fh)
    out = run(job)
    with open(argv[1], "w") as fh:
        json.dump(out, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
