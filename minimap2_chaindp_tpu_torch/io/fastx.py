"""FASTA/FASTQ reading (gzip-transparent) and batch staging.

Mirrors the behavior of the reference's bseq.c/kseq.h layer: U->T conversion
(bseq.c:70-72), batching by base count (bseq.c:78-123), fragment grouping by
query-name pairing for paired-end mode (bseq.c:98-107), and round-robin
interleave of multiple files (mm_bseq_read_frag2, bseq.c:124).
"""
from __future__ import annotations

import gzip
import io as _io
from dataclasses import dataclass, field
from typing import Iterator, Sequence


@dataclass
class SeqRecord:
    name: str
    seq: str
    qual: str | None = None
    comment: str | None = None
    rid: int = -1


def _open_maybe_gzip(path: str):
    if path == "-":
        # stdin ("-", like the reference's gzdopen(0) path, bseq.c:38):
        # stdin is not seekable and peek() may return <2 bytes on a slow
        # pipe, so READ the magic (blocking until 2 bytes or EOF) and
        # replay it in front of the stream
        import sys
        f = _io.BufferedReader(sys.stdin.buffer.raw
                               if hasattr(sys.stdin.buffer, "raw")
                               else sys.stdin.buffer)
        magic = f.read(2)

        class _Replay(_io.RawIOBase):
            def __init__(self, head, base):
                self._head, self._base = head, base

            def readable(self):
                return True

            def readinto(self, b):
                if self._head:
                    n = min(len(b), len(self._head))
                    b[:n] = self._head[:n]
                    self._head = self._head[n:]
                    return n
                data = self._base.read(len(b))
                b[:len(data)] = data
                return len(data)

        f2 = _io.BufferedReader(_Replay(magic, f))
        if magic == b"\x1f\x8b":
            return _io.TextIOWrapper(gzip.GzipFile(fileobj=f2))
        return _io.TextIOWrapper(f2)
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return _io.TextIOWrapper(gzip.GzipFile(fileobj=f))
    return _io.TextIOWrapper(f)


def read_fastx(path: str) -> Iterator[SeqRecord]:
    """Parse FASTA or FASTQ (auto-detected), converting U/u to T/t like
    bseq.c:70-72. Uses the native (C++) reader when available."""
    from . import native_fastx
    if path != "-" and native_fastx.available():
        for name, seq, qual, comment in native_fastx.read_fastx_native(path):
            yield SeqRecord(name, seq, qual, comment)
        return
    yield from _read_fastx_py(path)


def _read_fastx_py(path: str) -> Iterator[SeqRecord]:
    """kseq-equivalent fallback parser (kseq.h:180-223): record
    delimiters ('>'/'@') and the FASTQ '+' separator count only at line
    starts, sequences may wrap over multiple lines in BOTH formats, CRLF
    is stripped, and a quality whose length mismatches its sequence ends
    the stream (kseq's -2, which the reference treats as end-of-input)."""
    with _open_maybe_gzip(path) as fh:
        pending = fh.readline()
        while pending:
            line = pending.rstrip("\r\n")
            pending = None
            if not line or line[0] not in ">@":
                pending = fh.readline()     # skip junk before a record
                continue
            fields = line[1:].split(None, 1)
            name = fields[0] if fields else ""
            comment = fields[1] if len(fields) > 1 else None
            seq_parts: list[str] = []
            have_plus = False
            while True:
                nxt = fh.readline()
                if not nxt:
                    break
                t = nxt.rstrip("\r\n")
                if not t:
                    continue
                if t[0] in ">@":
                    pending = nxt           # next record, no qual
                    break
                if t[0] == "+":
                    have_plus = True
                    break
                seq_parts.append(t)
            seq = _fix_seq("".join(seq_parts))
            if not have_plus:
                yield SeqRecord(name, seq, None, comment)
                if pending is None and not nxt:
                    return
                if pending is None:
                    pending = fh.readline()
                continue
            qual_parts: list[str] = []
            got = 0
            while got < len(seq):
                ql = fh.readline()
                if not ql:
                    break
                qt = ql.rstrip("\r\n")
                qual_parts.append(qt)
                got += len(qt)
            if got != len(seq):
                return                      # malformed: stop like kseq -2
            yield SeqRecord(name, seq, "".join(qual_parts), comment)
            pending = fh.readline()


def _fix_seq(s: str) -> str:
    if "U" in s or "u" in s:
        s = s.replace("U", "T").replace("u", "t")
    return s


def strip_pair_suffix(name: str) -> str:
    """Drop a trailing /<digit> read-pair suffix (reference mm_qname_len,
    bseq.h:31-36: '/' followed by ANY digit, on names of length >= 3)."""
    if len(name) >= 3 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


def qname_same(a: str, b: str) -> bool:
    return strip_pair_suffix(a) == strip_pair_suffix(b)


@dataclass
class Frag:
    """A fragment: 1 read (single-end) or N paired segments kept together."""
    segs: list[SeqRecord]


def read_frags(paths: Sequence[str], batch_bases: int, frag_mode: bool) -> Iterator[list[Frag]]:
    """Yield batches of fragments totalling ~batch_bases bases.

    Multiple files are interleaved record-by-record (PE convention,
    reference bseq.c:124 mm_bseq_read_frag2). In frag mode, consecutive records
    with the same base name within one file form one fragment (bseq.c:98-107).
    """
    iters = [read_fastx(p) for p in paths]
    if len(iters) > 1:
        def interleave():
            # reference mm_bseq_read_frag2 (bseq.c:131-140): stop as soon
            # as ANY file hits EOF; extra records in longer files are
            # SKIPPED with a warning, never mapped single-end
            while True:
                recs = []
                for it in iters:
                    r = next(it, None)
                    if r is not None:
                        recs.append(r)
                if len(recs) < len(iters):
                    if recs:
                        import sys
                        print("[W::read_frags] query files have different "
                              "number of records; extra records skipped.",
                              file=sys.stderr)
                    return
                yield Frag(recs)
        stream: Iterator[Frag] = interleave()
    elif frag_mode:
        def group():
            prev: list[SeqRecord] = []
            for r in iters[0]:
                if prev and not qname_same(prev[-1].name, r.name):
                    yield Frag(prev)
                    prev = []
                prev.append(r)
            if prev:
                yield Frag(prev)
        stream = group()
    else:
        stream = (Frag([r]) for r in iters[0])

    batch: list[Frag] = []
    nb = 0
    for frag in stream:
        batch.append(frag)
        nb += sum(len(s.seq) for s in frag.segs)
        if nb >= batch_bases:
            yield batch
            batch, nb = [], 0
    if batch:
        yield batch
