"""mappy-compatible Python API (reference python/mappy.pyx).

The fork broke the synchronous single-read C API (`mm_map` asserts on
read_id/params, SURVEY.md §3.5); this restores the clean library surface:

    import minimap2_chaindp_tpu_torch.mappy as mp
    a = mp.Aligner("ref.fa", preset="map-ont")
    for hit in a.map("ACGT..."):
        print(hit.ctg, hit.r_st, hit.r_en, hit.cigar_str)
"""
from __future__ import annotations

from dataclasses import dataclass

from . import constants as C
from .options import IndexOptions, MapOptions, set_opt
from .io.fastx import SeqRecord, read_fastx
from .index.build import build_index
from .index.serialize import is_mm2tpu_index, load_index
from .models.pipeline import map_frag


@dataclass
class Alignment:
    """One hit (reference mappy.pyx:8-88)."""
    ctg: str
    ctg_len: int
    r_st: int
    r_en: int
    strand: int
    q_st: int
    q_en: int
    mapq: int
    cigar: list[tuple[int, int]]  # (len, op)
    is_primary: bool
    mlen: int
    blen: int
    NM: int
    trans_strand: int
    read_num: int = 1
    cs: str = ""
    MD: str = ""

    @property
    def cigar_str(self) -> str:
        return "".join(f"{l}{C.CIGAR_STR[op]}" for l, op in self.cigar)

    def __str__(self) -> str:
        return "\t".join(map(str, [
            self.q_st, self.q_en, "+" if self.strand > 0 else "-", self.ctg,
            self.ctg_len, self.r_st, self.r_en, self.mlen, self.blen,
            self.mapq, f"tp:A:{'P' if self.is_primary else 'S'}",
            "ts:A:" + ("+" if self.trans_strand > 0
                       else "-" if self.trans_strand < 0 else "."),
            "cg:Z:" + self.cigar_str]))


class Aligner:
    """Index + mapper (reference mappy.pyx:90-170)."""

    def __init__(self, fn_idx_in: str | None = None, preset: str | None = None,
                 k: int | None = None, w: int | None = None,
                 min_cnt: int | None = None, min_chain_score: int | None = None,
                 min_dp_score: int | None = None, bw: int | None = None,
                 best_n: int | None = None, n_threads: int = 3,
                 fn_idx_out: str | None = None, max_frag_len: int | None = None,
                 extra_flags: int = 0, seq: str | None = None,
                 scoring: tuple | None = None):
        io, mo = set_opt(preset)
        mo.flag |= C.MM_F_CIGAR | extra_flags
        if k is not None:
            io.k = k
        if w is not None:
            io.w = w
        if min_cnt is not None:
            mo.min_cnt = min_cnt
        if min_chain_score is not None:
            mo.min_chain_score = min_chain_score
        if min_dp_score is not None:
            mo.min_dp_max = min_dp_score
        if bw is not None:
            mo.bw = bw
        if best_n is not None:
            mo.best_n = best_n
        if max_frag_len is not None:
            mo.max_frag_len = max_frag_len
        if scoring is not None:
            mo.a, mo.b, mo.q, mo.e = scoring[:4]
            if len(scoring) >= 6:
                mo.q2, mo.e2 = scoring[4:6]
            if len(scoring) >= 7:
                # v2.10 has no sc_ambi (ksw_gen_simple_mat(m,mat,a,b),
                # align.c:9 hardcodes the ambiguous score) — accepting and
                # ignoring it would silently mis-score N bases
                raise NotImplementedError(
                    "sc_ambi (scoring[6]) is not supported by minimap2 "
                    "v2.10 semantics")
        self.idx_opt, self.map_opt = io, mo
        if seq is not None:
            self._mi = build_index(["N/A"], [seq], io.w, io.k, io.flag,
                                   io.bucket_bits)
        elif fn_idx_in is not None:
            from .index.serialize import is_mmi_index, load_mmi_parts
            if is_mm2tpu_index(fn_idx_in):
                self._mi = load_index(fn_idx_in)
            elif is_mmi_index(fn_idx_in):
                # stock minimap2 .mmi (single-part, like mappy.pyx:103)
                self._mi = next(load_mmi_parts(fn_idx_in))
            else:
                refs = list(read_fastx(fn_idx_in))
                self._mi = build_index([r.name for r in refs],
                                       [r.seq for r in refs],
                                       io.w, io.k, io.flag, io.bucket_bits)
        else:
            raise ValueError("provide fn_idx_in or seq")
        mo.update(self._mi)
        if fn_idx_out:
            from .index.serialize import dump_index_auto
            dump_index_auto(self._mi, fn_idx_out)

    def __bool__(self) -> bool:
        return self._mi is not None

    @property
    def k(self) -> int:
        return self._mi.k

    @property
    def w(self) -> int:
        return self._mi.w

    @property
    def n_seq(self) -> int:
        return self._mi.n_seq

    @property
    def seq_names(self) -> list[str]:
        return [s.name for s in self._mi.seqs]

    def seq(self, name: str, start: int = 0, end: int = 0x7FFFFFFF) -> str | None:
        """Fetch [start, end) of a contig (reference mappy_fetch_seq,
        cmappy.h:115): None for unknown names, start past the contig or an
        empty range; end is clamped. Negative start (reference UB — it
        would read the preceding contig's bytes) also returns None."""
        rid = self._mi.name2id(name)
        if rid < 0:
            return None
        ln = self._mi.seqs[rid].length
        if start < 0 or start >= ln or start >= end:
            return None
        codes = self._mi.getseq(rid, start, min(end, ln))
        return "".join("ACGTN"[c] for c in codes)

    def map(self, seq: str, seq2: str | None = None, name: str = "",
            cs: bool = False, MD: bool = False):
        """Map one read (or read pair); yields Alignment hits.

        The default empty name matches reference mappy's qname=NULL (zero
        x31 contribution to the per-read tie-break hash, map.c:345); pass
        a name to reproduce named-read CLI hashing. seq2 follows
        mm_map_aux (cmappy.h:74): it is reverse-complemented, the pair
        maps as ONE 2-segment fragment, and seg-1 hits get their rev flag
        flipped back — q_st/q_en stay on the revcomped read, exactly like
        the reference API."""
        segs = [SeqRecord(name, seq)]
        work2 = None
        if seq2 is not None:
            work2 = C.revcomp_str(seq2)
            segs.append(SeqRecord(name, work2))
        regss = map_frag(self._mi, self.map_opt, segs)
        for read_num, regs in enumerate(regss, 1):
            qseq = seq if read_num == 1 else work2
            for r in regs:
                if r.p is None:
                    continue
                cigar = [(c >> 4, c & 0xF) for c in r.p.cigar]
                cs_str = md_str = ""
                # tags describe the alignment of the (revcomped) work
                # sequence and must use the pre-flip rev flag
                if cs:
                    from .io.output import _write_cs
                    cs_str = _write_cs(self._mi, qseq, r, False)[len("\tcs:Z:"):]
                if MD:
                    from .io.output import _write_md
                    md_str = _write_md(self._mi, qseq, r)[len("\tMD:Z:"):]
                if read_num == 2:
                    # mm_map_aux flips ONLY rev on the second segment's
                    # hits (cmappy.h:94-95); q_st/q_en stay as computed
                    r.rev = 1 - r.rev
                yield Alignment(
                    ctg=self._mi.seqs[r.rid].name,
                    ctg_len=self._mi.seqs[r.rid].length,
                    r_st=r.rs, r_en=r.re,
                    strand=-1 if r.rev else 1,
                    q_st=r.qs, q_en=r.qe, mapq=r.mapq, cigar=cigar,
                    is_primary=(r.id == r.parent),
                    mlen=r.mlen, blen=r.blen,
                    NM=r.blen - r.mlen + r.p.n_ambi,
                    trans_strand=(1 if r.p.trans_strand == 1
                                  else -1 if r.p.trans_strand == 2 else 0),
                    read_num=read_num, cs=cs_str, MD=md_str)


def fastx_read(fn: str, read_comment: bool = False):
    """Yield (name, seq, qual[, comment]) like mappy.fastx_read."""
    for rec in read_fastx(fn):
        if read_comment:
            yield rec.name, rec.seq, rec.qual, rec.comment
        else:
            yield rec.name, rec.seq, rec.qual


def revcomp(seq: str) -> str:
    return C.revcomp_str(seq)
