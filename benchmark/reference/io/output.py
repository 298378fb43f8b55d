# Frozen copy of minimap2_chaindp_tpu/io/output.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/io/output.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""SAM/PAF output formatting (reference format.c, byte-exact)."""
from __future__ import annotations

import numpy as np

from .. import constants as C
from ..hits import Region

NT_UPPER = "ACGTN"
NT_LOWER = "acgtn"


def _mm_escape(s: str) -> str:
    """Reference mm_escape (format.c:68-79): backslash-t becomes a tab,
    double backslash a backslash, any other escaped char is dropped."""
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\":
            if i + 1 < len(s):
                n = s[i + 1]
                if n == "t":
                    out.append("\t")
                elif n == "\\":
                    out.append("\\")
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _rg_line_and_id(rg: str | None) -> tuple[str | None, str]:
    """Reference sam_write_rg_line (format.c:82-113): validate the -R
    argument and return (header_line | None, rg_id). On any validation
    error the line is OMITTED from the header (with the reference's
    [ERROR] message) and the ID is empty."""
    import sys
    if not rg:
        return None, ""
    if not rg.startswith("@RG"):
        print("[ERROR] the read group line is not started with @RG",
              file=sys.stderr)
        return None, ""
    if "\t" in rg:
        print("[ERROR] the read group line contained literal <tab> "
              "characters -- replace with escaped tabs: \\t",
              file=sys.stderr)
        return None, ""
    line = _mm_escape(rg)
    i = line.find("\tID:")
    if i < 0:
        print("[ERROR] no ID within the read group line", file=sys.stderr)
        return None, ""
    j = i + 4
    k = j
    while k < len(line) and line[k] not in "\t\n":
        k += 1
    if k - j + 1 > 256:
        print("[ERROR] @RG:ID is longer than 255 characters",
              file=sys.stderr)
        return None, ""
    return line, line[j:k]


def write_sam_hdr(mi, rg: str | None, ver: str, cmdline: str | None) -> str:
    """mi=None omits the @SQ lines (multi-part index, reference main.c:228)."""
    lines = []
    for s in (mi.seqs if mi is not None else []):
        lines.append(f"@SQ\tSN:{s.name}\tLN:{s.length}")
    rg_line, _ = _rg_line_and_id(rg)
    if rg_line is not None:
        lines.append(rg_line)
    pg = f"@PG\tID:minimap2\tPN:minimap2\tVN:{ver}"
    if cmdline:
        pg += f"\tCL:{cmdline}"
    lines.append(pg)
    return "\n".join(lines)


def parse_rg_id(rg: str | None) -> str:
    return _rg_line_and_id(rg)[1]


def _cigar_str(cigar: list[int]) -> str:
    if len(cigar) > 8:
        from ..nonative import cigar_str_native
        s = cigar_str_native(cigar)
        if s is not None:
            return s
    return "".join(f"{c >> 4}{'MIDN'[c & 0xF]}" for c in cigar)


def _write_tags(r: Region) -> str:
    s = []
    if r.id == r.parent:
        type_ = "I" if r.inv else "P"
    else:
        type_ = "i" if r.inv else "S"
    if r.p is not None:
        s.append(f"\tNM:i:{r.blen - r.mlen + r.p.n_ambi}\tms:i:{r.p.dp_max}"
                 f"\tAS:i:{r.p.dp_score}\tnn:i:{r.p.n_ambi}")
        if r.p.trans_strand in (1, 2):
            s.append(f"\tts:A:{'?+-?'[r.p.trans_strand]}")
    s.append(f"\ttp:A:{type_}\tcm:i:{r.cnt}\ts1:i:{r.score}")
    if r.parent == r.id:
        s.append(f"\ts2:i:{r.subsc}")
    if 0.0 <= r.div <= 1.0:
        s.append("\tdv:f:0" if r.div == 0.0 else f"\tdv:f:{r.div:.4f}")
    if r.split:
        s.append(f"\tzd:i:{r.split}")
    return "".join(s)


def _get_align_seqs(mi, seq: str, r: Region):
    tseq = mi.getseq(r.rid, r.rs, r.re)
    q = C.seq_to_nt4(seq[r.qs:r.qe])
    if r.rev:
        q = np.where(q >= 4, np.uint8(4), (3 - q).astype(np.uint8))[::-1]
    return tseq, q


def _write_cs(mi, seq: str, r: Region, long_form: bool) -> str:
    tseq, qseq = _get_align_seqs(mi, seq, r)
    out = ["\tcs:Z:"]
    q_off = t_off = 0
    for c in r.p.cigar:
        op, length = c & 0xF, c >> 4
        if op == 0:
            l_tmp = 0
            buf = []
            for j in range(length):
                if qseq[q_off + j] != tseq[t_off + j]:
                    if l_tmp > 0:
                        out.append("=" + "".join(buf) if long_form else f":{l_tmp}")
                        l_tmp = 0
                        buf = []
                    out.append(f"*{NT_LOWER[tseq[t_off + j]]}{NT_LOWER[qseq[q_off + j]]}")
                else:
                    buf.append(NT_UPPER[qseq[q_off + j]])
                    l_tmp += 1
            if l_tmp > 0:
                out.append("=" + "".join(buf) if long_form else f":{l_tmp}")
            q_off += length
            t_off += length
        elif op == 1:
            out.append("+" + "".join(NT_LOWER[qseq[q_off + j]] for j in range(length)))
            q_off += length
        elif op == 2:
            out.append("-" + "".join(NT_LOWER[tseq[t_off + j]] for j in range(length)))
            t_off += length
        else:
            out.append(f"~{NT_LOWER[tseq[t_off]]}{NT_LOWER[tseq[t_off + 1]]}{length}"
                       f"{NT_LOWER[tseq[t_off + length - 2]]}{NT_LOWER[tseq[t_off + length - 1]]}")
            t_off += length
    return "".join(out)


def _write_md(mi, seq: str, r: Region) -> str:
    tseq, qseq = _get_align_seqs(mi, seq, r)
    out = ["\tMD:Z:"]
    l_md = 0
    q_off = t_off = 0
    for c in r.p.cigar:
        op, length = c & 0xF, c >> 4
        if op == 0:
            for j in range(length):
                if qseq[q_off + j] != tseq[t_off + j]:
                    out.append(f"{l_md}{NT_UPPER[tseq[t_off + j]]}")
                    l_md = 0
                else:
                    l_md += 1
            q_off += length
            t_off += length
        elif op == 1:
            q_off += length
        elif op == 2:
            out.append(f"{l_md}^" + "".join(NT_UPPER[tseq[t_off + j]] for j in range(length)))
            l_md = 0
            t_off += length
        elif op == 3:
            # intron: MD has no N concept — skip the reference span
            # WITHOUT emitting (the reference cannot reach here: its
            # write_MD asserts op <= 2, format.c:190; a stale t_off
            # would otherwise corrupt every later MD run)
            t_off += length
    if l_md > 0:
        out.append(str(l_md))
    return "".join(out)


def write_paf(mi, rec, r: Region, opt_flag: int) -> str:
    name = mi.seqs[r.rid].name
    s = [f"{rec.name}\t{len(rec.seq)}\t{r.qs}\t{r.qe}\t{'+-'[r.rev]}\t"
         f"{name}\t{mi.seqs[r.rid].length}\t{r.rs}\t{r.re}"
         f"\t{r.mlen}\t{r.blen}\t{r.mapq}"]
    s.append(_write_tags(r))
    if r.p is not None and (opt_flag & C.MM_F_OUT_CG):
        s.append("\tcg:Z:" + _cigar_str(r.p.cigar))
    if r.p is not None and (opt_flag & (C.MM_F_OUT_CS | C.MM_F_OUT_MD)):
        if opt_flag & C.MM_F_OUT_MD:
            s.append(_write_md(mi, rec.seq, r))
        else:
            s.append(_write_cs(mi, rec.seq, r, bool(opt_flag & C.MM_F_OUT_CS_LONG)))
    if (opt_flag & C.MM_F_COPY_COMMENT) and rec.comment:
        s.append("\t" + rec.comment)
    return "".join(s)


def _sam_seq(seq: str, rev: bool, comp: bool) -> str:
    if not rev:
        return seq
    if comp:
        return C.revcomp_str(seq)
    return seq[::-1]


def _get_sam_pri(regs: list[Region]) -> Region | None:
    for r in regs:
        if r.sam_pri:
            return r
    return None


def _write_sam_cigar(flag: int, in_tag: bool, qlen: int, r: Region, opt_flag: int) -> str:
    if r.p is None:
        return "*"
    clip0 = qlen - r.qe if r.rev else r.qs
    clip1 = r.qs if r.rev else qlen - r.qe
    if in_tag:
        clip_char = 5 if (flag & 0x800) and not (opt_flag & C.MM_F_SOFTCLIP) else 4
        parts = ["\tCG:B:I"]
        if clip0:
            parts.append(f",{clip0 << 4 | clip_char}")
        parts.extend(f",{c}" for c in r.p.cigar)
        if clip1:
            parts.append(f",{clip1 << 4 | clip_char}")
        return "".join(parts)
    clip_char = "H" if (flag & 0x800) and not (opt_flag & C.MM_F_SOFTCLIP) else "S"
    parts = []
    if clip0:
        parts.append(f"{clip0}{clip_char}")
    parts.append(_cigar_str(r.p.cigar))
    if clip1:
        parts.append(f"{clip1}{clip_char}")
    return "".join(parts)


def write_sam(mi, rec, seg_idx: int, reg_idx: int, n_seg: int,
              regss: list[list[Region]], opt_flag: int, rg_id: str = "") -> str:
    """One SAM record (reference mm_write_sam2, format.c:330-484)."""
    max_bam_cigar_op = 65535
    regs = regss[seg_idx]
    r = regs[reg_idx] if 0 <= reg_idx < len(regs) else None
    cigar_in_tag = False
    qlen = len(rec.seq)

    r_prev = r_next = None
    if n_seg > 1:
        next_sid = (seg_idx + 1) % n_seg
        r_next = _get_sam_pri(regss[next_sid])
        if n_seg > 2:
            for i in range(1, n_seg):
                prev_sid = (seg_idx + n_seg - i) % n_seg
                if regss[prev_sid]:
                    r_prev = _get_sam_pri(regss[prev_sid])
                    break
        else:
            r_prev = r_next

    from .fastx import strip_pair_suffix
    name = strip_pair_suffix(rec.name) if n_seg > 1 else rec.name
    s = [name]

    flag = 0x1 if n_seg > 1 else 0x0
    if r is None:
        flag |= 0x4
    else:
        if r.rev:
            flag |= 0x10
        if r.parent != r.id:
            flag |= 0x100
        elif not r.sam_pri:
            flag |= 0x800
    if n_seg > 1:
        if r is not None and r.proper_frag:
            flag |= 0x2
        if seg_idx == 0:
            flag |= 0x40
        elif seg_idx == n_seg - 1:
            flag |= 0x80
        if r_next is None:
            flag |= 0x8
        elif r_next.rev:
            flag |= 0x20
    s.append(f"\t{flag}")

    this_rid, this_pos, this_rev = -1, -1, 0
    if r is None:
        if r_prev is not None:
            this_rid, this_pos = r_prev.rid, r_prev.rs
            s.append(f"\t{mi.seqs[this_rid].name}\t{this_pos + 1}\t0\t*")
        else:
            s.append("\t*\t0\t0\t*")
    else:
        this_rid, this_pos, this_rev = r.rid, r.rs, r.rev
        s.append(f"\t{mi.seqs[r.rid].name}\t{r.rs + 1}\t{r.mapq}\t")
        if (opt_flag & C.MM_F_LONG_CIGAR) and r.p is not None \
                and len(r.p.cigar) > max_bam_cigar_op - 2:
            n_cigar = len(r.p.cigar)
            if r.qs != 0:
                n_cigar += 1
            if r.qe != qlen:
                n_cigar += 1
            if n_cigar > max_bam_cigar_op:
                cigar_in_tag = True
        if cigar_in_tag:
            if flag & 0x100:
                s.append("0S")
            elif flag & 0x800:
                s.append(f"{r.re - r.rs}S")
            else:
                s.append(f"{qlen}S")
        else:
            s.append(_write_sam_cigar(flag, False, qlen, r, opt_flag))

    if n_seg > 1:
        tlen = 0
        if this_rid >= 0 and r_next is not None:
            if this_rid == r_next.rid:
                this_pos5 = r.re - 1 if (r is not None and r.rev) else this_pos
                next_pos5 = r_next.re - 1 if r_next.rev else r_next.rs
                tlen = next_pos5 - this_pos5
                s.append("\t=\t")
            else:
                s.append(f"\t{mi.seqs[r_next.rid].name}\t")
            s.append(f"{r_next.rs + 1}\t")
        elif r_next is not None:
            s.append(f"\t{mi.seqs[r_next.rid].name}\t{r_next.rs + 1}\t")
        elif this_rid >= 0:
            this_pos5 = r.re - 1 if this_rev else this_pos
            tlen = this_pos - this_pos5
            s.append(f"\t=\t{this_pos + 1}\t")
        else:
            s.append("\t*\t0\t")
        if tlen > 0:
            tlen += 1
        elif tlen < 0:
            tlen -= 1
        s.append(f"{tlen}\t")
    else:
        s.append("\t*\t0\t0\t")

    if r is None:
        s.append(rec.seq)
        s.append("\t")
        s.append(rec.qual if rec.qual else "*")
    else:
        if (flag & 0x900) == 0 or (opt_flag & C.MM_F_SOFTCLIP):
            s.append(_sam_seq(rec.seq, bool(r.rev), True))
            s.append("\t")
            s.append(_sam_seq(rec.qual, bool(r.rev), False) if rec.qual else "*")
        elif flag & 0x100:
            s.append("*\t*")
        else:
            s.append(_sam_seq(rec.seq[r.qs:r.qe], bool(r.rev), True))
            s.append("\t")
            s.append(_sam_seq(rec.qual[r.qs:r.qe], bool(r.rev), False) if rec.qual else "*")

    if rg_id:
        s.append(f"\tRG:Z:{rg_id}")
    if n_seg > 2:
        s.append(f"\tFI:i:{seg_idx}")
    if r is not None:
        s.append(_write_tags(r))
        if r.parent == r.id and r.p is not None and len(regs) > 1:
            sa = []
            for q in regs:
                if q is r or q.parent != q.id or q.p is None:
                    continue
                if q.qe - q.qs < q.re - q.rs:
                    l_m = q.qe - q.qs
                    l_i, l_d = 0, (q.re - q.rs) - l_m
                else:
                    l_m = q.re - q.rs
                    l_i, l_d = (q.qe - q.qs) - l_m, 0
                clip5 = qlen - q.qe if q.rev else q.qs
                clip3 = q.qs if q.rev else qlen - q.qe
                part = f"{mi.seqs[q.rid].name},{q.rs + 1},{'+-'[q.rev]},"
                if clip5:
                    part += f"{clip5}S"
                if l_m:
                    part += f"{l_m}M"
                if l_i:
                    part += f"{l_i}I"
                if l_d:
                    part += f"{l_d}D"
                if clip3:
                    part += f"{clip3}S"
                part += f",{q.mapq},{q.blen - q.mlen + q.p.n_ambi};"
                sa.append(part)
            if sa:
                s.append("\tSA:Z:" + "".join(sa))
        if r.p is not None and (opt_flag & (C.MM_F_OUT_CS | C.MM_F_OUT_MD)):
            if opt_flag & C.MM_F_OUT_MD:
                s.append(_write_md(mi, rec.seq, r))
            else:
                s.append(_write_cs(mi, rec.seq, r, bool(opt_flag & C.MM_F_OUT_CS_LONG)))
        if cigar_in_tag:
            s.append(_write_sam_cigar(flag, True, qlen, r, opt_flag))
    if (opt_flag & C.MM_F_COPY_COMMENT) and rec.comment:
        s.append("\t" + rec.comment)
    return "".join(s)
