"""paftools — evaluation / format-conversion toolkit for PAF/SAM alignments.

Python re-implementation of the reference's misc/paftools.js (r755): the same
subcommands, options, and output formats (fields are tab-separated like the
k8 `print`). Subcommands and their reference locations:

  view        paftools.js:832   PAF -> BLAST-like / MAF / LASTZ-cigar
  splice2bed  paftools.js:1333  spliced PAF/SAM -> BED12
  sam2paf     paftools.js:1117  SAM -> PAF (with cs from MD)
  delta2paf   paftools.js:1270  MUMmer delta -> PAF
  gff2bed     paftools.js:994   GTF/GFF3 -> BED12
  stat        paftools.js:558   mapping statistics from PAF/SAM
  liftover    paftools.js:206   simplistic liftOver through PAF
  call        paftools.js:340   variant calling from asm-to-ref cs-PAF
  bedcov      paftools.js:707   covered-base counting
  mapeval     paftools.js:1453  mapping-accuracy evaluation (simulated reads)
  mason2fq    paftools.js:1622  mason2 SAM -> FASTQ with truth names
  pbsim2fq    paftools.js:1703  PBSIM MAF -> FASTA with truth names
  junceval    paftools.js:1759  splice-junction accuracy vs GTF
  ov-eval     paftools.js:1915  overlap sensitivity evaluation
"""
from __future__ import annotations

import argparse
import gzip
import re
import sys

VERSION = "r755"

RE_CIGAR = re.compile(r"(\d+)([MIDNSHX=])")
RE_CS = re.compile(r"([:=*+-])(\d+|[A-Za-z]+)")

_RC = str.maketrans("WSATUGCYRKMBDHVNwsatugcyrkmbdhvn",
                    "WSTAACGRYMKVHDBNwstaacgrymkvhdbn")


def revcomp(s: str) -> str:
    return s.translate(_RC)[::-1]


def _open(fn):
    if fn == "-":
        return sys.stdin
    if fn.endswith(".gz"):
        return gzip.open(fn, "rt")
    return open(fn)


def _print(*fields):
    print("\t".join(str(f) for f in fields))


def _warn(msg):
    print(msg, file=sys.stderr)


# ---------------------------------------------------------------- intervals

def intv_sort(a):
    a.sort(key=lambda x: (x[0], x[1]))


def intv_merge(a, sorted_=True):
    if not sorted_:
        intv_sort(a)
    k = 0
    for i in range(1, len(a)):
        if a[k][1] >= a[i][0]:
            a[k][1] = max(a[k][1], a[i][1])
        else:
            k += 1
            a[k] = list(a[i])
    del a[k + 1:]


def intv_dedup(a, sorted_=True):
    if not sorted_:
        intv_sort(a)
    k = 0
    for i in range(1, len(a)):
        if a[i][0] != a[k][0] or a[i][1] != a[k][1]:
            k += 1
            a[k] = list(a[i])
    del a[k + 1:]


def intv_index_end(a, sorted_=True):
    """Append, per interval, the smallest index k such that scanning from k
    cannot miss an overlap (reference Interval.index_end)."""
    if not a:
        return
    if not sorted_:
        intv_sort(a)
    a[0].append(0)
    k, k_en = 0, a[0][1]
    for i in range(1, len(a)):
        if k_en <= a[i][0]:
            k += 1
            while k < i:
                if a[k][1] > a[i][0]:
                    break
                k += 1
            k_en = a[k][1]
        a[i].append(k)


def intv_find_ovlp(a, st, en):
    if not a or st >= en:
        return []
    left, right = -1, len(a)
    while right - left > 1:
        mid = left + ((right - left) >> 1)
        if a[mid][0] > st:
            right = mid
        elif a[mid][0] < st:
            left = mid
        else:
            left = mid
            break
    k = 0 if left < 0 else a[left][-1]
    b = []
    for i in range(k, len(a)):
        if a[i][0] >= en:
            break
        if st < a[i][1]:
            b.append(a[i])
    return b


# --------------------------------------------------------------------- stat

class _GapHistogram:
    """Indel-length histogram in the reference's six bins
    (paftools.js:558); names: 0=insertions into the query, 1=deletions."""
    BINS = ("[0,50)", "[50,100)", "[100,300)", "[300,400)", "[400,1000)",
            "[1000,inf)")
    EDGES = (50, 100, 300, 400, 1000)

    def __init__(self):
        self.counts = [[0] * 6, [0] * 6]

    def add(self, which, ln):
        b = 0
        while b < 5 and ln >= self.EDGES[b]:
            b += 1
        self.counts[which][b] += 1

    def report(self):
        for which, name in ((0, "insertions"), (1, "deletions")):
            for b, label in enumerate(self.BINS):
                print(f"Number of {name} in {label}: "
                      f"{self.counts[which][b]}")


def _query_cov_len(regs):
    """Total query bases covered by the union of [qs, qe) intervals."""
    regs.sort(key=lambda r: r[0])
    st, en = regs[0]
    length = 0
    for s, e in regs[1:]:
        if s < en:
            en = max(en, e)
        else:
            length += en - st
            st, en = s, e
    return length + (en - st)


def paf_stat(argv):
    """Basic mapping statistics from PAF (primary = has s2) or SAM
    (paftools.js:558): per-query coverage union, gap histogram, CIGAR
    sanity warnings, optional long-gap rows (-l)."""
    ap = argparse.ArgumentParser(prog="paftools stat")
    ap.add_argument("-l", dest="gap_out_len", type=int, default=None)
    ap.add_argument("input")
    ns = ap.parse_args(argv)

    n_pri = n_2nd = n_seq = n_cigar_64k = l_tot = l_cov = 0
    gaps = _GapHistogram()

    last = last_qlen = None
    regs = []
    lineno = 0
    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            lineno += 1
            if not line or line[0] == "@":
                continue
            t = line.split("\t", 12)
            atlen = None
            if t[4] in "+-":                                    # PAF
                if not re.search(r"\ts2:i:\d+", line):
                    n_2nd += 1
                    continue
                m = re.search(r"\tcg:Z:(\S+)", line)
                if m is None:
                    _warn(f"WARNING: no CIGAR at line {lineno}")
                    continue
                cigar = m.group(1)
                tname = t[5]
                qs, qe = int(t[2]), int(t[3])
                aqlen = qe - qs
                is_rev = t[4] == "-"
                rs = int(t[7])
                atlen = int(t[8]) - rs
                ori_qlen = int(t[1])
                is_sam = False
            else:                                               # SAM
                flag = int(t[1])
                if (flag & 4) or t[2] == "*" or t[5] == "*":
                    continue
                if flag & 0x100:
                    n_2nd += 1
                    continue
                cigar = t[5]
                tname = t[2]
                rs = int(t[3]) - 1
                aqlen = len(t[9])
                is_sam = True
                is_rev = bool(flag & 0x10)
            n_pri += 1
            if last != t[0]:
                if last is not None:
                    l_tot += last_qlen
                    l_cov += _query_cov_len(regs)
                regs = []
                n_seq += 1
                last = t[0]

            # one CIGAR walk: aligned lengths, clips, gap histogram, and
            # the optional -l long-gap rows (printed at the gap's ref pos)
            M = tl = ql = sclip = n_cigar = 0
            clip = [0, 0]
            for m in RE_CIGAR.finditer(cigar):
                ln, op = int(m.group(1)), m.group(2)
                n_cigar += 1
                if op in "M=X":
                    tl += ln
                    ql += ln
                    M += ln
                elif op in "ID":
                    gaps.add(0 if op == "I" else 1, ln)
                    if op == "I":
                        ql += ln
                    else:
                        tl += ln
                    if ns.gap_out_len is not None and ln >= ns.gap_out_len:
                        _print(t[0], ql, "-" if is_rev else "+", tname,
                               rs + tl, op, ln)
                elif op == "N":
                    tl += ln
                elif op == "S":
                    clip[0 if M == 0 else 1] = ln
                    sclip += ln
                elif op == "H":
                    clip[0 if M == 0 else 1] = ln
            if n_cigar > 65535:
                n_cigar_64k += 1
            if ql + sclip != aqlen:
                _warn(f"WARNING: aligned query length is inconsistent with "
                      f"CIGAR at line {lineno} ({ql + sclip} != {aqlen})")
            if atlen is not None and atlen != tl:
                _warn("WARNING: aligned reference length is inconsistent "
                      f"with CIGAR at line {lineno}")
            if is_sam:
                qs = clip[1 if is_rev else 0]
                qe = qs + ql
                ori_qlen = clip[0] + ql + clip[1]
            regs.append([qs, qe])
            last_qlen = ori_qlen
    if last is not None:
        l_tot += last_qlen
        l_cov += _query_cov_len(regs)

    if ns.gap_out_len is None:
        print(f"Number of mapped sequences: {n_seq}")
        print(f"Number of primary alignments: {n_pri}")
        print(f"Number of secondary alignments: {n_2nd}")
        print("Number of primary alignments with >65535 CIGAR operations: "
              f"{n_cigar_64k}")
        print(f"Number of bases in mapped sequences: {l_tot}")
        print(f"Number of mapped bases: {l_cov}")
        gaps.report()


# ------------------------------------------------------------------ sam2paf

class _CigarSummary:
    """One pass over a SAM CIGAR: per-op totals, clip lengths, and the
    merged M-run list the MD walk consumes (=/X fold into M; H excluded)."""
    __slots__ = ("m", "mm_ext", "ins_n", "ins_len", "del_n", "del_len",
                 "n_skip", "clip", "soft_clip", "n_ops", "runs",
                 "have_m", "have_ext")

    def __init__(self, cigar_str, keep_runs):
        self.m = self.mm_ext = 0
        self.ins_n = self.ins_len = self.del_n = self.del_len = 0
        self.n_skip = self.soft_clip = 0
        self.clip = [0, 0]
        self.n_ops = 0
        self.runs = []          # [len, op] with =/X folded into M
        self.have_m = self.have_ext = False
        for m in RE_CIGAR.finditer(cigar_str):
            ln, op = int(m.group(1)), m.group(2)
            if op == "M":
                self.m += ln
                self.have_m = True
            elif op == "I":
                self.ins_n += 1
                self.ins_len += ln
            elif op == "D":
                self.del_n += 1
                self.del_len += ln
            elif op == "N":
                self.n_skip += ln
            elif op == "S":
                self.clip[0 if self.n_ops == 0 else 1] = ln
                self.soft_clip += ln
            elif op == "H":
                self.clip[0 if self.n_ops == 0 else 1] = ln
            elif op == "=":
                self.m += ln
                self.have_ext = True
                op = "M"
            elif op == "X":
                self.m += ln
                self.mm_ext += ln
                self.have_ext = True
                op = "M"
            self.n_ops += 1
            if keep_runs and op != "H":
                if self.runs and self.runs[-1][1] == op:
                    self.runs[-1][0] += ln
                else:
                    self.runs.append([ln, op])

    @property
    def gap_len(self):
        return self.ins_len + self.del_len

    @property
    def gap_opens(self):
        return self.ins_n + self.del_n


def _md_to_cs(md, runs, seq, lineno):
    """Rebuild a cs:Z difference string from the MD tag and the merged
    CIGAR runs. Two cursor pairs walk in lockstep — (cig_t, cig_q) at CIGAR
    run granularity and (md_t, md_q) at MD token granularity — and must
    agree at the end (the reference's cx/cy vs mx/my check,
    paftools.js:1117)."""
    re_md = re.compile(r"(\d+)|(\^[A-Za-z]+)|([A-Za-z])")
    cs = []
    k = cig_t = cig_q = md_t = md_q = 0
    for m in re_md.finditer(md):
        if m.group(2) is not None:            # ^ACGT: deletion
            deleted = m.group(2)[1:]
            cs.extend(["-", deleted])
            md_t += len(deleted)
            cig_t += len(deleted)
            k += 1
            continue
        # a match run (group 1) or a single substituted base (group 3)
        ml = int(m.group(1)) if m.group(1) is not None else 1
        while k < len(runs) and runs[k][1] != "D":
            cl, op = runs[k]
            if op == "M":
                if md_q + ml < cig_q + cl:    # token ends inside this run
                    if ml > 0:
                        if m.group(3) is not None:
                            cs.extend(["*", m.group(3), seq[md_q]])
                        else:
                            cs.extend([":", str(ml)])
                    md_t += ml
                    md_q += ml
                    ml = 0
                    break
                take = cig_q + cl - md_q      # token spans past the run
                cs.extend([":", str(take)])
                cig_t += cl
                cig_q += cl
                k += 1
                md_t += take
                md_q += take
                ml -= take
            elif op == "I":
                cs.extend(["+", seq[cig_q:cig_q + cl]])
                cig_q += cl
                md_q += cl
                k += 1
            elif op == "S":
                cig_q += cl
                md_q += cl
                k += 1
            else:
                raise SystemExit(f"at line {lineno}: inconsistent MD tag")
        if ml != 0:
            raise SystemExit(f"at line {lineno}: inconsistent MD tag")
    if cig_t != md_t or cig_q != md_q:
        raise SystemExit(f"at line {lineno}: inconsistent MD tag")
    return cs


def paf_sam2paf(argv):
    """SAM -> PAF conversion with cs:Z reconstruction from MD
    (paftools.js:1117): summarize the CIGAR once (_CigarSummary),
    reconcile NM against it (extended =/X CIGARs recompute NM; classic
    CIGARs derive the mismatch count from NM minus gap bases), and rebuild
    cs from MD when SEQ is present."""
    ap = argparse.ArgumentParser(prog="paftools sam2paf")
    ap.add_argument("-p", dest="pri_only", action="store_true")
    ap.add_argument("input")
    ns = ap.parse_args(argv)

    re_tag = re.compile(r"\t(\S\S:[AZif]):(\S+)")
    ctg_len = {}
    lineno = 0
    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            lineno += 1
            if line.startswith("@"):
                if line.startswith("@SQ"):
                    mn = re.search(r"\tSN:(\S+)", line)
                    ml = re.search(r"\tLN:(\d+)", line)
                    if mn and ml:
                        ctg_len[mn.group(1)] = int(ml.group(1))
                continue
            t = line.split("\t", 11)
            flag = int(t[1])
            seq, qual = t[9], t[10]
            if seq != "*" and qual != "*" and len(seq) != len(qual):
                raise SystemExit(f"at line {lineno}: inconsistent SEQ and "
                                 f"QUAL lengths - {len(seq)} != {len(qual)}")
            if t[2] == "*" or (flag & 4) or t[5] == "*":
                continue
            if ns.pri_only and (flag & 0x100):
                continue
            tlen = ctg_len.get(t[2])
            if tlen is None:
                raise SystemExit(f"at line {lineno}: can't find the length "
                                 f"of contig {t[2]}")
            nm = md = None
            for m in re_tag.finditer(line):
                if m.group(1) == "NM:i":
                    nm = int(m.group(2))
                elif m.group(1) == "MD:Z":
                    md = m.group(2)
            if seq == "*":
                md = None

            cg = _CigarSummary(t[5], keep_runs=md is not None)
            ql = cg.m + cg.ins_len + cg.soft_clip
            tl = cg.m + cg.del_len + cg.n_skip
            ts = int(t[3]) - 1
            te = ts + tl
            if cg.n_ops > 65535:
                _warn(f"WARNING at line {lineno}: {cg.n_ops} CIGAR "
                      "operations")
            if te > tlen:
                _warn(f"WARNING at line {lineno}: alignment end position "
                      "larger than ref length; skipped")
                continue
            if seq != "*" and len(seq) != ql:
                _warn(f"WARNING at line {lineno}: SEQ length inconsistent "
                      f"with CIGAR ({len(seq)} != {ql}); skipped")
                continue

            cs = _md_to_cs(md, cg.runs, seq, lineno) if md is not None \
                else []

            # mismatch count: extended CIGARs carry it; else derive from NM
            mm = cg.mm_ext
            if cg.have_ext and not cg.have_m:
                if nm is not None and nm != cg.gap_len + mm:
                    _warn(f"WARNING at line {lineno}: NM is different from "
                          "sum of gaps and mismatches")
                nm = cg.gap_len + mm
            elif nm is not None:
                if nm < cg.gap_len:
                    _warn(f"WARNING at line {lineno}: NM is less than the "
                          f"total number of gaps ({nm} < {cg.gap_len})")
                    nm = cg.gap_len
                mm = nm - cg.gap_len
            else:
                _warn(f"WARNING at line {lineno}: unable to find the number "
                      "of mismatches; assuming zero")
                mm = 0

            mlen = cg.m - mm
            blen = cg.m + cg.gap_len
            qlen = cg.m + cg.ins_len + cg.clip[0] + cg.clip[1]
            qname = t[0]
            if flag & 1:
                if flag & 0x40:
                    qname += "/1"
                if flag & 0x80:
                    qname += "/2"
            if flag & 16:
                qs, qe = cg.clip[1], qlen - cg.clip[0]
            else:
                qs, qe = cg.clip[0], qlen - cg.clip[1]
            tags = ["tp:A:" + ("S" if flag & 0x100 else "P")]
            if nm is not None:
                tags.append(f"mm:i:{mm}")
            tags.append(f"gn:i:{cg.gap_len}")
            tags.append(f"go:i:{cg.gap_opens}")
            tags.append("cg:Z:" + re.sub(r"\d+[SH]", "", t[5]))
            if cs:
                tags.append("cs:Z:" + "".join(cs))
            _print(qname, qlen, qs, qe, "-" if flag & 16 else "+", t[2],
                   tlen, ts, te, mlen, blen, t[4], *tags)


# --------------------------------------------------------------------- view

class _AlnText:
    """Three-row alignment text builder (ref / match-bar / query) shared
    by the BLAST-like and MAF views; tracks consumed ref/query lengths."""

    def __init__(self):
        self.ref, self.mid, self.qry = [], [], []
        self.consumed = [0, 0]          # [ref, query]

    def add(self, op, seq):
        ln = 1 if op == "*" else len(seq)
        if op in "=:":
            self.ref.append(seq)
            self.qry.append(seq)
            self.mid.append("|" * ln)
            self.consumed[0] += ln
            self.consumed[1] += ln
        elif op == "*":                 # seq = ref base + query base
            self.ref.append(seq[0])
            self.qry.append(seq[1])
            self.mid.append(" ")
            self.consumed[0] += 1
            self.consumed[1] += 1
        elif op == "+":
            self.ref.append("-" * ln)
            self.qry.append(seq)
            self.mid.append(" " * ln)
            self.consumed[1] += ln
        elif op == "-":
            self.ref.append(seq)
            self.qry.append("-" * ln)
            self.mid.append(" " * ln)
            self.consumed[0] += ln

    def empty(self):
        return not self.ref

    def rows(self):
        return "".join(self.ref), "".join(self.mid), "".join(self.qry)


def _view_lastz(t, line, lineno):
    m = re.search(r"\tcg:Z:(\S+)", line)
    if m is None:
        _warn("WARNING: converting to LASTZ-cigar format requires "
              f"the 'cg' tag, which is absent on line {lineno}")
        return
    ms = re.search(r"\tAS:i:(\d+)", line)
    score = ms.group(1) if ms else 0
    out = ["cigar:", t[0], t[2], t[3], t[4], t[5], t[7], t[8], "+", score]
    for mm in RE_CIGAR.finditer(m.group(1)):
        out.extend([mm.group(2), mm.group(1)])
    print(" ".join(str(x) for x in out))


def _view_maf(t, line, lineno):
    m = re.search(r"\tcs:Z:(\S+)", line)
    if m is None:
        _warn("WARNING: converting to MAF requires the 'cs' tag, "
              f"which is absent on line {lineno}")
        return
    aln = _AlnText()
    for mm in RE_CS.finditer(m.group(1)):
        if mm.group(1) == ":":
            raise SystemExit("converting to MAF only works with "
                             "'minimap2 --cs=long'")
        aln.add(mm.group(1), mm.group(2))
    ms = re.search(r"\tAS:i:(\d+)", line)
    score = int(ms.group(1)) if ms else 0
    name_w = max(len(t[0]), len(t[5]))
    ref_row, _, qry_row = aln.rows()
    print(f"a {score}")
    print(" ".join(["s", f"{t[5]:<{name_w}}", f"{t[7]:>10}",
                    f"{int(t[8]) - int(t[7]):>10}", "+",
                    f"{t[6]:>10}", ref_row]))
    ql = int(t[1])
    if t[4] == "+":
        qs, qe = int(t[2]), int(t[3])
    else:
        qs, qe = ql - int(t[3]), ql - int(t[2])
    print(" ".join(["s", f"{t[0]:<{name_w}}", f"{qs:>10}",
                    f"{qe - qs:>10}", t[4], f"{ql:>10}", qry_row]))
    print("")


def _view_blast(t, line, lineno, line_len):
    """BLAST-like eyeball view: the cs walk is re-chunked into blocks of
    at most line_len alignment columns (a * column counts as one)."""
    m = re.search(r"\tcs:Z:(\S+)", line)
    if m is None:
        _warn("WARNING: converting to BLAST-like alignment "
              f"requires the 'cs' tag, which is absent on line {lineno}")
        return
    print(">" + re.sub(r"\tc[sg]:Z:\S+", "", line))
    rs, strand = int(t[7]), t[4]
    qs = int(t[2]) if strand == "+" else int(t[3])

    def print_block(block_start, aln):
        ref_row, mid_row, qry_row = aln.rows()
        print(" ".join(["Ref+:", f"{rs + block_start[0] + 1:>10}", ref_row,
                        f"{rs + aln.consumed[0]:<10}"]))
        print("                 " + mid_row)
        if strand == "+":
            st, en = qs + block_start[1] + 1, qs + aln.consumed[1]
        else:
            st, en = qs - block_start[1], qs - aln.consumed[1] + 1
        print(" ".join([f"Qry{strand}:", f"{st:>10}", qry_row, f"{en:<10}"]))

    aln = _AlnText()
    block_start = [0, 0]        # consumed (ref, qry) at block start
    n_blocks = 0
    cur_len = 0
    for mm in RE_CS.finditer(m.group(1)):
        op, seq = mm.group(1), mm.group(2)
        if op == ":":
            seq = "=" * int(seq)
        start, rest = 0, 1 if op == "*" else len(seq)
        while rest > 0:
            if cur_len + rest >= line_len:      # fill + flush the block
                take = line_len - cur_len
                aln.add(op, seq if op == "*" else seq[start:start + take])
                if n_blocks > 0:
                    print("")
                print_block(block_start, aln)
                n_blocks += 1
                block_start = list(aln.consumed)
                prev = aln
                aln = _AlnText()
                aln.consumed = list(prev.consumed)
                cur_len = 0
            else:
                take = rest
                aln.add(op, seq if op == "*" else seq[start:start + take])
                cur_len += take if op != "*" else 1
            rest -= take
            start += take
    if not aln.empty():
        if n_blocks > 0:
            print("")
        print_block(block_start, aln)
    print("//")


def paf_view(argv):
    """PAF -> BLAST-like / MAF / LASTZ-cigar text (paftools.js:832); one
    emitter per format above."""
    ap = argparse.ArgumentParser(prog="paftools view")
    ap.add_argument("-f", dest="fmt", default="aln",
                    choices=["aln", "lastz-cigar", "maf"])
    ap.add_argument("-l", dest="line_len", type=int, default=80)
    ap.add_argument("input")
    ns = ap.parse_args(argv)
    line_len = ns.line_len if ns.line_len else 0x7FFFFFFF

    if ns.fmt == "maf":
        print("##maf version=1\n")
    lineno = 0
    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            t = line.split("\t", 12)
            lineno += 1
            if ns.fmt == "lastz-cigar":
                _view_lastz(t, line, lineno)
            elif ns.fmt == "maf":
                _view_maf(t, line, lineno)
            else:
                _view_blast(t, line, lineno, line_len)


# ---------------------------------------------------------------- delta2paf

class _DeltaAln:
    """One alignment block of a MUMmer .delta file, accumulated gap by
    gap into CIGAR runs (reference behavior: misc/paftools.js:1270
    paf_delta2paf, re-expressed as explicit (op, len) runs instead of
    bit-packed ints). Delta gap encoding: each signed distance d names
    the offset of the next unaligned base — |d|-1 matched columns, then
    one reference base skipped in the query (d>0, a deletion) or one
    query base absent from the reference (d<0, an insertion); d=0 closes
    the block with the remaining matched tail."""
    __slots__ = ("rs", "re", "qs", "qe", "strand", "nm", "x", "y", "cig")

    def __init__(self, coords):
        r0, r1, q0, q1, nm = coords
        self.strand = "+" if (r0 < r1) == (q0 < q1) else "-"
        self.rs, self.re = min(r0, r1) - 1, max(r0, r1)   # 1-based closed
        self.qs, self.qe = min(q0, q1) - 1, max(q0, q1)   # -> 0-based half
        self.nm = nm
        self.x = self.y = 0    # ref/query columns consumed so far
        self.cig = []          # [op, len] runs

    def gap(self, d):
        ln = abs(d) - 1
        if ln > 0:
            # match runs are always fenced by the indel that follows, so
            # they never need merging with a previous run
            self.cig.append(["M", ln])
        op = "D" if d > 0 else "I"
        self.x += ln + (d > 0)
        self.y += ln + (d < 0)
        if self.cig and self.cig[-1][0] == op:
            self.cig[-1][1] += 1
        else:
            self.cig.append([op, 1])

    def close_and_print(self, rname, rlen, qname, qlen):
        tail = self.re - self.rs - self.x
        if tail != self.qe - self.qs - self.y:
            raise SystemExit("inconsisnt alignment")  # sic: paftools.js:1305
        self.cig.append(["M", tail])   # a block ending on its last indel
        #                                emits the reference's literal "0M"
        blen = sum(ln for _op, ln in self.cig)
        _print(qname, qlen, self.qs, self.qe, self.strand,
               rname, rlen, self.rs, self.re, blen - self.nm, blen, 0,
               f"NM:i:{self.nm}",
               "cg:Z:" + "".join(f"{ln}{op}" for op, ln in self.cig))


def paf_delta2paf(argv):
    ap = argparse.ArgumentParser(prog="paftools delta2paf")
    ap.add_argument("input")
    ns = ap.parse_args(argv)
    rname = qname = None
    rlen = qlen = 0
    aln = None
    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            m = re.match(r"^>(\S+)\s+(\S+)\s+(\d+)\s+(\d+)", line)
            if m:
                rname, qname = m.group(1), m.group(2)
                rlen, qlen = int(m.group(3)), int(m.group(4))
                continue
            if rname is None:    # leading junk before the first '>' header
                continue
            t = line.split(" ")
            if len(t) == 7:      # new alignment block: coords + error count
                aln = _DeltaAln([int(x) for x in t[:5]])
            elif len(t) == 1 and aln is not None:
                d = int(t[0])
                if d == 0:
                    aln.close_and_print(rname, rlen, qname, qlen)
                else:
                    aln.gap(d)


# --------------------------------------------------------------- splice2bed

class _Bed12Row:
    """One BED12 row under construction for splice2bed: exon blocks come
    from the CIGAR's N gaps; `pri_class` is 0 = sole primary, 1 = one of
    several primaries, 2 = secondary (rendered as itemRgb colors)."""
    COLORS = ("0,128,255", "255,0,0", "0,192,0")
    __slots__ = ("chrom", "st", "en", "name", "score", "strand",
                 "pri_class", "block_starts", "block_lens")

    def __init__(self, chrom, st, en, name, score, strand, pri_class):
        self.chrom, self.st, self.en = chrom, st, en
        self.name, self.score, self.strand = name, score, strand
        self.pri_class = pri_class
        self.block_starts, self.block_lens = [], []

    def blocks_from_cigar(self, cigar):
        x0 = x = 0
        for m in RE_CIGAR.finditer(cigar):
            if m.group(2) in "MD":
                x += int(m.group(1))
            elif m.group(2) == "N":
                self.block_starts.append(x0)
                self.block_lens.append(x - x0)
                x += int(m.group(1))
                x0 = x
        self.block_starts.append(x0)
        self.block_lens.append(x - x0)
        if self.en is None:            # SAM rows compute the end here
            self.en = self.st + x

    def fields(self):
        return (self.chrom, self.st, self.en, self.name, self.score,
                self.strand, self.st, self.en,
                self.COLORS[self.pri_class], len(self.block_starts),
                ",".join(map(str, self.block_lens)) + ",",
                ",".join(map(str, self.block_starts)) + ",")


def paf_splice2bed(argv):
    """Spliced PAF/SAM -> BED12 (paftools.js:1333): one row per
    alignment, exon blocks split at N cigar ops, grouped per read so
    multi-primary reads can be recolored before flushing."""
    ap = argparse.ArgumentParser(prog="paftools splice2bed")
    ap.add_argument("-m", dest="keep_multi", action="store_true")
    ap.add_argument("-f", dest="fmt", default="bed")
    ap.add_argument("-n", dest="name_conv", default=None)
    ap.add_argument("input")
    ns = ap.parse_args(argv)

    def flush(rows):
        if not rows:
            return
        if ns.fmt != "bed":
            # parity: the reference's print_lines only has a "bed" branch
            # (paftools.js:1338) — any other -f silently emits nothing
            rows.clear()
            return
        n_pri = sum(1 for r in rows if r.pri_class == 0)
        if n_pri > 1:
            for r in rows:
                if r.pri_class == 0:
                    r.pri_class = 1
        elif n_pri == 0:
            _warn(f"Warning: {rows[0].name} doesn't have a primary "
                  "alignment")
        for r in rows:
            if not ns.keep_multi and r.pri_class == 2:
                continue
            _print(*r.fields())
        rows.clear()

    conv = None
    if ns.name_conv is not None:
        conv = {}
        with _open(ns.name_conv) as f:
            for line in f:
                t = line.rstrip("\n").split("\t")
                conv[t[0]] = t[1]

    rows = []
    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line[0] == "@":
                continue
            t = line.split("\t")
            if conv is not None and t[0] in conv:
                t[0] = conv[t[0]]
            if (len(t) >= 10 and t[4] not in "+-"
                    and re.match(r"^\d+", t[1])):  # SAM read-pair suffix
                flag = int(t[1])
                if flag & 1:
                    t[0] += "/" + str(flag >> 6 & 3)
            if rows and rows[0].name != t[0]:
                flush(rows)
            cigar = None
            if len(t) >= 12 and t[4] in "+-":        # PAF
                is_pri = False
                for fld in t[12:]:
                    if fld.startswith("cg:Z:"):
                        cigar = fld[5:]
                    elif fld.startswith("s2:i:"):
                        is_pri = True
                row = _Bed12Row(t[5], int(t[7]), int(t[8]), t[0],
                                int(t[9]) * 1000 // int(t[10]), t[4],
                                0 if is_pri else 2)
            elif len(t) >= 10:                       # SAM
                flag = int(t[1])
                if (flag & 4) or t[2] == "*":
                    continue
                cigar = t[5]
                row = _Bed12Row(t[2], int(t[3]) - 1, None, t[0], 1000,
                                "-" if flag & 16 else "+",
                                0 if not (flag & 0x100) else 2)
            else:
                raise SystemExit("unrecognized input format")
            if cigar is None:
                raise SystemExit("missing CIGAR")
            row.blocks_from_cigar(cigar)
            rows.append(row)
    flush(rows)


# ------------------------------------------------------------------ gff2bed

def _ens2ucsc_table(fai_path):
    """ENSEMBL->UCSC chromosome-name mapping inferred from a UCSC .fai
    (paftools.js:994's heuristic renaming)."""
    table = {}
    with _open(fai_path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            s = t[0]
            if re.search(r"_(random|alt|decoy)$", s):
                s = re.sub(r"_(random|alt|decoy)$", "", s)
                s = re.sub(r"^chr\S+_", "", s)
            else:
                s = re.sub(r"^chrUn_", "", s)
            s = re.sub(r"v(\d+)", r".\1", s)
            if s != t[0]:
                table[s] = t[0]
    return table


def paf_gff2bed(argv):
    """GTF/GFF3 -> BED12 (paftools.js:994): exon rows grouped per
    transcript_id become one BED12 row; CDS rows set the thick range.
    Exon tuples: (chrom, st, en, strand, tid, type, gene_name, tx_name).

    Parity note: gene_name deliberately persists across rows that lack
    the attribute (the reference leaks `name` the same way), so a
    transcript without gene_name inherits the previous one."""
    ap = argparse.ArgumentParser(prog="paftools gff2bed")
    ap.add_argument("-u", dest="ucsc_fai", default=None)
    ap.add_argument("-s", dest="is_short", action="store_true")
    ap.add_argument("-g", dest="keep_gff", action="store_true")
    ap.add_argument("input")
    ns = ap.parse_args(argv)

    ens2ucsc = _ens2ucsc_table(ns.ucsc_fai) if ns.ucsc_fai is not None \
        else {}
    colors = {"protein_coding": "0,128,255", "lincRNA": "0,192,0",
              "snRNA": "0,192,0", "miRNA": "0,192,0", "misc_RNA": "0,192,0"}
    re_gtf = re.compile(r'(transcript_id|transcript_type|transcript_biotype|'
                        r'gene_name|transcript_name) "([^"]+)";')
    re_gff3 = re.compile(r"(transcript_id|transcript_type|transcript_biotype|"
                         r"gene_name|transcript_name)=([^;]+)")
    CHROM, ST, EN, STRAND, TID, TYPE, GENE, TXNAME = range(8)

    def print_bed12(exons, cds_st, cds_en):
        if not exons:
            return
        first = exons[0]
        name = (first[TXNAME] + "|" + first[TYPE] if ns.is_short
                else "|".join(str(x) for x in
                              (first[TID], first[TYPE], first[GENE])))
        by_pos = sorted(exons, key=lambda e: e[ST])
        st, en = by_pos[0][ST], by_pos[-1][EN]
        if cds_st == 1 << 30:
            cds_st = st
        if cds_en == 0:
            cds_en = en
        if cds_st < st or cds_en > en:
            raise SystemExit("inconsistent thick start or end for "
                             f"transcript {first[TID]}")
        sizes = [e[EN] - e[ST] for e in by_pos]
        starts = [e[ST] - st for e in by_pos]
        color = colors.get(first[TYPE], "196,196,196")
        _print(by_pos[0][CHROM], st, en, name, 1000, by_pos[0][STRAND],
               cds_st, cds_en, color, len(by_pos),
               ",".join(map(str, sizes)) + ",",
               ",".join(map(str, starts)) + ",")

    gname = "N/A"
    exons = []
    cds_st, cds_en = 1 << 30, 0
    last_id = None
    with _open(ns.input) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if ns.keep_gff:
                if t[0] and t[0][0] != "#" and t[0] in ens2ucsc:
                    t[0] = ens2ucsc[t[0]]
                print("\t".join(t))
                continue
            if not t[0] or t[0][0] == "#":
                continue
            if len(t) < 9 or t[2] not in ("CDS", "exon"):
                continue
            st0 = int(t[3]) - 1
            en0 = int(t[4])
            tid, typ, biotype, tname = None, "", "", "N/A"
            for m in list(re_gtf.finditer(t[8])) \
                    + list(re_gff3.finditer(t[8])):
                key, val = m.group(1), m.group(2)
                if key == "transcript_id":
                    tid = val
                elif key == "transcript_type":
                    typ = val
                elif key == "transcript_biotype":
                    biotype = val
                elif key == "gene_name":
                    gname = val
                elif key == "transcript_name":
                    tname = val
            if typ == "" and biotype != "":
                typ = biotype
            if tid is None:
                raise SystemExit("No transcript_id")
            if tid != last_id:
                print_bed12(exons, cds_st, cds_en)
                exons = []
                cds_st, cds_en = 1 << 30, 0
                last_id = tid
            if t[2] == "CDS":
                cds_st = min(cds_st, st0)
                cds_en = max(cds_en, en0)
            else:
                chrom = t[0]
                if ns.ucsc_fai is not None:
                    if chrom in ens2ucsc:
                        chrom = ens2ucsc[chrom]
                    elif re.match(r"^[A-Z]+\d+\.\d+$", chrom):
                        chrom = re.sub(r"([A-Z]+\d+)\.(\d+)",
                                       r"chrUn_\1v\2", chrom)
                exons.append((chrom, st0, en0, t[6], tid, typ, gname,
                              tname))
    if last_id is not None:
        print_bed12(exons, cds_st, cds_en)


# ----------------------------------------------------------------- liftover

def _load_bed3(fn, merge=False):
    """chrom -> sorted [st, en(, scan_index)] interval lists, overlap-query
    ready (intv_index_end appends the scan index used by intv_find_ovlp)."""
    bed = {}
    with _open(fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            bed.setdefault(t[0], []).append([int(t[1]), int(t[2])])
    for intervals in bed.values():
        intv_sort(intervals)
        if merge:
            intv_merge(intervals, True)
        intv_index_end(intervals, True)
    return bed


def _gap_compressed_div(cg, mlen, blen):
    """Gap-compressed divergence estimate from a cigar: mismatches + gap
    OPENS over (that + matches) — the liftover -d filter's metric."""
    n_gap_bases = n_opens = 0
    for m in RE_CIGAR.finditer(cg):
        if m.group(2) in "ID":
            n_gap_bases += int(m.group(1))
            n_opens += 1
    n_diff = (blen - mlen - n_gap_bases) + n_opens
    return n_diff / (n_diff + mlen)


def _lift_endpoints(cg, endpoints, walk_q0, t0):
    """Resolve query-side endpoints to target coordinates in ONE cigar
    walk. `endpoints` is sorted [walk_qpos, is_end, region_idx, result]
    (result -2 = unresolved); walk coordinates run in the alignment's
    strand orientation. M lifts an interior endpoint to the matching
    target offset; I (query-only) lifts it to the block's target start;
    D advances the target only. Returns the final (target, walk_q)
    cursors for the caller's consistency check."""
    k, x, y = 0, t0, walk_q0
    for m in RE_CIGAR.finditer(cg):
        ln, op = int(m.group(1)), m.group(2)
        if op not in "MID":
            continue   # parity: paftools.js:232's regex only knows MID
        if op == "D":
            x += ln
            continue
        while k < len(endpoints) and endpoints[k][0] < y:
            k += 1
        for i in range(k, len(endpoints)):
            if not (y <= endpoints[i][0] < y + ln):
                break
            endpoints[i][3] = x + (endpoints[i][0] - y) if op == "M" else x
        y += ln
        if op == "M":
            x += ln
    return x, y


def paf_liftover(argv):
    """Lift BED intervals through PAF alignments (paftools.js:206).

    For each primary/inversion alignment overlapping a BED interval on
    the query, the interval's two endpoints — expressed in the
    alignment's strand orientation — are resolved to target coordinates
    by a single CIGAR walk (_lift_endpoints); endpoints landing outside
    the aligned span clamp to the alignment's target bounds and the
    output name gains a _t5/_t3 suffix recording the truncation."""
    ap = argparse.ArgumentParser(prog="paftools liftover")
    ap.add_argument("-m", dest="to_merge", action="store_true")
    ap.add_argument("-q", dest="min_mapq", type=int, default=5)
    ap.add_argument("-l", dest="min_len", type=int, default=50000)
    ap.add_argument("-d", dest="max_div", type=float, default=2.0)
    ap.add_argument("paf")
    ap.add_argument("bed")
    ns = ap.parse_args(argv)

    bed = _load_bed3(ns.bed, merge=ns.to_merge)
    re_tag = re.compile(r"^(\S\S):([AZif]):(\S+)$")
    with _open(ns.paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            qname = t[0]
            if qname not in bed:
                continue
            tp = cg = None
            for fld in t[12:]:
                m = re_tag.match(fld)
                if m:
                    if m.group(1) == "tp":
                        tp = m.group(3)
                    elif m.group(1) == "cg":
                        cg = m.group(3)
            if tp not in ("P", "I"):
                continue
            if cg is None:
                raise SystemExit("unable to find the 'cg' tag")
            qlen, qst, qen = int(t[1]), int(t[2]), int(t[3])
            strand, tname = t[4], t[5]
            tst, ten = int(t[7]), int(t[8])
            mlen, blen, mapq = int(t[9]), int(t[10]), int(t[11])
            if mapq < ns.min_mapq or blen < ns.min_len:
                continue
            regs = intv_find_ovlp(bed[qname], qst, qen)
            if not regs:
                continue
            if 0.0 <= ns.max_div < 1.0 \
                    and _gap_compressed_div(cg, mlen, blen) > ns.max_div:
                continue

            # each region contributes two walk-space endpoints
            # [walk_qpos, is_end, region_idx, lifted_target(-2)]
            endpoints = []
            for ri, (s, e, *_) in enumerate(regs):
                if strand == "+":
                    ws, we = s, e - 1
                else:
                    ws, we = qlen - e, qlen - s - 1
                endpoints.append([ws, 0, ri, -2])
                endpoints.append([we, 1, ri, -2])
            endpoints.sort(key=lambda ep: ep[0])

            walk_q0 = qst if strand == "+" else qlen - qen
            x, y = _lift_endpoints(cg, endpoints, walk_q0, tst)
            if (x != ten or (strand == "+" and y != qen)
                    or (strand == "-" and y != qlen - qst)):
                raise SystemExit("CIGAR is inconsistent with mapping "
                                 "coordinates")

            lifted = [[-2, -2] for _ in regs]
            for _pos, is_end, ri, target in endpoints:
                lifted[ri][is_end] = target + 1 if is_end else target
            for ri, (lo, hi) in enumerate(lifted):
                name = "_".join(map(str, (qname, regs[ri][0], regs[ri][1])))
                if lo < 0:
                    name += "_t5"
                    lo = tst
                if hi < 0:
                    name += "_t3"
                    hi = ten
                _print(tname, lo, hi, name, 0, strand)


# --------------------------------------------------------------------- call

class _Variant:
    """One called variant (ref/alt "-" = pure insertion/deletion side).

    `cov` counts primary alignments spanning the site; it starts at the
    value seen while walking the cs string and is incremented later for
    every subsequent alignment that fully contains the site (the pending
    queue below), matching paftools.js:340's two-phase counting."""
    __slots__ = ("ctg", "st", "en", "cov", "mapq", "ref", "alt",
                 "qname", "qst", "qen", "strand")

    def __init__(self, ctg, st, en, cov, mapq, ref, alt,
                 qname, qst, qen, strand):
        self.ctg, self.st, self.en = ctg, st, en
        self.cov, self.mapq = cov, mapq
        self.ref, self.alt = ref, alt
        self.qname, self.qst, self.qen, self.strand = \
            qname, qst, qen, strand

    def fields(self):
        return (self.ctg, self.st, self.en, self.cov, self.mapq,
                self.ref, self.alt, self.qname, self.qst, self.qen,
                self.strand)


class _VariantClassCounter:
    """Substitution / indel-length histogram printed at exit (only
    confidently-covered variants count: cov == 1 semantics of
    paftools.js — here cov <= 1, i.e. not seen by a second contig)."""

    def __init__(self, gap_thres):
        self.gap_thres = gap_thres
        self.n_sub = [0, 0, 0]       # total, transition, transversion
        self.n_ins = [0, 0, 0, 0]    # 1bp, 2bp, [3,thres), >=thres
        self.n_del = [0, 0, 0, 0]

    def _len_class(self, ln):
        return 0 if ln == 1 else 1 if ln == 2 \
            else 2 if ln < self.gap_thres else 3

    def add(self, v: _Variant):
        if v.cov > 1 or (v.ref == "-" and v.alt == "-"):
            return
        if v.ref == "-":
            self.n_ins[self._len_class(len(v.alt))] += 1
        elif v.alt == "-":
            self.n_del[self._len_class(len(v.ref))] += 1
        else:
            self.n_sub[0] += 1
            pair = (v.ref + v.alt).lower()
            self.n_sub[1 if pair in ("ag", "ga", "ct", "tc") else 2] += 1

    def report(self):
        ts, tv = self.n_sub[1], self.n_sub[2]
        _warn(f"{self.n_sub[0]} substitutions; ts/tv = "
              f"{ts / tv if tv else float('nan'):.3f}")
        _warn(f"{self.n_del[0]} 1bp deletions")
        _warn(f"{self.n_ins[0]} 1bp insertions")
        _warn(f"{self.n_del[1]} 2bp deletions")
        _warn(f"{self.n_ins[1]} 2bp insertions")
        _warn(f"{self.n_del[2]} [3,{self.gap_thres}) deletions")
        _warn(f"{self.n_ins[2]} [3,{self.gap_thres}) insertions")
        _warn(f"{self.n_del[3]} >={self.gap_thres} deletions")
        _warn(f"{self.n_ins[3]} >={self.gap_thres} insertions")


class _SingleCovTracker:
    """Running length of reference covered by EXACTLY one long contig.

    Alignments arrive sorted by (ctg, start); the tracker keeps one open
    window [start, end) and, when a new alignment starts a fresh window /
    overlaps / is contained, banks the single-covered prefix and emits it
    as an "R" row (text mode only). `counted` is whether the contig that
    OPENED the current window cleared min_var_len (paftools.js:340's
    c1_counted)."""

    def __init__(self, min_var_len, emit):
        self.min_var_len = min_var_len
        self.emit = emit        # callable(ctg, st, en) or None (VCF mode)
        self.ctg = None
        self.start = self.end = 0
        self.counted = False
        self.single_len = 0

    def _bank(self, en):
        if self.counted and en > self.start:
            self.single_len += en - self.start
            if self.emit:
                self.emit(self.ctg, self.start, en)

    def add(self, ctg, st, en, blen):
        if ctg != self.ctg or st >= self.end:        # disjoint: new window
            self._bank(self.end)
            self.ctg, self.start, self.end = ctg, st, en
            self.counted = blen >= self.min_var_len
        elif en > self.end:                          # overlap extends
            self._bank(st)
            self.start, self.end = self.end, en
            self.counted = blen >= self.min_var_len
        elif en > self.start:                        # contained
            self._bank(st)
            self.start = en

    def finish(self):
        self._bank(self.end)
        _warn(f"{self.single_len} reference bases covered by exactly "
              "one contig")


def _cs_variants(cs, ctg, x, y, rev, mapq, qname, cov_at):
    """Walk a cs:Z string from reference position x / query position y
    (query coords already strand-adjusted: y counts DOWN on the reverse
    strand) and yield _Variant records with cov from cov_at(x)."""
    for op, arg in RE_CS.findall(cs):
        if op in ":=":
            ln = len(arg) if op == "=" else int(arg)
            y = y - ln if rev else y + ln
            x += ln
        elif op == "*":                      # substitution ref->alt
            qs, qe = (y - 1, y) if rev else (y, y + 1)
            y = y - 1 if rev else y + 1
            ref_b, alt_b = arg[0], arg[1]
            if ref_b != "n" and alt_b != "n":
                yield _Variant(ctg, x, x + 1, cov_at(x), mapq, ref_b,
                               alt_b, qname, qs, qe, "-" if rev else "+")
            x += 1
        elif op == "+":                      # insertion in the query
            ln = len(arg)
            qs, qe = (y - ln, y) if rev else (y, y + ln)
            y = y - ln if rev else y + ln
            yield _Variant(ctg, x, x, cov_at(x), mapq, "-", arg,
                           qname, qs, qe, "-" if rev else "+")
        elif op == "-":                      # deletion from the reference
            yield _Variant(ctg, x, x + len(arg), cov_at(x), mapq, arg,
                           "-", qname, y, y, "-" if rev else "+")
            x += len(arg)


class _VcfEmitter:
    """VCF v4.1 output (call -f): anchors pure indels on the preceding
    reference base fetched from the FASTA (left-anchored convention)."""

    def __init__(self, ref_fa):
        from ..io.fastx import read_fastx
        self.fa = {}
        self.lens = []
        for rec in read_fastx(ref_fa):
            self.fa[rec.name] = rec.seq
            self.lens.append((rec.name, len(rec.seq)))

    def header(self):
        print("##fileformat=VCFv4.1")
        for name, ln in self.lens:
            print(f"##contig=<ID={name},length={ln}>")
        print('##INFO=<ID=QNAME,Number=1,Type=String,'
              'Description="Query name">')
        print('##INFO=<ID=QSTART,Number=1,Type=Integer,'
              'Description="Query start">')
        print('##INFO=<ID=QSTRAND,Number=1,Type=String,'
              'Description="Query strand">')
        print('##FORMAT=<ID=GT,Number=1,Type=String,'
              'Description="Genotype">')
        print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT"
              "\tsample")

    def emit(self, v: _Variant):
        if v.cov != 1 or (v.ref == "-" and v.alt == "-"):
            return
        if v.ref != "-" and v.alt != "-":
            row = [v.ctg, v.st + 1, ".", v.ref.upper(), v.alt.upper()]
        elif v.st > 0:
            if v.ctg not in self.fa:
                raise SystemExit(f'sequence "{v.ctg}" is absent from the '
                                 "reference FASTA")
            anchor = self.fa[v.ctg][v.st - 1].upper()
            if v.ref == "-":
                row = [v.ctg, v.st, ".", anchor, anchor + v.alt.upper()]
            else:
                row = [v.ctg, v.st, ".", anchor + v.ref.upper(), anchor]
        else:
            raise SystemExit(f"unexpected variant: {list(v.fields())}")
        row.extend([v.mapq, ".",
                    f"QNAME={v.qname};QSTART={v.qst + 1};QSTRAND={v.strand}",
                    "GT", "1/1"])
        _print(*row)


def paf_call(argv):
    """Variant calling from an assembly-to-reference cs-PAF sorted by
    target position (reference paftools.js:340). Architecture: a
    single-coverage tracker for the "R" rows, a cs-walk generator that
    yields typed variants, and a pending queue that upgrades each
    variant's cov while later alignments still span it."""
    ap = argparse.ArgumentParser(prog="paftools call")
    ap.add_argument("-l", dest="min_cov_len", type=int, default=10000)
    ap.add_argument("-L", dest="min_var_len", type=int, default=50000)
    ap.add_argument("-g", dest="gap_thres", type=int, default=50)
    ap.add_argument("-q", dest="min_mapq", type=int, default=5)
    ap.add_argument("-f", dest="ref_fa", default=None)
    ap.add_argument("input")
    ns = ap.parse_args(argv)

    vcf = _VcfEmitter(ns.ref_fa) if ns.ref_fa is not None else None
    counter = _VariantClassCounter(ns.gap_thres)
    re_tag = re.compile(r"\t(\S\S:[AZif]):(\S+)")

    def flush(v: _Variant):
        counter.add(v)
        if vcf:
            vcf.emit(v)
        else:
            _print("V", *v.fields())

    if vcf:
        vcf.header()
    cov = _SingleCovTracker(
        ns.min_var_len,
        None if vcf else (lambda c, s, e: _print("R", c, s, e)))

    # spans of earlier kept alignments, used for the cs-walk coverage
    # seed. Parity quirk preserved from paftools.js:375: both the prune
    # and the count test the FIRST span only — the list survives pruning
    # iff its first span still overlaps, and every surviving span then
    # counts toward cov regardless of its own extent.
    prev_spans: list[tuple] = []
    pending: list[_Variant] = []

    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            t = line.split("\t", 12)
            for i in range(6, 12):
                t[i] = int(t[i])
            blen, mapq = t[10], t[11]
            if blen < ns.min_cov_len or mapq < ns.min_mapq:
                continue
            for i in range(1, 4):
                t[i] = int(t[i])
            qname, rev = t[0], t[4] == "-"
            ctg, x, end = t[5], t[7], t[8]
            y = t[3] if rev else t[2]   # query cursor (runs down on rev)

            cs = tp = None
            have_s1 = have_s2 = False
            for m in re_tag.finditer(line):
                tag, val = m.group(1), m.group(2)
                if tag == "cs:Z":
                    cs = val
                elif tag == "tp:A":
                    tp = val
                elif tag == "s1:i":
                    have_s1 = True
                elif tag == "s2:i":
                    have_s2 = True
            if have_s1 and not have_s2:   # primary without secondary info
                continue
            if tp in ("S", "i"):          # secondary / inversion rows
                continue

            cov.add(ctg, x, end, blen)

            # variants no longer spannable by this (sorted) stream: flush;
            # the rest gain a cov count if this alignment contains them
            while pending and (pending[0].ctg != ctg
                               or pending[0].en <= x):
                flush(pending.pop(0))
            for v in pending:
                if v.st >= x and v.en <= end:
                    v.cov += 1

            if prev_spans and not (prev_spans[0][0] == ctg
                                   and prev_spans[0][2] > x):
                prev_spans = []

            if blen >= ns.min_var_len:
                if cs is None:
                    continue   # parity: js:402 skips the span append too

                def cov_at(pos, spans=prev_spans):
                    return 1 + (len(spans)
                                if spans and spans[0][2] > pos else 0)
                pending.extend(_cs_variants(cs, ctg, x, y, rev, mapq,
                                            qname, cov_at))
            prev_spans.append((ctg, t[7], t[8]))

    cov.finish()
    while pending:
        flush(pending.pop(0))
    counter.report()


# ------------------------------------------------------------------- bedcov

def _read_bed12(fn, to_merge, to_dedup):
    """chrom -> interval lists from BED (BED12 rows contribute their exon
    blocks), overlap-query-ready, with three per-interval accumulator
    slots appended: covered bases, overlapping features, exact hits."""
    by_chrom = {}
    with _open(fn) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            lst = by_chrom.setdefault(t[0], [])
            for st, en in _bed_blocks(t):
                lst.append([st, en, 0, 0, 0])
    for intervals in by_chrom.values():
        if to_merge:
            intv_merge(intervals, False)
        elif to_dedup:
            intv_dedup(intervals, False)
        else:
            intv_sort(intervals)
        intv_index_end(intervals)
    return by_chrom


def _bed_blocks(t):
    """The (st, en) blocks of one BED row: BED12 rows split into their
    exon blocks, everything else is the plain interval."""
    st, en = int(t[1]), int(t[2])
    if len(t) >= 12 and re.match(r"^\d+$", t[9]):
        n = int(t[9])
        sizes = t[10].split(",")
        offs = t[11].split(",")
        return [(st + int(offs[i]), st + int(offs[i]) + int(sizes[i]))
                for i in range(n)]
    return [(st, en)]


def _union_len(intervals):
    """Total length of the union of (st, en) intervals (sorted or not)."""
    if not intervals:
        return 0
    intervals.sort(key=lambda x: x[0])
    st, en = intervals[0]
    total = 0
    for s, e in intervals[1:]:
        if s <= en:
            en = max(en, e)
        else:
            total += en - st
            st, en = s, e
    return total + (en - st)


def paf_bedcov(argv):
    """Covered-base counting (paftools.js:707): how much of each feature
    row in `target` is covered by regions in `regions`, with optional
    exclusion regions (-e) and per-feature rows (-p)."""
    ap = argparse.ArgumentParser(prog="paftools bedcov")
    ap.add_argument("-p", dest="print_len", action="store_true")
    ap.add_argument("-d", dest="dedup", action="store_true")
    ap.add_argument("-e", dest="excl", default=None)
    ap.add_argument("regions")
    ap.add_argument("target")
    ns = ap.parse_args(argv)
    to_merge, to_dedup = (False, True) if ns.dedup else (True, False)

    excl = _read_bed12(ns.excl, True, False) if ns.excl else None
    target = _read_bed12(ns.regions, to_merge, to_dedup)

    tot_len = hit_len = 0
    with _open(ns.target) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            chrom = t[0]
            blocks = [[st, en, False] for st, en in _bed_blocks(t)]
            feat_len = 0
            for blk in blocks:
                if excl is not None and chrom in excl \
                        and intv_find_ovlp(excl[chrom], blk[0], blk[1]):
                    continue
                blk[2] = True               # kept (not excluded)
                feat_len += blk[1] - blk[0]
            tot_len += feat_len
            if chrom not in target:
                continue
            covered = []
            for st, en, kept in blocks:
                if not kept:
                    continue
                for o in intv_find_ovlp(target[chrom], st, en):
                    o_st, o_en = max(o[0], st), min(o[1], en)
                    covered.append((o_st, o_en))
                    o[2] += o_en - o_st     # covered bases
                    o[3] += 1               # overlapping features
                    if o_st == o[0] and o_en == o[1]:
                        o[4] += 1           # fully-covering features
            feat_hit_len = _union_len(covered)
            hit_len += feat_hit_len
            if ns.print_len:
                _print("F", *t[:4], feat_len, feat_hit_len)
    _warn(f"# target bases: {tot_len}")
    pct = 100.0 * hit_len / tot_len if tot_len else float("nan")
    _warn(f"# target bases overlapping regions: {hit_len} ({pct:.2f}%)")


# ------------------------------------------------------------------ mapeval

RE_PBSIM = re.compile(r"^(\S+)!(\S+)!(\d+)!(\d+)!([+\-])$")
RE_MASON = re.compile(
    r"^(\S+)!(\S+)!(\d+)_(\d+)!(\d+)_(\d+)!([+\-])([+\-])/([12])$")


class _SimTruth:
    """True mapping interval parsed from a simulator read name (pbsim2fq /
    mason2fq conventions: name!chr!st!en!strand, mason paired variant picks
    the mate's coordinates by read number)."""
    __slots__ = ("tname", "st", "en", "strand")

    def __init__(self, tname, st, en, strand):
        self.tname, self.st, self.en, self.strand = tname, st, en, strand

    @classmethod
    def from_qname(cls, qname):
        m = RE_PBSIM.match(qname)
        if m:
            return cls(m.group(2), int(m.group(3)), int(m.group(4)),
                       m.group(5))
        m = RE_MASON.match(qname)
        if m is None:
            raise SystemExit("Failed to parse simulated read names "
                             f"'{qname}'")
        if m.group(9) == "1":
            return cls(m.group(2), int(m.group(3)), int(m.group(5)),
                       m.group(7))
        return cls(m.group(2), int(m.group(4)), int(m.group(6)),
                   m.group(8))


class _MapevalCounts:
    """Per-mapq correct/wrong tallies + the cumulative Q-report, ordered
    from high mapq down with empty/zero-error buckets folded into the next
    emitted row (paftools.js:1453's output shape)."""

    def __init__(self, max_mapq=60):
        self.max_mapq = max_mapq
        self.tot = [0] * (max_mapq + 1)
        self.err = [0] * (max_mapq + 1)

    def report(self):
        sum_tot = sum_err = sum_tot2 = sum_err2 = 0
        q_out = -1
        for q in range(self.max_mapq, -1, -1):
            if self.tot[q] == 0:
                continue
            if q_out < 0 or self.err[q] > 0:
                if q_out >= 0:
                    _print("Q", q_out, sum_tot, sum_err,
                           f"{sum_err2 / sum_tot2:.9f}", sum_tot2)
                sum_tot = sum_err = 0
                q_out = q
            sum_tot += self.tot[q]
            sum_err += self.err[q]
            sum_tot2 += self.tot[q]
            sum_err2 += self.err[q]
        if sum_tot2 > 0:
            _print("Q", q_out, sum_tot, sum_err,
                   f"{sum_err2 / sum_tot2:.9f}", sum_tot2)


def paf_mapeval(argv):
    """Mapping-accuracy evaluation on simulated reads (paftools.js:1453).

    Alignments are grouped per read; an alignment is correct when it hits
    the truth contig+strand and overlaps the truth interval by more than
    -r of their union. Mode 0 judges the best-scoring alignment, mode 1
    the first, mode 2 charges the error to the highest-mapq WRONG
    alignment (optionally capping mapq at the best alignment's, -c)."""
    ap = argparse.ArgumentParser(prog="paftools mapeval")
    ap.add_argument("-Q", dest="err_out_q", type=int, default=None)
    ap.add_argument("-r", dest="ovlp_ratio", type=float, default=0.1)
    ap.add_argument("-m", dest="mode", type=int, default=0)
    ap.add_argument("-c", dest="cap_short_mapq", action="store_true")
    ap.add_argument("input")
    ns = ap.parse_args(argv)
    max_mapq = 60
    err_out_q = 256 if ns.err_out_q is None else ns.err_out_q
    counts = _MapevalCounts(max_mapq)

    # per-alignment rows: [tname, st, en, strand, mapq, score]
    TN, ST, EN, STRAND, MAPQ, SCORE = range(6)

    def is_correct(truth, aln):
        """Overlap of truth and alignment intervals exceeds -r of their
        union span (asymmetric containment test of paftools.js:1475: the
        earlier-starting interval must reach past the later start)."""
        if aln[TN] != truth.tname or aln[STRAND] != truth.strand:
            return False
        s1, e1, s2, e2 = truth.st, truth.en, aln[ST], aln[EN]
        lo_st, hi_st = (s1, s2) if s1 < s2 else (s2, s1)
        first_en = e1 if s1 < s2 else e2
        if first_en <= hi_st:
            return False
        o = min(e1, e2) - hi_st
        length = max(e1, e2) - lo_st
        return o / length > ns.ovlp_ratio

    def judge_read(qname, alns):
        if not alns:
            return
        truth = _SimTruth.from_qname(qname)
        if ns.mode in (0, 1):
            best_i = 0
            if ns.mode == 0:   # best score wins; mode 1 takes the first
                best = 0
                for i, aln in enumerate(alns):
                    if aln[SCORE] > best:
                        best, best_i = aln[SCORE], i
            mapq = alns[best_i][MAPQ]
            counts.tot[mapq] += 1
            if not is_correct(truth, alns[best_i]):
                if mapq >= err_out_q:
                    _print("E", qname, *alns[best_i])
                counts.err[mapq] += 1
        elif ns.mode == 2:
            if ns.cap_short_mapq:
                best = best_q = 0
                for aln in alns:
                    if aln[SCORE] > best:
                        best, best_q = aln[SCORE], aln[MAPQ]
                for aln in alns:
                    aln[MAPQ] = min(best_q, aln[MAPQ])
            worst_err_q, top_mapq, worst_i = -1, 0, -1
            for i, aln in enumerate(alns):
                top_mapq = max(top_mapq, aln[MAPQ])
                if not is_correct(truth, aln) and aln[MAPQ] > worst_err_q:
                    worst_err_q, worst_i = aln[MAPQ], i
            if worst_err_q >= 0:
                counts.tot[worst_err_q] += 1
                counts.err[worst_err_q] += 1
                if worst_err_q >= err_out_q:
                    _print("E", qname, *alns[worst_i])
            else:
                counts.tot[top_mapq] += 1

    def sam_score(cigar, pos, line):
        """Target span, and a score = matches - mismatches when NM is
        present (NM includes gap bases, subtracted back out)."""
        pos_end, n_gap, mlen = pos, 0, 0
        for m in RE_CIGAR.finditer(cigar):
            ln, op = int(m.group(1)), m.group(2)
            if op == "M":
                pos_end += ln
                mlen += ln
            elif op == "I":
                n_gap += ln
            elif op == "D":
                n_gap += ln
                pos_end += ln
        score = pos_end - pos
        mnm = re.search(r"\tNM:i:(\d+)", line)
        if mnm and int(mnm.group(1)) >= n_gap:
            score = mlen - (int(mnm.group(1)) - n_gap)
        return pos_end, score

    last, alns, n_unmapped = None, [], None
    with _open(ns.input) as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line[0] == "@":
                continue
            t = line.split("\t")
            if t[4] in "+-":                                        # PAF
                if last != t[0]:
                    if last is not None:
                        judge_read(last, alns)
                    alns, last = [], t[0]
                if (re.search(r"\ts1:i:\d+", line)
                        and not re.search(r"\ts2:i:\d+", line)):
                    continue
                alns.append([t[5], int(t[7]), int(t[8]), t[4],
                             min(int(t[11]), max_mapq), int(t[9])])
            else:                                                   # SAM
                flag = int(t[1])
                read_no = flag >> 6 & 0x3
                qname = t[0]
                if not re.search(r"/[12]$", qname) and read_no in (1, 2):
                    qname = f"{t[0]}/{read_no}"
                if last != qname:
                    if last is not None:
                        judge_read(last, alns)
                    alns, last = [], qname
                if flag & 0x100:
                    continue
                if (flag & 4) or t[2] == "*":
                    n_unmapped = (n_unmapped or 0) + 1
                    continue
                pos = int(t[3]) - 1
                pos_end, score = sam_score(t[5], pos, line)
                alns.append([t[2], pos, pos_end,
                             "-" if flag & 16 else "+",
                             min(int(t[4]), max_mapq), score])
    if last is not None:
        judge_read(last, alns)
    counts.report()
    if n_unmapped is not None:
        _print("U", n_unmapped)


# ----------------------------------------------------------------- mason2fq

class _MasonRead:
    """One mason2-simulated SAM record with its truth coordinates
    (read-number 0 = single-end) and the XE:XS:XI error comment."""
    __slots__ = ("qname", "chrom", "st", "en", "strand", "seq", "qual",
                 "read_no", "comment")

    def __init__(self, t):
        flag = int(t[1])
        ref_span = sum(int(m.group(1)) for m in RE_CIGAR.finditer(t[5])
                       if m.group(2) in "DMN")
        if flag & 16:
            self.seq, self.qual = revcomp(t[9]), t[10][::-1]
        else:
            self.seq, self.qual = t[9], t[10]
        self.qname = re.sub(r"^simulated\.", "", t[0])
        self.chrom = t[2]
        self.st = int(t[3]) - 1
        self.en = self.st + ref_span
        self.strand = "-" if flag & 16 else "+"
        pair_bits = flag & 0xC0
        self.read_no = 1 if pair_bits == 0x40 else \
            2 if pair_bits == 0x80 else 0
        errv = snp = indel = 0
        for fld in t[11:]:
            m = re.match(r"^XE:i:(\d+)", fld)
            if m:
                errv = m.group(1)
                continue
            m = re.match(r"^XS:i:(\d+)", fld)
            if m:
                snp = m.group(1)
                continue
            m = re.match(r"^XI:i:(\d+)", fld)
            if m:
                indel = m.group(1)
        self.comment = f"{errv}:{snp}:{indel}"

    def print_se(self):
        name = "!".join(str(x) for x in
                        (self.qname, self.chrom, self.st, self.en,
                         self.strand))
        print(f"@{name} {self.comment}\n{self.seq}\n+\n{self.qual}")


def _print_mason_pair(r1, r2):
    """Emit a /1,/2 FASTQ pair whose name carries BOTH mates' truth
    coordinates (st1_st2 / en1_en2 / strand1 strand2)."""
    name = "!".join([r1.qname, r1.chrom, f"{r1.st}_{r2.st}",
                     f"{r1.en}_{r2.en}", r1.strand + r2.strand])
    print(f"@{name}/1 {r1.comment}\n{r1.seq}\n+\n{r1.qual}")
    print(f"@{name}/2 {r2.comment}\n{r2.seq}\n+\n{r2.qual}")


def paf_mason2fq(argv):
    """mason2-simulated SAM -> FASTQ with truth names (paftools.js:1622):
    adjacent records with the same name pair up; singletons emit as
    single-end."""
    ap = argparse.ArgumentParser(prog="paftools mason2fq")
    ap.add_argument("input")
    ns = ap.parse_args(argv)

    held = None
    with _open(ns.input) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("@"):
                continue
            cur = _MasonRead(t)
            if held is None:
                held = cur
            elif held.qname != cur.qname:
                held.print_se()
                held = cur
            else:
                if cur.read_no == 2:
                    if held.read_no != 1:
                        raise SystemExit("ERROR: can't find read1")
                    _print_mason_pair(held, cur)
                else:
                    if held.read_no != 2:
                        raise SystemExit("ERROR: can't find read2")
                    _print_mason_pair(cur, held)
                held = None
    if held is not None:
        held.print_se()


# ----------------------------------------------------------------- pbsim2fq

def paf_pbsim2fq(argv):
    ap = argparse.ArgumentParser(prog="paftools pbsim2fq")
    ap.add_argument("fai")
    ap.add_argument("mafs", nargs="+")
    ns = ap.parse_args(argv)

    chr_list = []
    with _open(ns.fai) as f:
        for line in f:
            chr_list.append(re.split(r"\s+", line.rstrip("\n"))[0])

    for fn in ns.mafs:
        state = 0
        reg = None
        with _open(fn) as f:
            for line in f:
                line = line.rstrip("\n")
                if state == 0 and line.startswith("a"):
                    state = 1
                elif state == 1 and line.startswith("s"):
                    t = re.split(r"\s+", line)
                    st = int(t[2])
                    reg = [st, st + int(t[3])]
                    state = 2
                elif state == 2 and line.startswith("s"):
                    t = re.split(r"\s+", line)
                    m = re.search(r"S(\d+)_\d+", t[1])
                    if m is None:
                        raise SystemExit("Failed to parse the read name")
                    chr_id = int(m.group(1)) - 1
                    if chr_id >= len(chr_list):
                        raise SystemExit("Index outside the chr list")
                    name = "!".join(map(str, [t[1], chr_list[chr_id],
                                              reg[0], reg[1], t[4]]))
                    seq = t[6].replace("-", "")
                    if len(seq) != int(t[5]):
                        raise SystemExit("Inconsistent read length")
                    if "NN" not in seq:
                        if t[4] == "-":
                            seq = revcomp(seq)
                        print(">" + name)
                        print(seq)
                    state = 0


# ----------------------------------------------------------------- junceval

def _gtf_introns(gtf_path):
    """chrom -> sorted, deduped, overlap-query-ready intron intervals from
    a GTF's exon rows (intron = gap between consecutive exons of one
    transcript). Parity note: the reference (paftools.js:1782) appends the
    intron inside its overlap-warning branch body due to mis-indentation,
    which executes unconditionally — so every exon gap is kept, warned or
    not."""
    exons_by_tid = {}
    chrom_of = {}
    with _open(gtf_path) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#") or len(t) < 9 or t[2] != "exon":
                continue
            m = re.search(r'transcript_id "(\S+)"', t[8])
            if m is None:
                continue
            tid = m.group(1)
            chrom_of.setdefault(tid, t[0])
            exons_by_tid.setdefault(tid, []).append(
                [int(t[3]) - 1, int(t[4])])

    anno = {}
    for tid, exons in exons_by_tid.items():
        intv_sort(exons)
        introns = anno.setdefault(chrom_of[tid], [])
        for left, right in zip(exons, exons[1:]):
            if left[1] >= right[0]:
                _warn("WARNING: incorrect annotation for transcript "
                      f"{tid} ({left[1]} >= {right[0]})")
            introns.append([left[1], right[0]])
    for introns in anno.values():
        if introns:
            intv_sort(introns)
            intv_dedup(introns)
            intv_index_end(introns)
    return anno


def _cigar_introns(cigar, pos):
    """(start, end) reference intervals of the N operators in a CIGAR."""
    introns = []
    for m in RE_CIGAR.finditer(cigar):
        ln, op = int(m.group(1)), m.group(2)
        if op == "N":
            introns.append((pos, pos + ln))
            pos += ln
        elif op in "MX=D":
            pos += ln
    return introns


def paf_junceval(argv):
    """Splice-junction accuracy of SAM alignments vs a GTF annotation
    (paftools.js:1759): each predicted intron either matches an annotated
    one within -l fuzz (correct), overlaps without matching, or overlaps
    nothing (novel). -p prints per-intron verdict rows (C/P/N), -e only
    the wrong ones."""
    ap = argparse.ArgumentParser(prog="paftools junceval")
    ap.add_argument("-l", dest="l_fuzzy", type=int, default=0)
    ap.add_argument("-e", dest="err_only", action="store_true")
    ap.add_argument("-p", dest="print_ovlp", action="store_true")
    ap.add_argument("-c", dest="chr_only", action="store_true")
    ap.add_argument("gtf")
    ap.add_argument("sam", nargs="?", default="-")
    ns = ap.parse_args(argv)
    print_ovlp = ns.print_ovlp or ns.err_only

    anno = _gtf_introns(ns.gtf)

    n_pri = n_unmapped = n_mapped = 0
    n_sgl = n_splice = n_splice_hit = n_splice_novel = 0
    last_qname = None
    with _open(ns.sam) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("@"):
                continue
            if ns.chr_only and not re.match(r"^(chr)?([0-9]+|X|Y)$", t[2]):
                continue
            flag = int(t[1])
            if flag & 0x100:
                continue
            if t[2] == "*":
                n_unmapped += 1
                continue
            n_pri += 1
            if last_qname != t[0]:
                n_mapped += 1
                last_qname = t[0]

            introns = _cigar_introns(t[5], int(t[3]) - 1)
            if not introns:
                n_sgl += 1
                continue
            n_splice += len(introns)
            chrom_introns = anno.get(t[2])
            if chrom_introns is None:
                n_splice_novel += len(introns)
                continue
            for i, (ist, ien) in enumerate(introns):
                ovlps = intv_find_ovlp(chrom_introns, ist, ien)
                if not ovlps:
                    n_splice_novel += 1
                    if print_ovlp:
                        _print("N", t[0], i + 1, t[2], ist, ien)
                    continue
                hit = any(abs(ist - o[0]) <= ns.l_fuzzy
                          and abs(ien - o[1]) <= ns.l_fuzzy
                          for o in ovlps)
                if hit:
                    n_splice_hit += 1
                if print_ovlp:
                    if hit and ns.err_only:
                        continue
                    shown = "[" + ", ".join(f"({o[0]},{o[1]})"
                                            for o in ovlps) + "]"
                    _print("C" if hit else "P", t[0], i + 1, t[2],
                           ist, ien, shown)

    if not print_ovlp:
        print(f"# unmapped reads: {n_unmapped}")
        print(f"# mapped reads: {n_mapped}")
        print(f"# primary alignments: {n_pri}")
        print(f"# singletons: {n_sgl}")
        print(f"# predicted introns: {n_splice}")
        print(f"# non-overlapping introns: {n_splice_novel}")
        pct = n_splice_hit / n_splice * 100 if n_splice else float("nan")
        print(f"# correct introns: {n_splice_hit} ({pct:.2f}%)")


# ------------------------------------------------------------------ ov-eval

def paf_ov_eval(argv):
    """Read-overlap sensitivity (paftools.js:1915): infer true overlaps
    from a position-sorted read-to-reference PAF (a sliding window of
    still-open reference spans; any two reads co-spanning >= -l bases
    truly overlap), then mark which of those pairs the read overlapper
    found. Sensitivity = found / inferred."""
    ap = argparse.ArgumentParser(prog="paftools ov-eval")
    ap.add_argument("-l", dest="min_ovlp", type=int, default=2000)
    ap.add_argument("-f", dest="min_frac", type=float, default=0.95)
    ap.add_argument("-q", dest="min_mapq", type=int, default=10)
    ap.add_argument("to_ref_paf")
    ap.add_argument("ovlp_paf")
    ns = ap.parse_args(argv)

    open_spans = []          # [ctg, st, en, qname] not yet past the cursor
    truth = {}               # (nameA, nameB) -> overlap len (<0 once found)
    with _open(ns.to_ref_paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            if int(t[11]) < ns.min_mapq or "tp:A:P" not in t[12:]:
                continue
            qname, qlen = t[0], int(t[1])
            qst, qen = int(t[2]), int(t[3])
            ctg, st, en = t[5], int(t[7]), int(t[8])
            if (qen - qst < ns.min_ovlp or en - st < ns.min_ovlp
                    or (qen - qst) / qlen < ns.min_frac):
                continue
            while open_spans and not (open_spans[0][0] == ctg
                                      and open_spans[0][2] > st):
                open_spans.pop(0)
            for _ctg, _st, o_en, o_name in open_spans:
                if o_name == qname:
                    continue
                ln = min(en, o_en) - st
                if ln >= ns.min_ovlp:
                    truth[(min(o_name, qname), max(o_name, qname))] = ln
            open_spans.append([ctg, st, en, qname])

    with _open(ns.ovlp_paf) as f:
        for line in f:
            t = line.rstrip("\n").split("\t")
            key = (min(t[0], t[5]), max(t[0], t[5]))
            if truth.get(key, 0) > 0:
                truth[key] = -truth[key]

    n_ovlp = len(truth)
    n_missing = sum(1 for v in truth.values() if v > 0)
    print(f"{n_ovlp} overlaps inferred from the reference mapping")
    print(f"{n_missing} missed by the read overlapper")
    sens = 100 * (1 - n_missing / n_ovlp) if n_ovlp else float("nan")
    print(f"{sens:.2f}% sensitivity")


# --------------------------------------------------------------------- main

_COMMANDS = {
    "view": paf_view,
    "sam2paf": paf_sam2paf,
    "delta2paf": paf_delta2paf,
    "splice2bed": paf_splice2bed,
    "gff2bed": paf_gff2bed,
    "stat": paf_stat,
    "liftover": paf_liftover,
    "liftOver": paf_liftover,
    "call": paf_call,
    "mapeval": paf_mapeval,
    "bedcov": paf_bedcov,
    "mason2fq": paf_mason2fq,
    "pbsim2fq": paf_pbsim2fq,
    "junceval": paf_junceval,
    "ov-eval": paf_ov_eval,
}

_USAGE = """Usage: paftools <command> [arguments]
Commands:
  view       convert PAF to BLAST-like (for eyeballing) or MAF
  splice2bed convert spliced alignment in PAF/SAM to BED12
  sam2paf    convert SAM to PAF
  delta2paf  convert MUMmer's delta to PAF
  gff2bed    convert GTF/GFF3 to BED12

  stat       collect basic mapping information in PAF/SAM
  liftover   simplistic liftOver
  call       call variants from asm-to-ref alignment with the cs tag
  bedcov     compute the number of bases covered
  version    print paftools version

  mapeval    evaluate mapping accuracy using mason2/PBSIM-simulated FASTQ
  mason2fq   convert mason2-simulated SAM to FASTQ
  pbsim2fq   convert PBSIM-simulated MAF to FASTQ
  junceval   evaluate splice junction consistency with known annotations
  ov-eval    evaluate read overlap sensitivity using read-to-ref mapping"""


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(_USAGE)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(VERSION)
        return 0
    fn = _COMMANDS.get(cmd)
    if fn is None:
        raise SystemExit(f"unrecognized command: {cmd}")
    fn(rest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
