# Frozen copy of minimap2_chaindp_tpu/models/pipeline.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/models/pipeline.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""End-to-end mapping pipeline (host reference path).

Mirrors the per-read flow of reference map.c: collect minimizers -> seed hits
-> chaining DP -> gen_regs -> chain_post -> est_err -> base alignment ->
mapq -> (multi-seg split + pairing) -> SAM/PAF text.

This host path is the golden model; the device (JAX/Pallas) path plugs in at
the sketch / seed-collect / chain / extend stages (models/device_pipeline.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as C
from .. import hits as H
from ..esterr import est_err
from ..io import output as out
from ..io.fastx import SeqRecord
from ..ops.chain import chain_dp
from ..ops.seeds import collect_minimizers, collect_seed_hits
from ..utils import mlog


def _print_chain_anchors(mi, regs, a) -> None:
    """--print-seeds CN\\t... chain-anchor dump (reference map.c:864-868)."""
    import sys
    i32 = lambda v: int(np.int32(np.uint64(v) & np.uint64(0xFFFFFFFF)))
    for j, r in enumerate(regs):
        for i in range(r.as_, r.as_ + r.cnt):
            x, y = int(a[i, 0]), int(a[i, 1])
            gap = 0 if i == r.as_ else \
                (i32(y) - i32(a[i - 1, 1])) - (i32(x) - i32(a[i - 1, 0]))
            print(f"CN\t{j}\t{mi.seqs[(x & 0x7FFFFFFFFFFFFFFF) >> 32].name}"
                  f"\t{i32(x)}\t{'+-'[x >> 63]}\t{i32(y)}"
                  f"\t{(y >> 32) & 0xFF}\t{gap}", file=sys.stderr)


def chain_post(opt, max_chain_gap_ref, mi, qlen_sum, n_segs, qlens, regs, a):
    """reference chain_post (map.c:238-247)."""
    if not (opt.flag & C.MM_F_ALL_CHAINS):
        H.set_parent(regs, opt.mask_level, opt.a * 2 + opt.b)
        if n_segs <= 1:
            regs = H.select_sub(regs, opt.pri_ratio, mi.k * 2, opt.best_n)
        else:
            from ..pe import select_sub_multi
            regs = select_sub_multi(regs, opt.pri_ratio, 0.2, 0.7,
                                    max_chain_gap_ref, mi.k * 2, opt.best_n,
                                    n_segs, qlens)
        if not (opt.flag & (C.MM_F_SPLICE | C.MM_F_SR | C.MM_F_NO_LJOIN)):
            regs = H.join_long(regs, opt, qlen_sum, a)
    return regs


def _align_regs_post(opt, mi, regs):
    if not (opt.flag & C.MM_F_ALL_CHAINS):
        H.set_parent(regs, opt.mask_level, opt.a * 2 + opt.b)
        regs = H.select_sub(regs, opt.pri_ratio, mi.k * 2, opt.best_n)
        H.set_sam_pri(regs)
    return regs


def align_regs_gen(opt, mi, qlen, seq, regs, a):
    """Generator form of align_regs for the cross-read batch scheduler:
    yields extension-job waves (see align.align1_gen), returns final regs."""
    from ..align import align_skeleton_gen
    if not (opt.flag & C.MM_F_CIGAR):
        return regs
    regs = yield from align_skeleton_gen(opt, mi, qlen, seq, regs, a)
    return _align_regs_post(opt, mi, regs)


def compute_gap_bounds(opt, qlen_sum: int) -> tuple[int, int]:
    """max chaining gaps (reference map.c:357-366)."""
    if opt.flag & C.MM_F_SR:
        max_chain_gap_qry = max(qlen_sum, opt.max_gap)
    else:
        max_chain_gap_qry = opt.max_gap
    if opt.max_gap_ref > 0:
        max_chain_gap_ref = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        max_chain_gap_ref = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        max_chain_gap_ref = opt.max_gap
    return max_chain_gap_qry, max_chain_gap_ref


@dataclass
class UnitInfo:
    """Per-unit seeding state carried from seed_unit to finish_unit_gen."""
    segs: list
    qlens: list
    seqs: list
    qlen_sum: int
    hash_: int
    gap_qry: int
    gap_ref: int
    sh: object          # SeedHits or None (no minimizers / empty)
    mv: object = None   # query minimizers (kept for device seed collection)


def seed_unit(mi, opt, segs: list[SeqRecord],
              collect_hits: bool = True) -> UnitInfo:
    """Front half of mm_map_frag: sketch + seed-hit collection (map.c:326-390).
    collect_hits=False stops after sketching (the device runtime batches the
    index lookups across reads instead)."""
    qlens = [len(s.seq) for s in segs]
    seqs = [s.seq for s in segs]
    qlen_sum = sum(qlens)
    qname = segs[0].name
    gq, gr = compute_gap_bounds(opt, qlen_sum)
    info = UnitInfo(segs, qlens, seqs, qlen_sum,
                    C.qname_hash(qname, qlen_sum, opt.seed), gq, gr, None)
    if qlen_sum == 0 or not (0 < len(segs) <= C.MM_MAX_SEG):
        return info
    mv = collect_minimizers(opt, mi, seqs)
    info.mv = mv
    if len(mv) and collect_hits:
        info.sh = collect_seed_hits(mi, opt.flag, opt.mid_occ, mv, qname,
                                    qlen_sum)
    return info


def finish_unit_gen(mi, opt, info: UnitInfo, ch):
    """Back half (read_result_handle, map.c:816-898) as a wave generator:
    regions -> chain_post -> est_err -> per-seg alignment (yielding extension
    waves) -> mapq -> PE pairing. Returns per-segment region lists."""
    n_segs = len(info.segs)
    if info.sh is None or ch is None or not len(ch.u):
        return [[] for _ in info.segs]
    is_sr = bool(opt.flag & C.MM_F_SR)
    a, u = ch.anchors.copy(), ch.u
    regs0 = H.gen_regs(info.hash_, info.qlen_sum, u, a)
    if mlog.dbg_flag & C.MM_DBG_PRINT_SEED:
        _print_chain_anchors(mi, regs0, a)
    regs0 = chain_post(opt, info.gap_ref, mi, info.qlen_sum, n_segs,
                       info.qlens, regs0, a)
    if not is_sr:
        est_err(mi, info.qlen_sum, regs0, a, info.sh.mini_pos)

    if n_segs == 1:
        regs0 = yield from align_regs_gen(opt, mi, info.qlens[0],
                                          info.seqs[0], regs0, a)
        H.set_mapq(regs0, opt.min_chain_score, opt.a, info.sh.rep_len, is_sr)
        return [regs0]
    from ..pe import seg_gen, pair
    per_seg = seg_gen(info.hash_, n_segs, info.qlens, regs0, a)
    all_regs = []
    for i, (regs_i, a_i) in enumerate(per_seg):
        H.set_parent(regs_i, opt.mask_level, opt.a * 2 + opt.b)
        regs_i = yield from align_regs_gen(opt, mi, info.qlens[i],
                                           info.seqs[i], regs_i, a_i)
        H.set_mapq(regs_i, opt.min_chain_score, opt.a, info.sh.rep_len, is_sr)
        all_regs.append(regs_i)
    if n_segs == 2 and opt.pe_ori >= 0 and (opt.flag & C.MM_F_CIGAR):
        pair(info.gap_ref, opt.pe_bonus, opt.a * 2 + opt.b, opt.a,
             info.qlens, all_regs)
    return all_regs


def host_chain(opt, info: UnitInfo, n_segs: int):
    """Host (exact) chaining of one unit (native C++ scan when available)."""
    if info.sh is None:
        return None
    from ..nonative import chain_dp_native
    ch = chain_dp_native(info.gap_ref, info.gap_qry, opt.bw,
                         opt.max_chain_skip, opt.min_cnt,
                         opt.min_chain_score,
                         bool(opt.flag & C.MM_F_SPLICE), n_segs,
                         info.sh.anchors)
    if ch is not None:
        return ch
    return chain_dp(info.gap_ref, info.gap_qry, opt.bw, opt.max_chain_skip,
                    opt.min_cnt, opt.min_chain_score,
                    bool(opt.flag & C.MM_F_SPLICE), n_segs, info.sh.anchors)


def map_frag(mi, opt, segs: list[SeqRecord]) -> list[list[H.Region]]:
    """Map one fragment (1..n segments). Returns per-segment region lists.

    Mirrors mm_map_frag front half (map.c:326-445) + read_result_handle back
    half (map.c:816-898); synchronous driver of seed_unit/finish_unit_gen."""
    from ..align import K, _host_thunk
    if len(segs) == 1:
        from ..nonative import map_unit_native, map_unit_ok
        if map_unit_ok(opt, mi):
            res = map_unit_native(mi, opt, segs[0].name, segs[0].seq)
            if res is not None:
                return [res[0]]
    info = seed_unit(mi, opt, segs)
    ch = host_chain(opt, info, len(segs))
    mat = K.gen_simple_mat(5, opt.a, opt.b)
    gen = finish_unit_gen(mi, opt, info, ch)
    try:
        wave = next(gen)
        while True:
            wave = gen.send([_host_thunk(opt, mat, job) for job in wave])
    except StopIteration as e:
        return e.value


def prepare_frag(opt, segs: list[SeqRecord]):
    """PE-orientation flip + independent-segment split (map.c:598-667).
    Returns (work, flipped, units) where each unit maps as one chain job."""
    pe_ori = opt.pe_ori
    n_segs = len(segs)
    flipped = []
    work = list(segs)
    for j in range(n_segs):
        if n_segs == 2 and ((j == 0 and (pe_ori >> 1 & 1))
                            or (j == 1 and (pe_ori & 1))):
            work[j] = SeqRecord(work[j].name, C.revcomp_str(work[j].seq),
                                work[j].qual[::-1] if work[j].qual else None,
                                work[j].comment)
            flipped.append(j)
    if opt.flag & C.MM_F_INDEPEND_SEG:
        units = [[s] for s in work]
    else:
        units = [work]
    return work, flipped, units


def format_frag(mi, opt, segs, work, flipped, regss, rg_id="") -> list[str]:
    """Flip PE hits back + SAM/PAF text (map.c:620-631, 734-752)."""
    n_segs = len(segs)
    for j in flipped:
        qlen = len(work[j].seq)
        for r in regss[j]:
            r.qs, r.qe = qlen - r.qe, qlen - r.qs
            r.rev = 1 - r.rev
    lines = []
    for i, rec in enumerate(segs):
        regs = regss[i]
        for j, r in enumerate(regs):
            if (opt.flag & C.MM_F_NO_PRINT_2ND) and r.id != r.parent:
                continue
            if opt.flag & C.MM_F_OUT_SAM:
                lines.append(out.write_sam(mi, rec, i, j, n_segs, regss,
                                           opt.flag, rg_id))
            else:
                lines.append(out.write_paf(mi, rec, r, opt.flag))
        if not regs and (opt.flag & C.MM_F_OUT_SAM):
            lines.append(out.write_sam(mi, rec, i, -1, n_segs, regss,
                                       opt.flag, rg_id))
    return lines


def map_fragment_output(mi, opt, segs: list[SeqRecord], rg_id: str = "") -> list[str]:
    """Map one fragment and format its output lines (reference map.c:734-752)."""
    work, flipped, units = prepare_frag(opt, segs)
    regss = []
    for unit in units:
        regss.extend(map_frag(mi, opt, unit))
    return format_frag(mi, opt, segs, work, flipped, regss, rg_id)
