"""Index checkpointing: dump/load of the device-resident CSR tables.

Replaces the reference's .mmi khash serialization (index.c:785-874) with a
flat-table format — the same role the fork's B/H/V/P FPGA images play
(index.c:603-720): the expensive index build happens once, then loads are a
handful of bulk array reads straight into device-uploadable buffers.

Format (little-endian):
  magic "MM2TPU\\x01" | k w flag b n_seq (int32 x5)
  per seq: name_len int32, name bytes, length int32
  S uint8[total_bases]  (nt4 codes)
  n_keys int64, keys uint64[n_keys], starts int64[n_keys+1]
  n_vals int64, values uint64[n_vals]
"""
from __future__ import annotations

import struct

import numpy as np

from .build import MinimizerIndex, RefSeq

MAGIC = b"MM2TPU\x01"


def set_name_tables(mi: MinimizerIndex, names: list[str]) -> None:
    """Lexicographic name-rank tables for ava-mode self/dual skipping
    (reference rname_rid/rever_rid, index.c:560-592)."""
    order = sorted(range(len(names)), key=lambda i: names[i])
    mi.sorted_names = [names[i] for i in order]
    rank = np.empty(len(names), dtype=np.int64)
    rank[np.asarray(order, dtype=np.int64)] = np.arange(len(names),
                                                        dtype=np.int64)
    mi.name_rank = rank


def dump_index_auto(mi: MinimizerIndex, path: str) -> None:
    """Dump one index part, stock .mmi format when the path ends in .mmi,
    native .mm2i otherwise."""
    if path.endswith(".mmi"):
        with open(path, "wb") as f:
            dump_mmi(mi, f)
    else:
        dump_index(mi, path)


def dump_index(mi: MinimizerIndex, path: str) -> None:
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<5i", mi.k, mi.w, mi.flag, mi.b, mi.n_seq))
        for s in mi.seqs:
            nb = s.name.encode()
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            # <I like stock .mmi: contigs may exceed 2^31 bp (<= 4 Gbp)
            f.write(struct.pack("<I", s.length))
        # tofile, not f.write(tobytes()): tobytes materializes a second
        # GB-scale copy of each table and streams it through Python's
        # buffered write — measured 134 MB/s and 2x transient RSS vs
        # tofile's 3.3 GB/s straight from the array buffer (the r3 3 Gbp
        # dump took 1011 s this way; reference analog: flat fwrite,
        # index.c:785-822)
        if not (mi.flag & 0x2):    # MM_I_NO_SEQ dumps write no S
            mi.S.astype(np.uint8, copy=False).tofile(f)
        f.write(struct.pack("<q", len(mi.keys)))
        # copy=False: these GB-scale tables are already little-endian on
        # every supported host; a default astype would double peak RSS
        mi.keys.astype("<u8", copy=False).tofile(f)
        mi.starts.astype("<i8", copy=False).tofile(f)
        f.write(struct.pack("<q", len(mi.values)))
        mi.values.astype("<u8", copy=False).tofile(f)


def load_index(path: str, mmap: bool | None = None) -> MinimizerIndex:
    """Load a .mm2i part.  `mmap` (default: MM2TPU_MMAP_INDEX env, on)
    maps the GB-scale tables (S/keys/starts/values) read-only straight
    from the file instead of eagerly copying them into anonymous memory:
    load returns in milliseconds regardless of index size, pages fault in
    on first touch at page-cache/disk speed, and a memory-pressured host
    can evict them (they are file-backed) — the streaming-load posture of
    the reference's flat fread .mmi (index.c:823-874), taken further.
    Nothing mutates these tables after build, so read-only is safe for
    every consumer (numpy, ctypes pointers into the mapping, device_put).
    """
    if mmap is None:
        import os
        mmap = os.environ.get("MM2TPU_MMAP_INDEX", "1") == "1"
    with open(path, "rb") as f:
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError(f"{path}: not an mm2tpu index")
        k, w, flag, b, n_seq = struct.unpack("<5i", f.read(20))
        mi = MinimizerIndex(k=k, w=w, flag=flag, b=b)
        names = []
        off = 0

        def _read(n, what):
            buf = f.read(n)
            if len(buf) != n:          # truncated mid-section: fail loud
                raise ValueError(f"{path}: truncated index ({what})")
            return buf

        for _ in range(n_seq):
            (nl,) = struct.unpack("<i", _read(4, "name_len"))
            name = _read(nl, "name").decode()
            (length,) = struct.unpack("<I", _read(4, "seq_len"))
            mi.seqs.append(RefSeq(name=name, offset=off, length=length))
            names.append(name)
            off += length

        def _table(dtype, n, what):
            """One flat table at the current offset: memmap view or eager
            fromfile read (both leave the stream positioned after it)."""
            dt = np.dtype(dtype)
            if mmap:
                pos = f.tell()
                try:
                    arr = np.memmap(path, dtype=dt, mode="r", offset=pos,
                                    shape=(n,))
                except ValueError as e:   # file too small for the table
                    raise ValueError(
                        f"{path}: truncated index ({what}): {e}") from None
                f.seek(n * dt.itemsize, 1)
                return arr
            arr = np.fromfile(f, dtype=dt, count=n)
            if len(arr) != n:
                raise ValueError(f"{path}: truncated index ({what})")
            return arr

        if not (flag & 0x2):           # MM_I_NO_SEQ parts carry no S
            mi.S = _table(np.uint8, off, "S")
        (n_keys,) = struct.unpack("<q", _read(8, "n_keys"))
        mi.keys = _table("<u8", n_keys, "keys")
        mi.starts = _table("<i8", n_keys + 1, "starts")
        (n_vals,) = struct.unpack("<q", _read(8, "n_vals"))
        mi.values = _table("<u8", n_vals, "values")
        set_name_tables(mi, names)
    return mi


def is_mm2tpu_index(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(len(MAGIC)) == MAGIC
    except OSError:
        return False


# ---------------------------------------------------------------------------
# Stock minimap2 .mmi interop (MMI\2, reference index.c:785-874, minimap.h:39)
#
# Layout: magic | w k b n_seq flag (u32 x5) | per-seq u8 name_len, name,
# u32 len | per-bucket (2^b): u32 n, p u64[n], u32 size, size x (key, val)
# u64 pairs | packed 4-bit S as u32 words (8 bases/word) unless MM_I_NO_SEQ.
# Hash keys are bucket-local: kh_key = (minier >> b) << 1, low bit 1 when
# the single occurrence is stored inline in kh_val; otherwise kh_val =
# start<<32|n into the bucket's p[] (index.c:377-404). Values use the STOCK
# encoding rid<<32|pos<<1|strand — the same encoding this framework uses
# internally — NOT the fork's 21/21/21-bit repack, so indexes dumped here
# load in stock minimap2 v2.10 and vice versa. Multi-part .mmi files are
# successive dumps in one stream (mm_idx_reader_read index.c:921-939).
# ---------------------------------------------------------------------------

MMI_MAGIC = b"MMI\x02"


def is_mmi_index(path: str) -> bool:
    try:
        with open(path, "rb") as f:
            return f.read(4) == MMI_MAGIC
    except OSError:
        return False


def _pack_seq4(S: np.ndarray) -> np.ndarray:
    """nt4 byte codes -> packed 4-bit u32 words (mm_seq4_set, mmpriv.h:30).
    Chunked: the naive uint32 temporaries cost ~8 bytes/base — ~24 GB
    transient for a GRCh38-scale S — so work in 64 Mbase blocks."""
    n = len(S)
    out = np.empty((n + 7) // 8, dtype=np.uint32)
    shifts = np.arange(8, dtype=np.uint32) * 4
    CH = 64 << 20
    for lo in range(0, n, CH):
        blk = S[lo:lo + CH]
        pad = (-len(blk)) % 8
        sb = np.concatenate([blk.astype(np.uint32),
                             np.zeros(pad, np.uint32)]).reshape(-1, 8)
        out[lo // 8:lo // 8 + len(sb)] = (sb << shifts).sum(
            axis=1, dtype=np.uint32)
    return out


def _unpack_seq4(words: np.ndarray, n: int) -> np.ndarray:
    """Packed 4-bit u32 words -> nt4 byte codes (mm_seq4_get, mmpriv.h:29).
    Chunked like _pack_seq4 to bound the uint32 temporaries."""
    out = np.empty(8 * len(words), dtype=np.uint8)
    shifts = np.arange(8, dtype=np.uint32) * 4
    CH = 8 << 20     # words per block = 64 Mbase
    for lo in range(0, len(words), CH):
        w = words[lo:lo + CH]
        s = (w[:, None] >> shifts) & np.uint32(0xF)
        out[8 * lo:8 * lo + s.size] = s.reshape(-1).astype(np.uint8)
    return out[:n]


def _ragged_gather(values, starts, rows, row_cnt):
    """Concatenate values[starts[r]:starts[r]+row_cnt_of_r] over `rows`,
    vectorized (the CSR slices for the given rows, in row order)."""
    cnt = row_cnt[rows]
    total = int(cnt.sum())
    if total == 0:
        return np.empty(0, values.dtype)
    offs = np.concatenate([[0], np.cumsum(cnt)])
    ridx = np.repeat(np.arange(len(rows)), cnt)
    within = np.arange(total, dtype=np.int64) - np.repeat(offs[:-1], cnt)
    return values[starts[rows][ridx] + within]


def dump_mmi(mi: MinimizerIndex, f) -> None:
    """Append one stock-format .mmi part to an open binary file."""
    f.write(MMI_MAGIC)
    f.write(struct.pack("<5I", mi.w, mi.k, mi.b, mi.n_seq, mi.flag))
    for s in mi.seqs:
        nb = s.name.encode()
        # stock writes `uint8_t l = strlen(name)` (index.c:790-793): names
        # over 255 bytes wrap mod 256 and only that prefix is stored —
        # replicated so the stream stays loadable either way
        nl = len(nb) & 0xFF
        f.write(struct.pack("<B", nl))
        f.write(nb[:nl])
        f.write(struct.pack("<I", s.length))
    nb_buckets = 1 << mi.b
    bucket_of = (mi.keys & np.uint64(nb_buckets - 1)).astype(np.int64)
    cnt = np.diff(mi.starts)
    order = np.argsort(bucket_of, kind="stable")
    bounds = np.searchsorted(bucket_of[order],
                             np.arange(nb_buckets + 1, dtype=np.int64))
    for i in range(nb_buckets):
        sel = order[bounds[i]:bounds[i + 1]]
        multi = sel[cnt[sel] > 1]
        # p[] = concatenated multi-occurrence lists (position-sorted, as
        # our CSR already is per index.c:394)
        p = _ragged_gather(mi.values, mi.starts, multi, cnt)
        f.write(struct.pack("<I", len(p)))
        f.write(p.astype("<u8").tobytes())
        f.write(struct.pack("<I", len(sel)))
        if not len(sel):
            continue
        is_multi = cnt[sel] > 1
        kh = np.empty((len(sel), 2), dtype="<u8")
        kh[:, 0] = ((mi.keys[sel] >> np.uint64(mi.b)) << np.uint64(1)) \
            | np.uint64(1) * ~is_multi
        m_cnt = cnt[multi]
        start_p = np.concatenate([[0], np.cumsum(m_cnt)[:-1]]) \
            if len(multi) else np.empty(0, np.int64)
        kh[is_multi, 1] = (start_p.astype(np.uint64) << np.uint64(32)) \
            | m_cnt.astype(np.uint64)
        kh[~is_multi, 1] = mi.values[mi.starts[sel[~is_multi]]]
        f.write(kh.tobytes())
    if not (mi.flag & 0x2):  # MM_I_NO_SEQ
        f.write(_pack_seq4(mi.S).astype("<u4").tobytes())
    f.flush()


def load_mmi_parts(path: str):
    """Yield MinimizerIndex parts from a stock .mmi file (mm_idx_load,
    index.c:823-874; multi-part files are successive dumps)."""
    with open(path, "rb") as f:
        while True:
            magic = f.read(4)
            if len(magic) < 4:
                return
            if magic != MMI_MAGIC:
                raise ValueError(f"{path}: bad .mmi part magic")
            w, k, b, n_seq, flag = struct.unpack("<5I", f.read(20))
            mi = MinimizerIndex(k=k, w=w, flag=flag, b=b)
            names, off = [], 0
            for _ in range(n_seq):
                (nl,) = struct.unpack("<B", f.read(1))
                name = f.read(nl).decode()
                (length,) = struct.unpack("<I", f.read(4))
                mi.seqs.append(RefSeq(name=name, offset=off, length=length))
                names.append(name)
                off += length
            key_parts, cnt_parts, val_parts = [], [], []
            for i in range(1 << b):
                (n_p,) = struct.unpack("<I", f.read(4))
                p = np.frombuffer(f.read(8 * n_p), dtype="<u8")
                (size,) = struct.unpack("<I", f.read(4))
                if size == 0:
                    continue
                kh = np.frombuffer(f.read(16 * size),
                                   dtype="<u8").reshape(size, 2)
                single = (kh[:, 0] & np.uint64(1)).astype(bool)
                key_parts.append(((kh[:, 0] >> np.uint64(1))
                                  << np.uint64(b)) | np.uint64(i))
                n_occ = np.where(single, 1,
                                 kh[:, 1] & np.uint64(0xFFFFFFFF)
                                 ).astype(np.int64)
                st = (kh[:, 1] >> np.uint64(32)).astype(np.int64)
                total = int(n_occ.sum())
                offs = np.concatenate([[0], np.cumsum(n_occ)])
                ridx = np.repeat(np.arange(size), n_occ)
                within = np.arange(total, dtype=np.int64) \
                    - np.repeat(offs[:-1], n_occ)
                pv = p[np.minimum(st[ridx] + within,
                                  max(len(p) - 1, 0))] \
                    if len(p) else np.zeros(total, np.uint64)
                val_parts.append(np.where(single[ridx], kh[ridx, 1], pv))
                cnt_parts.append(n_occ)
            if key_parts:
                keys = np.concatenate(key_parts)
                cnts = np.concatenate(cnt_parts)
                vals = np.concatenate(val_parts)
                order = np.argsort(keys, kind="stable")
                mi.keys = keys[order]
                new_cnt = cnts[order]
                mi.starts = np.concatenate(
                    [[0], np.cumsum(new_cnt)]).astype(np.int64)
                old_starts = np.concatenate(
                    [[0], np.cumsum(cnts)]).astype(np.int64)
                mi.values = _ragged_gather(vals, old_starts, order, cnts)
            if not (flag & 0x2):  # MM_I_NO_SEQ
                n_words = (off + 7) // 8
                # fromfile, not read+frombuffer: skips a GB-scale bytes
                # intermediate at genome scale
                mi.S = _unpack_seq4(np.fromfile(f, "<u4", n_words), off)
            set_name_tables(mi, names)
            yield mi
