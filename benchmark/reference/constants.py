# Frozen copy of minimap2_chaindp_tpu/constants.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/constants.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Shared constants and encodings for the TPU-native seed-chain-extend aligner.

Data encodings follow the stock minimap2 forms documented in SURVEY.md (appendix):
  minimizer: x = hash64(kmer)<<8 | span ; y = rid<<32 | last_pos<<1 | strand
  anchor:    x = rev<<63 | rid<<32 | rpos ; y = flags | seg_id<<48 | span<<32 | qpos
  chain u64: score<<32 | n_anchors
(reference sketch.c:71-74, map.c:216-229, chain.c:174-176)
"""
from __future__ import annotations

import numpy as np

# --- mapping flags (reference minimap.h:8-33) ---
MM_F_NO_DIAG = 0x001
MM_F_NO_DUAL = 0x002
MM_F_CIGAR = 0x004
MM_F_OUT_SAM = 0x008
MM_F_NO_QUAL = 0x010
MM_F_OUT_CG = 0x020
MM_F_OUT_CS = 0x040
MM_F_SPLICE = 0x080
MM_F_SPLICE_FOR = 0x100
MM_F_SPLICE_REV = 0x200
MM_F_NO_LJOIN = 0x400
MM_F_OUT_CS_LONG = 0x800
MM_F_SR = 0x1000
MM_F_FRAG_MODE = 0x2000
MM_F_NO_PRINT_2ND = 0x4000
MM_F_2_IO_THREADS = 0x8000
MM_F_LONG_CIGAR = 0x10000
MM_F_INDEPEND_SEG = 0x20000
MM_F_SPLICE_FLANK = 0x40000
MM_F_SOFTCLIP = 0x80000
MM_F_FOR_ONLY = 0x100000
MM_F_REV_ONLY = 0x200000
MM_F_HEAP_SORT = 0x400000
MM_F_ALL_CHAINS = 0x800000
MM_F_OUT_MD = 0x1000000
MM_F_COPY_COMMENT = 0x2000000

# --- index flags (reference minimap.h:35-37) ---
MM_I_HPC = 0x1
MM_I_NO_SEQ = 0x2
MM_I_NO_NAME = 0x4

MM_MAX_SEG = 255

# --- seed flags on anchor.y (reference mmpriv.h:16-23) ---
MM_SEED_LONG_JOIN = 1 << 40
MM_SEED_IGNORE = 1 << 41
MM_SEED_TANDEM = 1 << 42
MM_SEED_SELF = 1 << 43
MM_SEED_SEG_SHIFT = 48
MM_SEED_SEG_MASK = 0xFF << MM_SEED_SEG_SHIFT

MM_PARENT_UNSET = -1
MM_PARENT_TMP_PRI = -2

# --- debug-dump bits (reference mmpriv.h:11-14 mm_dbg_flag) ---
MM_DBG_PRINT_QNAME = 0x2
MM_DBG_PRINT_SEED = 0x4
MM_DBG_PRINT_ALN_SEQ = 0x8

# --- CIGAR ops (reference ksw2.h comment; SAM spec order MIDNSHP=X) ---
CIGAR_STR = "MIDNSHP=X"

U64 = np.uint64
UINT64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)

# --- base encodings ---
# nt4: A/a=0 C/c=1 G/g=2 T/t/U/u=3, everything else 4 (reference sketch.c:9-26)
SEQ_NT4_TABLE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate("ACGT"):
    SEQ_NT4_TABLE[ord(_c)] = _i
    SEQ_NT4_TABLE[ord(_c.lower())] = _i
SEQ_NT4_TABLE[ord("U")] = 3
SEQ_NT4_TABLE[ord("u")] = 3

# complement of a 4-bit code: 0<->3, 1<->2, >=4 stays
NT4_COMP = np.array([3, 2, 1, 0, 4], dtype=np.uint8)

# IUPAC complement for raw sequence characters (reference bseq.c:11 seq_comp_table)
_COMP_PAIRS = "ACGTURYSWKMBDHVN"
_COMP_VALS_ = "TGCAAYRSWMKVHDBN"
SEQ_COMP_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in zip(_COMP_PAIRS, _COMP_VALS_):
    SEQ_COMP_TABLE[ord(_a)] = ord(_b)
    SEQ_COMP_TABLE[ord(_a.lower())] = ord(_b.lower())


def seq_to_nt4(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII sequence to 0..4 codes."""
    if isinstance(seq, str):
        seq = seq.encode()
    return SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]


def revcomp_nt4(codes: np.ndarray) -> np.ndarray:
    return NT4_COMP[codes][::-1]


def revcomp_str(seq: str) -> str:
    arr = SEQ_COMP_TABLE[np.frombuffer(seq.encode(), dtype=np.uint8)][::-1]
    return arr.tobytes().decode()


def hash64(key: int, mask: int) -> int:
    """Thomas Wang's invertible 64-bit hash used for minimizers (reference sketch.c:28-38)."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = ((key + (key << 3)) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = ((key + (key << 2)) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


def hash64_np(key: np.ndarray, mask: int) -> np.ndarray:
    """Vectorized hash64 over uint64 arrays."""
    m = np.uint64(mask)
    key = key.astype(np.uint64)
    key = ((~key + (key << np.uint64(21))) & m)
    key ^= key >> np.uint64(24)
    key = ((key + (key << np.uint64(3))) + (key << np.uint64(8))) & m
    key ^= key >> np.uint64(14)
    key = ((key + (key << np.uint64(2))) + (key << np.uint64(4))) & m
    key ^= key >> np.uint64(28)
    key = (key + (key << np.uint64(31))) & m
    return key


def wang_hash32(key: int) -> int:
    """__ac_Wang_hash from khash.h (32-bit)."""
    key = (key + ~(key << 15)) & 0xFFFFFFFF
    key ^= key >> 10
    key = (key + (key << 3)) & 0xFFFFFFFF
    key ^= key >> 6
    key = (key + ~(key << 11)) & 0xFFFFFFFF
    key ^= key >> 16
    return key & 0xFFFFFFFF


def x31_hash_string(s: str) -> int:
    """__ac_X31_hash_string from khash.h."""
    h = 0
    for ch in s:
        h = (h << 5) - h + ord(ch)
        h &= 0xFFFFFFFF
    return h


def qname_hash(qname: str | None, qlen_sum: int, seed: int) -> int:
    """Per-read tie-break hash (reference map.c:345-347)."""
    h = x31_hash_string(qname) if qname else 0
    h ^= (wang_hash32(qlen_sum) + wang_hash32(seed)) & 0xFFFFFFFF
    h &= 0xFFFFFFFF
    return wang_hash32(h)


def ilog2_32(v: int) -> int:
    """Integer log2 (reference chain.c:16-21); v > 0."""
    return v.bit_length() - 1 if v > 0 else -1
