# Frozen copy of minimap2_chaindp_tpu/options.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/options.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""Indexing and mapping options with reference-exact defaults and presets.

Defaults mirror reference options.c:13-55; presets mirror options.c:84-140.
These constants determine output equality with the reference — do not tweak.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

from . import constants as C


@dataclass
class IndexOptions:
    k: int = 15
    w: int = 10
    flag: int = 0
    bucket_bits: int = 14
    mini_batch_size: int = 50_000_000
    batch_size: int = 4_000_000_000

    @property
    def is_hpc(self) -> bool:
        return bool(self.flag & C.MM_I_HPC)


@dataclass
class MapOptions:
    seed: int = 11
    sdust_thres: int = 0
    flag: int = 0

    bw: int = 500
    max_gap: int = 5000
    max_gap_ref: int = -1
    max_frag_len: int = 0
    max_chain_skip: int = 25
    min_cnt: int = 3
    min_chain_score: int = 40

    mask_level: float = 0.5
    pri_ratio: float = 0.8
    best_n: int = 5

    max_join_long: int = 20000
    max_join_short: int = 2000
    min_join_flank_sc: int = 1000

    a: int = 2           # match score
    b: int = 4           # mismatch penalty
    q: int = 4           # gap open
    e: int = 2           # gap extension
    q2: int = 24         # second gap open
    e2: int = 1          # second gap extension
    noncan: int = 0      # non-canonical splice penalty
    zdrop: int = 400
    zdrop_inv: int = 200
    end_bonus: int = -1
    min_dp_max: int = 80           # = min_chain_score * a
    min_ksw_len: int = 200
    anchor_ext_len: int = 20
    anchor_ext_shift: int = 6
    max_clip_ratio: float = 1.0

    pe_ori: int = 0      # FF
    pe_bonus: int = 33

    mid_occ_frac: float = 2e-4
    min_mid_occ: int = 0
    mid_occ: int = 0
    max_occ: int = 0
    mini_batch_size: int = 500_000_000

    def update(self, index) -> None:
        """Derive mid_occ from the index occurrence quantile (reference options.c:57-71)."""
        if (self.flag & C.MM_F_SPLICE_FOR) and (self.flag & C.MM_F_SPLICE_REV):
            self.flag |= C.MM_F_SPLICE
        if self.mid_occ <= 0:
            self.mid_occ = index.cal_max_occ(self.mid_occ_frac)
        if self.mid_occ < self.min_mid_occ:
            self.mid_occ = self.min_mid_occ

    def max_intron_len(self, max_intron_len: int) -> None:
        if (self.flag & C.MM_F_SPLICE) and max_intron_len > 0:
            self.max_gap_ref = self.bw = max_intron_len

    @property
    def is_sr(self) -> bool:
        return bool(self.flag & C.MM_F_SR)

    @property
    def is_splice(self) -> bool:
        return bool(self.flag & C.MM_F_SPLICE)


PRESET_NAMES = (
    "map-ont", "map-pb", "map10k", "ava-ont", "ava-pb",
    "asm5", "asm10", "asm20", "sr", "short", "splice", "cdna",
)


def set_opt(preset: str | None = None,
            io: IndexOptions | None = None,
            mo: MapOptions | None = None) -> tuple[IndexOptions, MapOptions]:
    """Apply a preset on top of (possibly user-touched) options, reference options.c:79-142."""
    io = io if io is not None else IndexOptions()
    mo = mo if mo is not None else MapOptions()
    if preset is None:
        return io, mo
    if preset == "ava-ont":
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= C.MM_F_ALL_CHAINS | C.MM_F_NO_DIAG | C.MM_F_NO_DUAL | C.MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_gap, mo.max_chain_skip = 100, 0.0, 10000, 25
    elif preset == "ava-pb":
        io.flag |= C.MM_I_HPC
        io.k, io.w = 19, 5
        mo.flag |= C.MM_F_ALL_CHAINS | C.MM_F_NO_DIAG | C.MM_F_NO_DUAL | C.MM_F_NO_LJOIN
        mo.min_chain_score, mo.pri_ratio, mo.max_gap, mo.max_chain_skip = 100, 0.0, 10000, 25
        mo.bw = 2000
    elif preset in ("map10k", "map-pb"):
        io.flag |= C.MM_I_HPC
        io.k = 19
    elif preset == "map-ont":
        io.flag, io.k = 0, 15
    elif preset in ("asm5", "asm10", "asm20"):
        io.flag, io.k = 0, 19
        io.w = 19 if preset != "asm20" else 10
        if preset == "asm5":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 19, 39, 81, 3, 1
        elif preset == "asm10":
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 9, 16, 41, 2, 1
        else:
            mo.a, mo.b, mo.q, mo.q2, mo.e, mo.e2 = 1, 4, 6, 26, 2, 1
        mo.zdrop = mo.zdrop_inv = 200
        mo.min_mid_occ = 100
        mo.min_dp_max = 200
        mo.best_n = 50
    elif preset in ("short", "sr"):
        io.flag, io.k, io.w = 0, 21, 11
        mo.flag |= (C.MM_F_SR | C.MM_F_FRAG_MODE | C.MM_F_NO_PRINT_2ND
                    | C.MM_F_2_IO_THREADS | C.MM_F_HEAP_SORT)
        mo.pe_ori = 0 << 1 | 1  # FR
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 2, 8, 12, 2, 24, 1
        mo.zdrop = mo.zdrop_inv = 100
        mo.end_bonus = 10
        mo.max_frag_len = 800
        mo.max_gap = 100
        mo.bw = 100
        mo.pri_ratio = 0.5
        mo.min_cnt = 2
        mo.min_chain_score = 25
        mo.min_dp_max = 40
        mo.best_n = 20
        mo.mid_occ = 1000
        mo.max_occ = 5000
        mo.mini_batch_size = 50_000_000
    elif preset in ("splice", "cdna"):
        io.flag, io.k, io.w = 0, 15, 5
        mo.flag |= (C.MM_F_SPLICE | C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV
                    | C.MM_F_SPLICE_FLANK)
        mo.max_gap = 2000
        mo.max_gap_ref = mo.bw = 200000
        mo.a, mo.b, mo.q, mo.e, mo.q2, mo.e2 = 1, 2, 2, 1, 32, 0
        mo.noncan = 9
        mo.zdrop, mo.zdrop_inv = 200, 100
    else:
        raise ValueError(f"unknown preset: {preset}")
    return io, mo


def check_opt(io: IndexOptions, mo: MapOptions) -> None:
    """Validation mirroring reference options.c:144-179 (raises instead of error codes)."""
    if mo.best_n < 0:
        raise ValueError("-N must be no less than 0")
    if not (0.0 <= mo.pri_ratio <= 1.0):
        raise ValueError("-p must be within 0 and 1")
    if (mo.flag & C.MM_F_FOR_ONLY) and (mo.flag & C.MM_F_REV_ONLY):
        raise ValueError("--for-only and --rev-only can't be applied at the same time")
    if (mo.q != mo.q2 or mo.e != mo.e2) and not (mo.e > mo.e2 and mo.q + mo.e < mo.q2 + mo.e2):
        raise ValueError("dual gap penalties violating E1>E2 and O1+E1<O2+E2")
    if (mo.q + mo.e) + (mo.q2 + mo.e2) > 127:
        raise ValueError("scoring system violating ({-O}+{-E})+({-O2}+{-E2}) <= 127")
    if mo.zdrop < mo.zdrop_inv:
        raise ValueError("Z-drop should not be less than inversion-Z-drop")
