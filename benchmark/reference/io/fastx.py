"""The records the reference maps (frozen copy of the JAX package's
minimap2_chaindp_tpu/io/fastx.py:17-23, :139-148, the same lines in the
port's minimap2_chaindp_tpu_torch/io/fastx.py at commit 241cda7)."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SeqRecord:
    name: str
    seq: str
    qual: str | None = None
    comment: str | None = None
    rid: int = -1


def strip_pair_suffix(name: str) -> str:
    """Drop a trailing /<digit> read-pair suffix (reference mm_qname_len,
    bseq.h:31-36: '/' followed by ANY digit, on names of length >= 3)."""
    if len(name) >= 3 and name[-2] == "/" and name[-1].isdigit():
        return name[:-2]
    return name


def qname_same(a: str, b: str) -> bool:
    return strip_pair_suffix(a) == strip_pair_suffix(b)
