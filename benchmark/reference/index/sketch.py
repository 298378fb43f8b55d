# Frozen copy of minimap2_chaindp_tpu/index/sketch.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/index/sketch.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""(w,k)-minimizer sketching — exact host golden model.

Semantics match reference sketch.c:77-143 exactly, including:
  * canonical strand via min(fwd, rev) k-mer; symmetric k-mers skipped
    (the base is consumed but the window does not advance), sketch.c:106-109
  * homopolymer compression via a run-length queue, sketch.c:94-105
  * all-ties emission on first full window and on window-min recompute,
    emitted oldest-first so output stays position-sorted, sketch.c:117-137
  * output encoding x = hash64(kmer)<<8 | kmer_span, y = rid<<32 | last_pos<<1 | strand

This loop version is the golden model the native C++ sketcher
(native/sketch.cc, dispatched below) is fuzz-validated against
(tests/test_native_sketch.py). Sketching stays on the host by design: the
reference's FPGA offload also keeps it host-side (collect_minimizers runs
on the CPU before the task packet is built, map.c:352), the emission
automaton's w-deep tie buffer is sequential, and sketching is a few
percent of end-to-end time — the device budget goes to seed collection,
chaining, and extension instead.
"""
from __future__ import annotations

import numpy as np

from ..constants import SEQ_NT4_TABLE, hash64

UINT64_MAX = 0xFFFFFFFFFFFFFFFF


def sketch(seq: "str | bytes | np.ndarray", w: int, k: int, rid: int,
           is_hpc: bool) -> np.ndarray:
    """Return minimizers as an (n, 2) uint64 array of (x, y) rows.
    `seq` may be ASCII (str/bytes) or already-encoded nt4 uint8 codes.
    Dispatches to the native C++ sketcher (native/sketch.cc) when built;
    the Python loop below is the golden model it is validated against."""
    if isinstance(seq, np.ndarray):
        nt4 = seq
        length = len(seq)
        assert length > 0 and 0 < w < 256 and 0 < k <= 28
    else:
        if isinstance(seq, str):
            seq = seq.encode()
        length = len(seq)
        assert length > 0 and 0 < w < 256 and 0 < k <= 28
        nt4 = SEQ_NT4_TABLE[np.frombuffer(seq, dtype=np.uint8)]

    from ..nonative import sketch_batch_native
    res = sketch_batch_native([nt4], w, k, [rid], is_hpc)
    if res is not None:
        return res[0]
    return _sketch_py(nt4, length, w, k, rid, is_hpc)


def _sketch_py(nt4, length, w: int, k: int, rid: int,
               is_hpc: bool) -> np.ndarray:

    shift1 = 2 * (k - 1)
    mask = (1 << (2 * k)) - 1
    kmer0 = 0  # forward k-mer
    kmer1 = 0  # reverse k-mer
    kmer_span = 0
    tq: list[int] = []  # homopolymer run-length queue
    buf: list[tuple[int, int]] = [(UINT64_MAX, UINT64_MAX)] * w
    minv = (UINT64_MAX, UINT64_MAX)
    min_pos = 0
    out: list[tuple[int, int]] = []
    push = out.append

    i = 0
    l = 0
    buf_pos = 0
    while i < length:
        c = int(nt4[i])
        info = (UINT64_MAX, UINT64_MAX)
        if c < 4:
            if is_hpc:
                skip_len = 1
                if i + 1 < length and int(nt4[i + 1]) == c:
                    skip_len = 2
                    while i + skip_len < length and int(nt4[i + skip_len]) == c:
                        skip_len += 1
                    i += skip_len - 1  # land on the end of the homopolymer run
                tq.append(skip_len)
                kmer_span += skip_len
                if len(tq) > k:
                    kmer_span -= tq.pop(0)
            else:
                kmer_span = l + 1 if l + 1 < k else k
            kmer0 = ((kmer0 << 2) | c) & mask
            kmer1 = (kmer1 >> 2) | ((3 ^ c) << shift1)
            if kmer0 == kmer1:
                i += 1
                continue  # symmetric k-mer: strand unknown, skip without advancing window
            z = 0 if kmer0 < kmer1 else 1
            l += 1
            if l >= k and kmer_span < 256:
                info = (hash64(kmer0 if z == 0 else kmer1, mask) << 8 | kmer_span,
                        (rid << 32) | (i << 1) | z)
        else:
            l = 0
            tq.clear()
            kmer_span = 0
        buf[buf_pos] = info
        if l == w + k - 1 and minv[0] != UINT64_MAX:
            # first full window: emit identical k-mers (ties), oldest first
            for j in range(buf_pos + 1, w):
                if minv[0] == buf[j][0] and buf[j][1] != minv[1]:
                    push(buf[j])
            for j in range(buf_pos):
                if minv[0] == buf[j][0] and buf[j][1] != minv[1]:
                    push(buf[j])
        if info[0] <= minv[0]:
            # new minimum: write the old one out first
            if l >= w + k and minv[0] != UINT64_MAX:
                push(minv)
            minv, min_pos = info, buf_pos
        elif buf_pos == min_pos:
            # old min fell out of the window
            if l >= w + k - 1 and minv[0] != UINT64_MAX:
                push(minv)
            minv = (UINT64_MAX, UINT64_MAX)
            for j in range(buf_pos + 1, w):  # >= keeps min as the newest equal k-mer
                if minv[0] >= buf[j][0]:
                    minv, min_pos = buf[j], j
            for j in range(buf_pos + 1):
                if minv[0] >= buf[j][0]:
                    minv, min_pos = buf[j], j
            if l >= w + k - 1 and minv[0] != UINT64_MAX:
                for j in range(buf_pos + 1, w):  # emit identical k-mers, position-sorted
                    if minv[0] == buf[j][0] and minv[1] != buf[j][1]:
                        push(buf[j])
                for j in range(buf_pos + 1):
                    if minv[0] == buf[j][0] and minv[1] != buf[j][1]:
                        push(buf[j])
        buf_pos += 1
        if buf_pos == w:
            buf_pos = 0
        i += 1
    if minv[0] != UINT64_MAX:
        push(minv)
    if not out:
        return np.empty((0, 2), dtype=np.uint64)
    return np.array(out, dtype=np.uint64)
