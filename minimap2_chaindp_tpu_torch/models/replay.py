"""The staged path's native finish: each unit's back half (regions,
chain_post, est_err, pe seg_gen, the align skeleton, mapq, pairing) run
by the native driver from the card's chains, its extension jobs answered
from a job table that the card's ksw2 kernels fill, round by round
(csrc/align_replay.cc says how a pass works).

A round is one native pass over the batch's live units, the jobs that
pass recorded (its misses) run as one wave through the runtime's
`CudaAlignExecutor.run`, and their results put into the units' tables.
A unit is finished by a pass with no miss. The pass runs through a
handle that lets the interpreter lock go (`ctypes.CDLL`), so the other
batch thread's Python runs meanwhile; the short calls that add units and
move jobs and results hold it (`ctypes.PyDLL`). Every pass and its
marshalling is a `skeleton` span, as the generators' advances are in
`run_scheduler`.

It takes the units of a run with base-level alignment (MM_F_CIGAR),
dual-affine scoring and no splicing, up to two segments a unit; the
others, and a unit whose finished pass breaks the driver's contract,
stay with `finish_unit_gen` under `run_scheduler`. Output is
byte-identical to theirs.

The library (csrc/align_replay.cc, which includes the copy
csrc/align_driver.cc, and the native sources it links) is built with g++
on first use into build/native/<hash>/ under the checkout, keyed by the
sources and flags.
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import sys
import threading

import numpy as np

from .. import constants as C
from .. import native as N
from ..utils import mlog

__all__ = ["ReplayFinish", "load"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PKG)
_NATIVE = os.path.join(_ROOT, "native")
SOURCES = (os.path.join(_PKG, "csrc", "align_replay.cc"),
           os.path.join(_NATIVE, "align_epilogue.cc"),
           os.path.join(_NATIVE, "chain_epilogue.cc"),
           os.path.join(_NATIVE, "sketch.cc"))
# included by align_replay.cc: the driver's copy and the ksw2 kernels
INCLUDED = (os.path.join(_PKG, "csrc", "align_driver.cc"),
            os.path.join(_NATIVE, "ksw2_extd2.cc"))
FLAGS = ("-O3", "-march=native", f"-I{_NATIVE}", "-Wl,-Bsymbolic")
BUILD_DIR = os.path.join(_ROOT, "build", "native")
LIB_NAME = "libmm2tpu_replay.so"
EZ_FIELDS = ("max", "zdropped", "max_q", "max_t", "mqe", "mqe_t", "mte",
             "mte_q", "score", "reach_end")

_lock = threading.Lock()
_libs = None
_tried = False


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS[:2]).encode())
    for path in SOURCES + INCLUDED:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], LIB_NAME)


def load():
    """(free, held): the library through a handle that lets the
    interpreter lock go and through one that keeps it, built on first use;
    None where it cannot be built or loaded."""
    global _libs, _tried
    if _libs is not None:
        return _libs
    # _tried is read under the lock alone: a thread that finds it set while
    # another builds would take the generators for its whole batch
    with _lock:
        if not _tried:
            _tried = True
            try:
                path = lib_path()
                if not os.path.exists(path):
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    N._compile_so(list(SOURCES), path, extra=FLAGS)
                _libs = tuple(_declare(cls(path))
                              for cls in (ctypes.CDLL, ctypes.PyDLL))
            except Exception as e:  # no compiler, a failed build or load
                print(f"[WARNING] the staged path's native finish is "
                      f"unavailable ({type(e).__name__}: {e}); its units "
                      "take the align generators", file=sys.stderr)
    return _libs


def _declare(lib):
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    lib.mm2tpu_replay_open.restype = vp
    lib.mm2tpu_replay_open.argtypes = [vp, vp, vp, i64, i32, i32, vp, vp, vp]
    lib.mm2tpu_replay_close.restype = None
    lib.mm2tpu_replay_close.argtypes = [vp]
    lib.mm2tpu_replay_add.restype = i64
    lib.mm2tpu_replay_add.argtypes = [vp, i64, vp, i64, vp, i64,
                                      ctypes.c_uint64, vp, i64, vp, i64,
                                      vp, i64, i64, i64]
    lib.mm2tpu_replay_pass.restype = i64
    lib.mm2tpu_replay_pass.argtypes = [vp, vp]
    lib.mm2tpu_replay_jobs.restype = None
    lib.mm2tpu_replay_jobs.argtypes = [vp, vp, vp]
    lib.mm2tpu_replay_put.restype = None
    lib.mm2tpu_replay_put.argtypes = [vp, vp, vp, vp]
    lib.mm2tpu_replay_sizes.restype = None
    lib.mm2tpu_replay_sizes.argtypes = [vp, vp]
    lib.mm2tpu_replay_take.restype = None
    lib.mm2tpu_replay_take.argtypes = [vp, vp, vp, vp]
    return lib


def _ptr(a) -> int:
    return a.__array_interface__["data"][0]


_EMPTY = np.zeros(1, np.uint64)


class ReplayFinish:
    """Finishes a batch's staged units natively (module docstring), the
    extension waves through `executor` (a CudaAlignExecutor), the spans
    and counters into the executor's timers, as run_scheduler does."""

    def __init__(self, mi, opt, executor):
        self.mi, self.opt, self.executor = mi, opt, executor

    def takes(self) -> bool:
        """Whether the run's options take the native finish, and its
        library loads."""
        o, mi = self.opt, self.mi
        return (bool(o.flag & C.MM_F_CIGAR)
                and not (o.flag & C.MM_F_SPLICE)
                and not (o.q == o.q2 and o.e == o.e2)
                and not (mlog.dbg_flag & C.MM_DBG_PRINT_SEED)
                and len(mi.S) > 0 and mi.S.flags.c_contiguous
                and load() is not None)

    def run(self, units, chains) -> list:
        """Finish `units` ((segs, UnitInfo) pairs) from their `chains`.
        Returns, per unit, its per-segment region lists, or None for a
        unit left to the generators. Counts replay_rounds and
        replay_jobs."""
        free, held = load()
        mi, tm = self.mi, self.executor.timers
        # the driver's opt layout and the index tables (native.py)
        nat = N._map_ctx(mi, self.opt)
        seq_off, seq_len = N._mi_nat_tables(mi)
        with tm.time("skeleton"):
            h = held.mm2tpu_replay_open(
                _ptr(mi.S), _ptr(seq_off), _ptr(seq_len), len(mi.seqs),
                mi.k, 1 if (mi.flag & 1) else 0, _ptr(nat.mat),
                _ptr(nat.optv), _ptr(nat.optf))
        try:
            with tm.time("skeleton"):
                idx = [self._add(held, h, info, ch)
                       for (_segs, info), ch in zip(units, chains)]
            self._rounds(free, held, h)
            with tm.time("skeleton"):
                return self._take(held, h, idx)
        finally:
            held.mm2tpu_replay_close(h)

    @staticmethod
    def _add(held, h, info, ch):
        """Add one unit; its n_segs, or None where the native finish
        cannot take it (more than two segments). The library copies what
        it is given."""
        n_segs = len(info.segs)
        if n_segs > 2:
            return None
        qa = [C.seq_to_nt4(s) for s in info.seqs]
        q1 = qa[1] if n_segs == 2 else _EMPTY[:0]
        if info.sh is None or ch is None or not len(ch.u):
            a = u = mini = _EMPTY[:0]
            rep_len = 0 if info.sh is None else info.sh.rep_len
        else:
            a = np.ascontiguousarray(ch.anchors, dtype=np.uint64)
            u = np.ascontiguousarray(ch.u, dtype=np.uint64)
            mini = np.ascontiguousarray(info.sh.mini_pos, dtype=np.uint64)
            rep_len = info.sh.rep_len
        held.mm2tpu_replay_add(
            h, n_segs, _ptr(qa[0]), len(qa[0]), _ptr(q1), len(q1),
            info.hash_, _ptr(a) if len(a) else None, len(a),
            _ptr(u) if len(u) else None, len(u),
            _ptr(mini) if len(mini) else None, len(mini), int(rep_len),
            info.gap_ref)
        return n_segs

    def _rounds(self, free, held, h) -> None:
        """Passes until one records no job, each one's jobs as a wave."""
        tm = self.executor.timers
        bases = np.zeros(1, np.int64)
        while True:
            with tm.time("skeleton"):
                n = free.mm2tpu_replay_pass(h, _ptr(bases))
                tm.count("replay_rounds")
                if not n:
                    return
                tm.count("replay_jobs", n)
                buf = np.empty(max(int(bases[0]), 1), np.uint8)
                meta = np.empty((n, 8), np.int64)
                held.mm2tpu_replay_jobs(h, _ptr(buf), _ptr(meta))
                jobs = [dict(qseq=buf[qo:qo + ql], tseq=buf[to:to + tl],
                             w=w, zdrop=zd, end_bonus=eb, flag=fl)
                        for qo, ql, to, tl, w, zd, eb, fl in meta.tolist()]
            thunks = self.executor.run(jobs)
            with tm.time("skeleton"):
                res = [t() for t in thunks]
                rows = np.array([[getattr(ez, f) for f in EZ_FIELDS]
                                 + [len(ez.cigar)] for ez in res], np.int64)
                offs = np.zeros(n + 1, np.int64)
                np.cumsum(rows[:, 10], out=offs[1:])
                cig = np.fromiter(
                    itertools.chain.from_iterable(ez.cigar for ez in res),
                    np.uint32, int(offs[-1]))
                held.mm2tpu_replay_put(h, _ptr(rows), _ptr(offs),
                                       _ptr(cig) if len(cig) else None)

    @staticmethod
    def _take(held, h, idx) -> list:
        """The finished units' region lists (hits.Region, mapping
        orientation, one list a segment), None for the others. `idx`:
        each unit's n_segs where it was added, else None."""
        n_in = sum(i is not None for i in idx)
        sizes = np.zeros((max(n_in, 1), 4), np.int64)
        held.mm2tpu_replay_sizes(h, _ptr(sizes))
        n_regs = int(sizes[:n_in, 1:3].sum())
        regs = np.empty((max(n_regs, 1), 28), np.int64)
        extras = np.empty((max(n_regs, 1), 7), np.int64)
        cig = np.empty(max(int(sizes[:n_in, 3].sum()), 1), np.uint32)
        held.mm2tpu_replay_take(h, _ptr(regs), _ptr(extras), _ptr(cig))
        out, k, off = [], 0, 0
        for n_segs in idx:
            if n_segs is None:
                out.append(None)
                continue
            state, *cnt = sizes[k, :3].tolist()
            k += 1
            segs = []
            for c in cnt[:n_segs]:
                segs.append(N._rebuild_regions(c, regs[off:off + c],
                                               extras[off:off + c], cig))
                off += c
            out.append(segs if state == 1 else None)
        return out
