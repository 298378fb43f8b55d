"""ctypes bindings for the native (C++) host-runtime components.

Builds `native/chain_epilogue.cc` on demand (g++ -O2 -shared) and exposes
`chain_bottom_native` — the per-read chaining epilogue (compact construction +
bottom-half backtrack). Falls back to the pure-Python implementations in
ops/chain.py when the toolchain is unavailable."""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "chain_epilogue.cc")
_SO = os.path.join(_ROOT, "native", "libmm2tpu_epilogue.so")
_lib = None
_tried = False
# one lock shared by all four loaders (_load, load_align, load_ksw,
# _load_sketch): map_stream calls them from two pipeline threads at once,
# and an unguarded tried-flag makes the losing thread see "tried, no lib"
# and silently take the slow fallback for its whole batch
import threading as _threading
_load_lock = _threading.Lock()


def _load():
    if _lib is not None:
        return _lib
    # NB: _tried may only be consulted under the lock — a concurrent
    # loader sets it before _lib is published, and an unlocked read
    # would wrongly report "tried, no lib"
    with _load_lock:
        return _load_locked()


def _load_locked():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            _compile_so([_SRC], _SO)
        lib = ctypes.CDLL(_SO)
        lib.mm2tpu_chain_bottom.restype = ctypes.c_int64
        lib.mm2tpu_chain_bottom.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mm2tpu_chain_dp.restype = ctypes.c_int64
        lib.mm2tpu_chain_dp.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


_AL_SRC = os.path.join(_ROOT, "native", "align_epilogue.cc")
_AL_SO = os.path.join(_ROOT, "native", "libmm2tpu_align.so")
_al_lib = None
_al_tried = False

_c = ctypes
_p8 = _c.POINTER(_c.c_uint8)
_pi8 = _c.POINTER(_c.c_int8)
_p32 = _c.POINTER(_c.c_int32)
_pu32 = _c.POINTER(_c.c_uint32)
_p64 = _c.POINTER(_c.c_int64)
_pu64 = _c.POINTER(_c.c_uint64)


def load_align():
    """Loader for the alignment-epilogue scans (native/align_epilogue.cc);
    returns the ctypes lib or None."""
    if _al_lib is not None:
        return _al_lib
    # NB: _al_tried may only be consulted under the lock — a concurrent
    # loader sets it before _al_lib is published, and an unlocked read
    # would wrongly report "tried, no lib"
    with _load_lock:
        return _load_align_locked()


def _load_align_locked():
    global _al_lib, _al_tried
    if _al_lib is not None or _al_tried:
        return _al_lib
    _al_tried = True
    try:
        if (not os.path.exists(_AL_SO)
                or os.path.getmtime(_AL_SO) < os.path.getmtime(_AL_SRC)):
            _compile_so([_AL_SRC], _AL_SO)
        lib = ctypes.CDLL(_AL_SO)
        # raw-address pointers (c_void_p + __array_interface__) — these
        # run thousands of times per batch and arr.ctypes.data_as() costs
        # ~17 us per call (lazy .ctypes construction + cast)
        _vp = _c.c_void_p
        lib.mm2tpu_zdrop_scan.restype = _c.c_int64
        lib.mm2tpu_zdrop_scan.argtypes = [
            _vp, _vp, _vp, _c.c_int64, _vp, _c.c_int32, _c.c_int32, _vp]
        lib.mm2tpu_update_extra_scan.restype = None
        lib.mm2tpu_update_extra_scan.argtypes = [
            _vp, _vp, _vp, _c.c_int64, _vp, _c.c_int32, _c.c_int32,
            _c.c_int64, _c.c_int64, _vp]
        lib.mm2tpu_logf.restype = _c.c_float
        lib.mm2tpu_logf.argtypes = [_c.c_float]
        lib.mm2tpu_cigar_str.restype = _c.c_int64
        lib.mm2tpu_cigar_str.argtypes = [_vp, _c.c_int64, _vp]
        lib.mm2tpu_fix_update_extra.restype = None
        lib.mm2tpu_fix_update_extra.argtypes = [
            _vp, _vp, _vp, _c.c_int64, _vp, _c.c_int32, _c.c_int32,
            _c.c_int32, _vp, _vp]
        lib.mm2tpu_est_err_merge.restype = _c.c_int32
        lib.mm2tpu_est_err_merge.argtypes = [
            _vp, _vp, _c.c_int64, _c.c_int64, _c.c_int32, _c.c_int64,
            _vp, _c.c_int64, _vp]
        lib.mm2tpu_cal_fuzzy_len.restype = None
        lib.mm2tpu_cal_fuzzy_len.argtypes = [
            _vp, _c.c_int64, _c.c_int64, _vp]
        lib.mm2tpu_key_lookup_batch.restype = None
        lib.mm2tpu_key_lookup_batch.argtypes = [
            _vp, _c.c_int64, _vp, _c.c_int64, _vp]
        lib.mm2tpu_fix_bad_ends.restype = None
        lib.mm2tpu_fix_bad_ends.argtypes = [
            _vp, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int64,
            _c.c_int64, _vp]
        lib.mm2tpu_decode_cigar.restype = _c.c_int64
        lib.mm2tpu_decode_cigar.argtypes = [
            _vp, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int32,
            _c.c_int32, _vp]
        lib.mm2tpu_enum_fill_cuts.restype = _c.c_int64
        lib.mm2tpu_enum_fill_cuts.argtypes = [
            _vp, _c.c_int64, _c.c_int64, _c.c_int64, _c.c_int64,
            _c.c_int64, _c.c_int64, _vp, _vp, _vp, _vp]
        lib.mm2tpu_enum_fill_cuts_hpc.restype = _c.c_int64
        lib.mm2tpu_enum_fill_cuts_hpc.argtypes = [
            _vp, _c.c_int64, _c.c_int64, _vp, _vp, _c.c_int64,
            _c.c_int64, _c.c_int64, _vp, _vp, _vp, _vp]
        lib.mm2tpu_collect_seeds.restype = _c.c_void_p
        lib.mm2tpu_collect_seeds.argtypes = [
            _vp, _c.c_int64, _vp, _c.c_int64, _vp, _vp,
            _c.c_int64, _c.c_int64, _c.c_int32, _vp]
        lib.mm2tpu_collect_take.restype = None
        lib.mm2tpu_collect_take.argtypes = [_c.c_void_p, _vp, _vp]
        _al_lib = lib
    except Exception:
        _al_lib = None
    return _al_lib


def _np_ptr(a, t=None):
    # raw data address: ~20x cheaper than a.ctypes.data_as() on the hot
    # path. `t` is ADVISORY ONLY — call sites pass the intended pointer
    # type as documentation; no cast or dtype check happens here (the
    # argtypes on the C prototypes are all c_void_p).
    return a.__array_interface__["data"][0]


_ptr_cache: dict = {}


def _np_ptr_cached(a):
    """Pointer for long-lived arrays passed repeatedly (e.g. the score
    matrix): id-keyed cache holding the array ref so the id stays valid."""
    hit = _ptr_cache.get(id(a))
    if hit is not None and hit[0] is a:
        return hit[1]
    p = a.__array_interface__["data"][0]
    if len(_ptr_cache) < 64:
        _ptr_cache[id(a)] = (a, p)
    return p


_u8dt = np.dtype(np.uint8)
_i8dt = np.dtype(np.int8)


def _compile_so(srcs, so_path, extra=()):
    """Compile to a temp path and os.replace into place: two concurrent
    processes recompiling after a source change must never dlopen a
    partially written shared object (the loser would hit a truncated ELF,
    and the bare except would pin it to the pure-Python path for life)."""
    import threading
    tmp = (f"{so_path}.{os.getpid()}."
           f"{threading.get_ident()}.tmp")   # unique per pid AND thread
    try:
        # extras go AFTER the sources: -l libraries must follow the
        # objects that need them; a later -O simply overrides the -O2
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             *srcs, *extra, "-o", tmp], check=True, capture_output=True)
        os.replace(tmp, so_path)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _as_u8(a):
    """ascontiguousarray(dtype=uint8) with a fast path for the common case
    (already a C-contiguous uint8 ndarray — e.g. encoded sequence slices)."""
    if type(a) is np.ndarray and a.dtype is _u8dt and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=np.uint8)


def _as_i8(a):
    if type(a) is np.ndarray and a.dtype is _i8dt and a.flags.c_contiguous:
        return a
    return np.ascontiguousarray(a, dtype=np.int8)


def zdrop_scan(qseq, tseq, cigar, mat, q, e):
    """Native mm_test_zdrop scan. Returns (max_zdrop, pos) or None."""
    lib = load_align()
    if lib is None:
        return None
    cig = np.asarray(cigar, dtype=np.uint32)
    qa = _as_u8(qseq)
    ta = _as_u8(tseq)
    ma = _as_i8(mat)
    pos = np.zeros(4, dtype=np.int32)
    mz = lib.mm2tpu_zdrop_scan(_np_ptr(qa, _p8), _np_ptr(ta, _p8),
                               _np_ptr(cig, _pu32), len(cig),
                               _np_ptr_cached(ma), q, e, _np_ptr(pos, _p32))
    return int(mz), [[int(pos[0]), int(pos[1])], [int(pos[2]), int(pos[3])]]


def update_extra_scan(qseq, tseq, cigar, mat, q, e, exp_qoff, exp_toff):
    """Native mm_update_extra scan.
    Returns (blen, mlen, n_ambi, dp_max, ok) or None."""
    lib = load_align()
    if lib is None:
        return None
    cig = np.asarray(cigar, dtype=np.uint32)
    qa = _as_u8(qseq)
    ta = _as_u8(tseq)
    ma = _as_i8(mat)
    out = np.zeros(5, dtype=np.int64)
    lib.mm2tpu_update_extra_scan(_np_ptr(qa, _p8), _np_ptr(ta, _p8),
                                 _np_ptr(cig, _pu32), len(cig),
                                 _np_ptr_cached(ma), q, e,
                                 exp_qoff, exp_toff, _np_ptr(out, _p64))
    return tuple(int(v) for v in out)


def logf_native(x: float):
    """glibc logf of float32(x), as the native paths compute it; None if
    the lib is unavailable (callers fall back to numpy's float32 log)."""
    lib = load_align()
    if lib is None:
        return None
    return lib.mm2tpu_logf(x)


def cigar_str_native(cigar) -> str | None:
    """CIGAR words -> "123M4I..." via one native call; None = no lib."""
    lib = load_align()
    if lib is None:
        return None
    cig = np.asarray(cigar, dtype=np.uint32)
    buf = np.empty(11 * len(cig) + 1, dtype=np.uint8)
    n = lib.mm2tpu_cigar_str(_np_ptr(cig), len(cig), _np_ptr(buf))
    return buf[:n].tobytes().decode("ascii")


def fix_update_extra(qseq, tseq, cigar, mat, q, e, rev, qs, qe, rs, re):
    """Fused native mm_fix_cigar + mm_update_extra.
    Returns (new_cigar_list, (qs,qe,rs,re), blen, mlen, n_ambi, dp_max)
    or None (fallback to the Python path)."""
    lib = load_align()
    if lib is None:
        return None
    cig = np.asarray(cigar, dtype=np.uint32)
    qa = _as_u8(qseq)
    ta = _as_u8(tseq)
    ma = _as_i8(mat)
    coords = np.array([qs, qe, rs, re], dtype=np.int64)
    out = np.zeros(6, dtype=np.int64)
    lib.mm2tpu_fix_update_extra(_np_ptr(qa), _np_ptr(ta),
                                _np_ptr(cig), len(cig),
                                _np_ptr_cached(ma), q, e, 1 if rev else 0,
                                _np_ptr(coords), _np_ptr(out))
    if not out[5]:
        return None
    n = int(out[0])
    return (cig[:n].tolist(), tuple(int(v) for v in coords),
            int(out[1]), int(out[2]), int(out[3]), int(out[4]))


def est_err_merge(ax, ay, as_, cnt, rev, qlen, mp_lo):
    """Native esterr anchor/minimizer merge.
    Returns (found, n_tot_base, n_match) or None."""
    lib = load_align()
    if lib is None:
        return None
    out = np.zeros(2, dtype=np.int64)
    found = lib.mm2tpu_est_err_merge(
        _np_ptr(ax, _pu64), _np_ptr(ay, _pu64), as_, cnt, 1 if rev else 0,
        qlen, _np_ptr(mp_lo, _p64), len(mp_lo), _np_ptr(out, _p64))
    return int(found), int(out[0]), int(out[1])


def enum_fill_cuts_native(a, as1, cnt1, kh, min_ksw_len, rs, qs):
    """Native gap-fill cut enumeration (non-HPC adj).  Returns the list of
    (i, re, qe, long_join) cut tuples or None if the lib is unavailable."""
    lib = load_align()
    if lib is None or not a.flags.c_contiguous:
        return None
    oi = np.empty(cnt1, dtype=np.int32)
    ore = np.empty(cnt1, dtype=np.int32)
    oqe = np.empty(cnt1, dtype=np.int32)
    olj = np.empty(cnt1, dtype=np.uint8)
    n = lib.mm2tpu_enum_fill_cuts(
        _np_ptr(a), as1, cnt1, kh, min_ksw_len, rs, qs,
        _np_ptr(oi), _np_ptr(ore), _np_ptr(oqe), _np_ptr(olj))
    return list(zip(oi[:n].tolist(), ore[:n].tolist(), oqe[:n].tolist(),
                    olj[:n].astype(bool).tolist()))


def enum_fill_cuts_hpc_native(a, as1, cnt1, qseq, s_rid_base, min_ksw_len,
                              rs, qs):
    """Native HPC gap-fill cut enumeration.  qseq is the region strand's
    encoded query; s_rid_base the raw address of the target's nt4 codes.
    Returns the (i, re, qe, long_join) cut list or None."""
    lib = load_align()
    if lib is None or not a.flags.c_contiguous \
            or not qseq.flags.c_contiguous:
        return None
    oi = np.empty(cnt1, dtype=np.int32)
    ore = np.empty(cnt1, dtype=np.int32)
    oqe = np.empty(cnt1, dtype=np.int32)
    olj = np.empty(cnt1, dtype=np.uint8)
    n = lib.mm2tpu_enum_fill_cuts_hpc(
        _np_ptr(a), as1, cnt1, _np_ptr(qseq), s_rid_base,
        min_ksw_len, rs, qs,
        _np_ptr(oi), _np_ptr(ore), _np_ptr(oqe), _np_ptr(olj))
    return list(zip(oi[:n].tolist(), ore[:n].tolist(), oqe[:n].tolist(),
                    olj[:n].astype(bool).tolist()))


def cal_fuzzy_len_native(a, as_, cnt):
    """Native fuzzy mlen/blen over the interleaved (n, 2) anchor array.
    Returns (mlen, blen) or None."""
    lib = load_align()
    if lib is None or not a.flags.c_contiguous:
        return None
    out = np.zeros(2, dtype=np.int64)
    lib.mm2tpu_cal_fuzzy_len(_np_ptr(a, _pu64), as_, cnt, _np_ptr(out, _p64))
    return int(out[0]), int(out[1])


_KSW_SRC = os.path.join(_ROOT, "native", "ksw2_extd2.cc")
_DRV_SRC = os.path.join(_ROOT, "native", "align_driver.cc")
_KSW_SO = os.path.join(_ROOT, "native", "libmm2tpu_ksw2.so")
_ksw_lib = None
_ksw_tried = False


def load_ksw():
    """Loader for the native exact ksw2 kernels + the per-read align driver
    (native/align_driver.cc textually includes ksw2_extd2.cc so the row
    kernels inline; align_epilogue.cc supplies the fix_cigar/update_extra
    scan to the same shared object)."""
    if _ksw_lib is not None:
        return _ksw_lib
    # NB: _ksw_tried may only be consulted under the lock — a concurrent
    # loader sets it before _ksw_lib is published, and an unlocked read
    # would wrongly report "tried, no lib"
    with _load_lock:
        return _load_ksw_locked()


def _load_ksw_locked():
    global _ksw_lib, _ksw_tried
    if _ksw_lib is not None or _ksw_tried:
        return _ksw_lib
    _ksw_tried = True
    try:
        srcs = [_DRV_SRC, _AL_SRC, _SRC, _SK_SRC]
        src_mtime = max(os.path.getmtime(s) for s in srcs + [_KSW_SRC])
        if (not os.path.exists(_KSW_SO)
                or os.path.getmtime(_KSW_SO) < src_mtime):
            _compile_so(srcs, _KSW_SO,
                        extra=("-O3", "-march=native"))
        lib = ctypes.CDLL(_KSW_SO)
        _vp = _c.c_void_p
        lib.mm2tpu_extd2_batch.restype = None
        lib.mm2tpu_extd2_batch.argtypes = [
            _vp, _vp, _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp, _vp, _vp, _vp]
        lib.mm2tpu_prof_read.restype = None
        lib.mm2tpu_prof_read.argtypes = [_vp]
        lib.mm2tpu_prof_reset.restype = None
        lib.mm2tpu_prof_reset.argtypes = []
        lib.mm2tpu_collect_prof_read.restype = None
        lib.mm2tpu_collect_prof_read.argtypes = [_vp]
        lib.mm2tpu_collect_prof_reset.restype = None
        lib.mm2tpu_collect_prof_reset.argtypes = []
        lib.mm2tpu_key_lookup_batch.restype = None
        lib.mm2tpu_key_lookup_batch.argtypes = [
            _vp, _c.c_int64, _vp, _c.c_int64, _vp]
        lib.mm2tpu_exts2_batch.restype = None
        lib.mm2tpu_exts2_batch.argtypes = [
            _vp, _vp, _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp, _vp]
        lib.mm2tpu_align_skeleton.restype = _c.c_int64
        lib.mm2tpu_align_skeleton.argtypes = [
            _vp, _c.c_int64, _vp, _c.c_int64,
            _vp, _vp, _vp, _c.c_int64, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _vp, _c.c_int64, _vp, _c.c_int64]
        lib.mm2tpu_map_unit.restype = _c.c_int64
        lib.mm2tpu_map_unit.argtypes = [
            _vp, _c.c_int64, _c.c_uint64,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp,
            _vp, _vp, _c.c_int64, _vp, _c.c_int64, _vp,
            _vp, _c.c_int64, _c.c_int64]
        lib.mm2tpu_sdust.restype = _c.c_int64
        lib.mm2tpu_sdust.argtypes = [
            _vp, _c.c_int64, _c.c_int32, _c.c_int32, _vp, _c.c_int64]
        lib.mm2tpu_map_frag_pe.restype = _c.c_int64
        lib.mm2tpu_map_frag_pe.argtypes = [
            _vp, _c.c_int64, _vp, _c.c_int64,
            _c.c_int32, _c.c_int32, _c.c_uint64,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp,
            _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_int64, _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_char_p, _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_char_p, _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_int64,
            _vp, _vp, _c.c_int32,
            _vp, _c.c_int64, _vp, _c.c_int64, _vp]
        lib.mm2tpu_map_unit_text.restype = _c.c_int64
        lib.mm2tpu_map_unit_text.argtypes = [
            _vp, _c.c_int64, _c.c_uint64,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp,
            _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_char_p,
            _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_int64,
            _vp, _vp, _c.c_int32,
            _vp, _c.c_int64, _vp, _c.c_int64, _vp,
            _vp, _c.c_int64, _c.c_int64]
        lib.mm2tpu_map_batch_text.restype = _c.c_int64
        lib.mm2tpu_map_batch_text.argtypes = [
            _c.c_int64,
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _c.c_int64, _c.c_int64, _c.c_int64,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp,
            _c.c_char_p, _c.c_int64,
            _vp, _vp, _c.c_int32,
            _vp, _c.c_int64, _vp, _c.c_int64,
            _vp, _vp]
        lib.mm2tpu_map_batch_pe_text.restype = _c.c_int64
        lib.mm2tpu_map_batch_pe_text.argtypes = [
            _c.c_int64,
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _vp, _vp, _vp, _vp, _vp, _vp, _vp, _vp,
            _c.c_int32, _c.c_int32,
            _c.c_int64, _c.c_int64, _c.c_int64,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _c.c_int64, _vp, _vp,
            _c.c_int32, _c.c_int32, _c.c_int32,
            _vp, _vp, _vp,
            _c.c_char_p, _c.c_int64,
            _vp, _vp, _c.c_int32,
            _vp, _c.c_int64, _vp, _c.c_int64,
            _vp, _vp]
        lib.mm2tpu_map_unit_text_chains.restype = _c.c_int64
        lib.mm2tpu_map_unit_text_chains.argtypes = [
            _vp, _c.c_int64, _c.c_uint64,
            _vp, _vp, _vp, _c.c_int64,
            _vp, _c.c_int64, _vp, _c.c_int64,
            _vp, _c.c_int64, _c.c_int64,
            _c.c_int32, _c.c_int32,
            _vp, _vp, _vp,
            _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_char_p,
            _c.c_char_p, _c.c_int64,
            _c.c_char_p, _c.c_int64,
            _vp, _vp, _c.c_int32,
            _vp, _c.c_int64, _vp, _c.c_int64, _vp]
        _ksw_lib = lib
    except Exception:
        _ksw_lib = None
    return _ksw_lib


# Region field order shared with native/align_driver.cc (28 int64 slots)
_REG_ATTRS = ("id", "cnt", "rid", "score", "qs", "qe", "rs", "re", "parent",
              "subsc", "as_", "mlen", "blen", "n_sub", "score0", "mapq",
              "split", "rev", "inv", "sam_pri", "proper_frag", "pe_thru",
              "seg_split", "seg_id", "split_inv", "hash")


def _mi_nat_tables(mi):
    """Cached (seq_off, seq_len) int64 arrays for an index."""
    cache = getattr(mi, "_nat_tables", None)
    if cache is None:
        off = np.array([s.offset for s in mi.seqs], dtype=np.int64)
        ln = np.array([s.length for s in mi.seqs], dtype=np.int64)
        cache = (off, ln)
        mi._nat_tables = cache
    return cache


def _mi_rname_blob(mi):
    """Cached concatenated target-name bytes + offsets for text emission."""
    cache = getattr(mi, "_nat_rnames", None)
    if cache is None:
        names = [s.name.encode() for s in mi.seqs]
        offs = np.zeros(len(names) + 1, dtype=np.int64)
        for i, nb in enumerate(names):
            offs[i + 1] = offs[i] + len(nb)
        blob = np.frombuffer(b"".join(names) or b"\0", dtype=np.uint8).copy()
        cache = (blob, offs)
        mi._nat_rnames = cache
    return cache


def align_skeleton_native(opt, mi, qlen, qseq_fwd, regs, a, n_a, mat):
    """Native per-read align_skeleton (align_driver.cc).  regs: list of
    hits.Region entering alignment (p must be unset); a: squeezed anchors.
    Returns the new region list or None (ineligible / lib missing /
    contract fallback)."""
    lib = load_ksw()
    if lib is None or not len(mi.S):
        return None
    from .hits import Extra, Region
    if any(r.p is not None for r in regs):
        return None
    nr = len(regs)
    regs_in = np.zeros((nr, 28), dtype=np.int64)
    for i, r in enumerate(regs):
        row = regs_in[i]
        for j, name in enumerate(_REG_ATTRS):
            row[j] = getattr(r, name)
        row[26] = np.float64(r.div).view(np.int64)
        row[27] = 0
    optv = np.array([opt.flag, opt.a, opt.b, opt.q, opt.e, opt.q2, opt.e2,
                     opt.zdrop, opt.zdrop_inv, opt.end_bonus, opt.min_cnt,
                     opt.min_chain_score, opt.min_dp_max, opt.max_gap,
                     opt.bw, opt.min_ksw_len], dtype=np.int64)
    seq_off, seq_len = _mi_nat_tables(mi)
    qa = _as_u8(qseq_fwd)
    aa = np.ascontiguousarray(a, dtype=np.uint64)
    ma = _as_i8(mat)
    nr_cap = 2 * nr + 8
    cig_cap = 4 * qlen + 1024 * nr + 4096
    for _attempt in range(2):
        regs_out = np.empty((nr_cap, 28), dtype=np.int64)
        extras = np.empty((nr_cap, 7), dtype=np.int64)
        cig_buf = np.empty(cig_cap, dtype=np.uint32)
        n_out = lib.mm2tpu_align_skeleton(
            _np_ptr(qa), qlen, _np_ptr(aa), n_a,
            _np_ptr(mi.S), _np_ptr(seq_off), _np_ptr(seq_len), len(mi.seqs),
            mi.k, 1 if (mi.flag & 1) else 0,
            _np_ptr_cached(ma), _np_ptr(optv),
            _np_ptr(regs_in), nr,
            _np_ptr(regs_out), _np_ptr(extras), nr_cap,
            _np_ptr(cig_buf), cig_cap)
        if n_out != -2:
            break
        nr_cap *= 4
        cig_cap *= 4
    if n_out < 0:
        return None
    if aa is not a:
        a[:] = aa  # seed flags set by filter_bad_seeds
    return _rebuild_regions(n_out, regs_out, extras, cig_buf)


def _rebuild_regions(n_out, regs_out, extras, cig_buf):
    # Region fields are declared in _REG_ATTRS order, so positional
    # construction avoids 28 kwargs per region
    from .hits import Extra, Region
    out = []
    rows = regs_out[:n_out].tolist()
    exrows = extras[:n_out].tolist()
    divs = regs_out[:n_out, 26].view(np.float64).tolist()
    for i in range(n_out):
        row = rows[i]
        r = Region(*row[:26], divs[i])
        if row[27]:
            ex = exrows[i]
            r.p = Extra(dp_score=ex[0], dp_max=ex[1], dp_max2=ex[2],
                        n_ambi=ex[3], trans_strand=ex[4],
                        cigar=cig_buf[ex[5]:ex[5] + ex[6]].tolist())
        out.append(r)
    return out


def map_unit_ok(opt, mi) -> bool:
    """Eligibility for the one-call native per-read map path."""
    import os
    if os.environ.get("MM2TPU_NATIVE_SKELETON", "1") == "0":
        return False
    if not getattr(opt, "native_skeleton", True):
        return False
    if load_ksw() is None:
        return False
    C_SPLICE, C_NO_DIAG = 0x080, 0x001
    if (opt.flag & C_NO_DIAG) and not len(mi.name_rank):
        return False                  # ava needs the name-rank tables
    do_align = bool(opt.flag & 0x4)   # MM_F_CIGAR
    if do_align and (opt.flag & C_SPLICE):
        # the native exts2 kernel's envelope (batch_align gating)
        from .ops.ksw2 import gen_simple_mat
        mat = gen_simple_mat(5, opt.a, opt.b)
        if not (opt.q2 > opt.q + opt.e
                and -int(mat.min()) <= 2 * (opt.q + opt.e)):
            return False
    elif do_align and opt.q == opt.q2 and opt.e == opt.e2:
        return False                  # single-affine extz path
    if do_align and not (len(mi.S) and mi.S.flags.c_contiguous):
        return False
    return len(mi.keys) > 0


class _MapUnitCtx:
    """Per-(opt, mi) marshalling state for the native map-unit fast path:
    pre-built opt arrays + raw pointers + grow-only scratch buffers.
    One instance per calling thread (map_stream maps two batches on a
    thread pool)."""

    def __init__(self, mi, opt):
        from . import constants as CC
        from .ops.ksw2 import gen_simple_mat
        self.mi, self.opt = mi, opt
        self.seed = opt.seed
        self.is_sr = bool(opt.flag & CC.MM_F_SR)
        self.optv = np.array(
            [opt.flag, opt.a, opt.b, opt.q, opt.e, opt.q2, opt.e2,
             opt.zdrop, opt.zdrop_inv, opt.end_bonus, opt.min_cnt,
             opt.min_chain_score, opt.min_dp_max, opt.max_gap,
             opt.bw, opt.min_ksw_len, 0, 0, opt.max_chain_skip,
             opt.mid_occ, opt.best_n, opt.max_join_long,
             opt.max_join_short, opt.min_join_flank_sc,
             ((1 if opt.flag & CC.MM_F_FOR_ONLY else 0)
              | (2 if opt.flag & CC.MM_F_REV_ONLY else 0)),
             1 if opt.flag & CC.MM_F_CIGAR else 0,
             1 if opt.flag & (CC.MM_F_SPLICE | CC.MM_F_SR
                              | CC.MM_F_NO_LJOIN) else 0,
             1 if opt.flag & CC.MM_F_ALL_CHAINS else 0,
             opt.pe_ori, opt.pe_bonus,
             opt.noncan, opt.anchor_ext_len, opt.anchor_ext_shift,
             opt.sdust_thres],
            dtype=np.int64)
        self.optf = np.array([opt.mask_level, opt.pri_ratio,
                              opt.max_clip_ratio], dtype=np.float64)
        self.mat = _as_i8(gen_simple_mat(5, opt.a, opt.b))
        seq_off, seq_len = _mi_nat_tables(mi)
        self._refs = (mi.S, seq_off, seq_len, mi.keys, mi.starts, mi.values,
                      self.optv, self.optf, self.mat)
        self.ptrs = tuple(_np_ptr(x) for x in self._refs)
        self.n_seq = len(mi.seqs)
        self.n_keys = len(mi.keys)
        self.k, self.w = mi.k, mi.w
        self.hpc = 1 if (mi.flag & 1) else 0
        gq, gr = _map_gap_bounds(opt, 0)
        self.optv[16], self.optv[17] = gq, gr
        # ava self/dual skipping: per-read query rank among target names
        self.is_ava = bool(opt.flag & CC.MM_F_NO_DIAG)
        if self.is_ava:
            self.name_rank = np.ascontiguousarray(mi.name_rank,
                                                  dtype=np.int64)
            self.rank_ptr = _np_ptr(self.name_rank)
            self.sorted_names = mi.sorted_names
        else:
            self.rank_ptr = None
        self.nr_cap = 64
        self.cig_cap = 1 << 16
        self._alloc()
        self.text_cap = 1 << 17
        self._alloc_text()


    def _grow_text(self, code, grows) -> bool:
        """Grow the buffer the -2/-3 overflow code names; False = give up
        (bounded so a future non-shrinking overflow degrades to the
        python fallback instead of quadrupling memory forever)."""
        if grows >= 8:
            return False
        if code == -2:            # text capacity
            self.text_cap *= 4
            self._alloc_text()
        elif code == -3:          # line_off capacity only
            self.line_off = np.empty(4 * len(self.line_off),
                                     dtype=np.int64)
        else:
            return False
        return True

    def _alloc_text(self):
        self.text_buf = np.empty(self.text_cap, dtype=np.uint8)
        # line_cap must grow with text_cap: the native driver returns the
        # same -2 for a LINE-offset overflow (align_driver.cc n_lines+1 >=
        # line_cap) as for text overflow, and a fixed 258-slot buffer made
        # the grow-retry loop spin forever on reads with >=257 output
        # lines (e.g. -N 300 on a tandem-repeat mapping)
        self.line_off = np.empty(max(258, self.text_cap >> 9),
                                 dtype=np.int64)

    def _alloc(self):
        self.regs_out = np.empty((self.nr_cap, 28), dtype=np.int64)
        self.extras = np.empty((self.nr_cap, 7), dtype=np.int64)
        self.cig_buf = np.empty(self.cig_cap, dtype=np.uint32)
        self.misc = np.zeros(1, dtype=np.int64)
        self.out_ptrs = tuple(_np_ptr(x) for x in
                              (self.regs_out, self.extras, self.cig_buf,
                               self.misc))

    def _qrank(self, qname):
        """(q_exact, q_ins): the query name's exact / insertion rank among
        target names (the fork's dichotomy_sort, map.c:262-284)."""
        if not self.is_ava:
            return -1, 0
        import bisect
        pos = bisect.bisect_left(self.sorted_names, qname)
        exact = pos if (pos < len(self.sorted_names)
                        and self.sorted_names[pos] == qname) else -1
        return exact, pos

    def map(self, lib, qname, seq):
        from . import constants as CC
        qlen = len(seq)
        if qlen == 0:
            return None
        if self.is_sr or self.opt.max_frag_len > 0:
            self.optv[16], self.optv[17] = _map_gap_bounds(self.opt, qlen)
        qa = CC.seq_to_nt4(seq)
        hash_ = CC.qname_hash(qname, qlen, self.seed)
        want_cig = 8 * qlen + 8192
        if want_cig > self.cig_cap:
            self.cig_cap = want_cig
            self._alloc()
        p = self.ptrs
        while True:
            n_out = lib.mm2tpu_map_unit(
                _np_ptr(qa), qlen, hash_,
                p[0], p[1], p[2], self.n_seq, p[3], self.n_keys, p[4], p[5],
                self.k, self.w, self.hpc, p[8], p[6], p[7],
                self.out_ptrs[0], self.out_ptrs[1], self.nr_cap,
                self.out_ptrs[2], self.cig_cap, self.out_ptrs[3],
                self.rank_ptr, *self._qrank(qname))
            if n_out != -2:
                break
            self.nr_cap *= 4
            self.cig_cap *= 4
            self._alloc()
        if n_out < 0:
            return None
        return (_rebuild_regions(n_out, self.regs_out, self.extras,
                                 self.cig_buf), int(self.misc[0]))

    def map_text(self, lib, rec, rg_id: str):
        """Map one read and return its finished SAM/PAF lines (the fully
        native path: text emitted in C).  None = fall back."""
        from . import constants as CC
        seq = rec.seq
        qlen = len(seq)
        if qlen == 0:
            return None
        opt = self.opt
        if self.is_sr or opt.max_frag_len > 0:
            self.optv[16], self.optv[17] = _map_gap_bounds(opt, qlen)
        qa = CC.seq_to_nt4(seq)
        hash_ = CC.qname_hash(rec.name, qlen, self.seed)
        qname_b = rec.name.encode()
        seq_b = seq.encode()
        qual_b = rec.qual.encode() if rec.qual else None
        com_b = (rec.comment.encode()
                 if (opt.flag & CC.MM_F_COPY_COMMENT) and rec.comment
                 else None)
        rg_b = rg_id.encode() if rg_id else None
        blob, roffs = _mi_rname_blob(self.mi)
        sam_mode = 1 if opt.flag & CC.MM_F_OUT_SAM else 0
        want_text = 4 * qlen + 65536
        if want_text > self.text_cap:
            self.text_cap = want_text
            self._alloc_text()
        p = self.ptrs
        grows = 0
        while True:
            n_lines = lib.mm2tpu_map_unit_text(
                _np_ptr(qa), qlen, hash_,
                p[0], p[1], p[2], self.n_seq, p[3], self.n_keys, p[4], p[5],
                self.k, self.w, self.hpc, p[8], p[6], p[7],
                qname_b, len(qname_b), seq_b, qual_b,
                com_b, len(com_b) if com_b else 0,
                rg_b, len(rg_b) if rg_b else 0,
                _np_ptr(blob), _np_ptr(roffs), sam_mode,
                _np_ptr(self.text_buf), self.text_cap,
                _np_ptr(self.line_off), len(self.line_off),
                self.out_ptrs[3],
                self.rank_ptr, *self._qrank(rec.name))
            if n_lines >= 0 or n_lines == -1 \
                    or not self._grow_text(n_lines, grows):
                break
            grows += 1
        if n_lines < 0:
            return None
        offs = self.line_off[:n_lines + 1].tolist()
        tb = self.text_buf
        return [tb[offs[i]:offs[i + 1]].tobytes().decode("ascii",
                                                         "surrogateescape")
                for i in range(n_lines)]

    def map_batch_text(self, lib, recs, rg_id: str):
        """Map a BATCH of single-segment reads in one native call (the
        whole per-read loop runs in C — reference worker_for shape,
        map.c:598-636): returns a list with, per read, its finished
        text lines or None (contract fallback — remap that read on the
        staged path).  Returns None for the whole batch when ineligible
        (ava needs per-read rank context) or on repeated overflow."""
        if self.is_ava:
            return None
        from . import constants as CC
        opt = self.opt
        n = len(recs)
        if n == 0:
            return []
        seqs = [r.seq.encode() for r in recs]
        names = [r.name.encode() for r in recs]
        quals = [(r.qual.encode() if r.qual else b"") for r in recs]
        copy_com = bool(opt.flag & CC.MM_F_COPY_COMMENT)
        coms = [(r.comment.encode() if (copy_com and r.comment) else b"")
                for r in recs]
        seq_b, seq_o = _pack_blob(seqs, n)
        name_b, name_o = _pack_blob(names, n)
        qual_b, qual_o = _pack_blob(quals, n)
        com_b, com_o = _pack_blob(coms, n)
        rg_b = rg_id.encode() if rg_id else None
        rblob, roffs = _mi_rname_blob(self.mi)
        sam_mode = 1 if opt.flag & CC.MM_F_OUT_SAM else 0
        p = self.ptrs

        def call(text, text_cap, line_off, line_cap, rli, status):
            return lib.mm2tpu_map_batch_text(
                n, _np_ptr(seq_b), _np_ptr(seq_o),
                _np_ptr(name_b), _np_ptr(name_o),
                _np_ptr(qual_b), _np_ptr(qual_o),
                _np_ptr(com_b), _np_ptr(com_o),
                self.seed, opt.max_gap_ref, opt.max_frag_len,
                p[0], p[1], p[2], self.n_seq, p[3], self.n_keys,
                p[4], p[5], self.k, self.w, self.hpc, p[8], p[6], p[7],
                rg_b, len(rg_b) if rg_b else 0,
                _np_ptr(rblob), _np_ptr(roffs), sam_mode,
                _np_ptr(text), text_cap, _np_ptr(line_off), line_cap,
                _np_ptr(rli), _np_ptr(status))

        return _run_batch_call(call, n, int(seq_o[-1]))

    def map_batch_pe_text(self, lib, frag_segs, rg_id: str):
        """Map a BATCH of 2-segment (paired-end) fragments in one native
        call (per-pair loop in C — see map_batch_text).  frag_segs:
        list of (seg0, seg1).  Returns per-pair line lists (None =
        per-pair fallback) or None when unavailable."""
        from . import constants as CC
        opt = self.opt
        n = len(frag_segs)
        if n == 0:
            return []
        flips = _pe_flips(opt, 2)
        copy_com = bool(opt.flag & CC.MM_F_COPY_COMMENT)
        cols = []
        for j in (0, 1):
            segs = [fs[j] for fs in frag_segs]
            cols.append((_pack_blob([s.seq.encode() for s in segs], n),
                         _pack_blob([s.name.encode() for s in segs], n),
                         _pack_blob([(s.qual.encode() if s.qual else b"")
                                     for s in segs], n),
                         _pack_blob([(s.comment.encode()
                                      if copy_com and s.comment else b"")
                                     for s in segs], n)))
        rg_b = rg_id.encode() if rg_id else None
        rblob, roffs = _mi_rname_blob(self.mi)
        sam_mode = 1 if opt.flag & CC.MM_F_OUT_SAM else 0
        total_q = int(cols[0][0][1][-1] + cols[1][0][1][-1])
        p = self.ptrs

        def call(text, text_cap, line_off, line_cap, rli, status):
            return lib.mm2tpu_map_batch_pe_text(
                n,
                _np_ptr(cols[0][0][0]), _np_ptr(cols[0][0][1]),
                _np_ptr(cols[1][0][0]), _np_ptr(cols[1][0][1]),
                _np_ptr(cols[0][1][0]), _np_ptr(cols[0][1][1]),
                _np_ptr(cols[1][1][0]), _np_ptr(cols[1][1][1]),
                _np_ptr(cols[0][2][0]), _np_ptr(cols[0][2][1]),
                _np_ptr(cols[1][2][0]), _np_ptr(cols[1][2][1]),
                _np_ptr(cols[0][3][0]), _np_ptr(cols[0][3][1]),
                _np_ptr(cols[1][3][0]), _np_ptr(cols[1][3][1]),
                1 if flips[0] else 0, 1 if flips[1] else 0,
                self.seed, opt.max_gap_ref, opt.max_frag_len,
                p[0], p[1], p[2], self.n_seq, p[3], self.n_keys,
                p[4], p[5], self.k, self.w, self.hpc, p[8], p[6], p[7],
                rg_b, len(rg_b) if rg_b else 0,
                _np_ptr(rblob), _np_ptr(roffs), sam_mode,
                _np_ptr(text), text_cap, _np_ptr(line_off), line_cap,
                _np_ptr(rli), _np_ptr(status))

        return _run_batch_call(call, n, total_q)

    def map_text_chains(self, lib, rec, rg_id: str, chains, rep_len: int,
                        mini_pos):
        """Finish one read FROM PRECOMPUTED CHAINS (the device flow's
        output) and return its SAM/PAF lines: the native post-chain half
        (regions -> align -> mapq -> text), the fork's result_thread side
        (map.c:933-1015).  None = fall back to the staged pipeline."""
        from . import constants as CC
        seq = rec.seq
        qlen = len(seq)
        if qlen == 0:
            return None
        opt = self.opt
        qa = CC.seq_to_nt4(seq)
        hash_ = CC.qname_hash(rec.name, qlen, self.seed)
        qname_b = rec.name.encode()
        seq_b = seq.encode()
        qual_b = rec.qual.encode() if rec.qual else None
        com_b = (rec.comment.encode()
                 if (opt.flag & CC.MM_F_COPY_COMMENT) and rec.comment
                 else None)
        rg_b = rg_id.encode() if rg_id else None
        blob, roffs = _mi_rname_blob(self.mi)
        sam_mode = 1 if opt.flag & CC.MM_F_OUT_SAM else 0
        want_text = 4 * qlen + 65536
        if want_text > self.text_cap:
            self.text_cap = want_text
            self._alloc_text()
        a = np.ascontiguousarray(chains.anchors, dtype=np.uint64)
        u = np.ascontiguousarray(chains.u, dtype=np.uint64)
        mini = np.ascontiguousarray(mini_pos, dtype=np.uint64)
        p = self.ptrs
        grows = 0
        while True:
            n_lines = lib.mm2tpu_map_unit_text_chains(
                _np_ptr(qa), qlen, hash_,
                p[0], p[1], p[2], self.n_seq,
                _np_ptr(a), len(a), _np_ptr(u), len(u),
                _np_ptr(mini), len(mini), int(rep_len),
                self.k, self.hpc, p[8], p[6], p[7],
                qname_b, len(qname_b), seq_b, qual_b,
                com_b, len(com_b) if com_b else 0,
                rg_b, len(rg_b) if rg_b else 0,
                _np_ptr(blob), _np_ptr(roffs), sam_mode,
                _np_ptr(self.text_buf), self.text_cap,
                _np_ptr(self.line_off), len(self.line_off),
                self.out_ptrs[3])
            if n_lines >= 0 or n_lines == -1 \
                    or not self._grow_text(n_lines, grows):
                break
            grows += 1
        if n_lines < 0:
            return None
        offs = self.line_off[:n_lines + 1].tolist()
        tb = self.text_buf
        return [tb[offs[i]:offs[i + 1]].tobytes().decode("ascii",
                                                         "surrogateescape")
                for i in range(n_lines)]


def _pack_blob(parts, n):
    """Concatenate byte strings into one uint8 array + (n+1) offsets."""
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum([len(p) for p in parts], out=offs[1:])
    return (np.frombuffer(b"".join(parts) or b"\0", dtype=np.uint8), offs)


def _run_batch_call(call, n, total_q):
    """Shared grow-retry + decode protocol for the batched native text
    drivers.  `call(text, text_cap, line_off, line_cap, rli, status)`
    returns the C entry's 0 / -2 / -3; on success this decodes per-item
    line lists (None for status < 0).  Returns the list or None after
    repeated overflow."""
    text_cap = 8 * total_q + (1 << 20)
    line_cap = max(1024, 16 * n)
    rli = np.empty(n + 1, dtype=np.int64)
    status = np.empty(n, dtype=np.int32)
    grows = 0
    while True:
        text = np.empty(text_cap, dtype=np.uint8)
        line_off = np.empty(line_cap, dtype=np.int64)
        rc = call(text, text_cap, line_off, line_cap, rli, status)
        if rc == 0:
            break
        grows += 1
        if grows > 8:
            return None
        if rc == -2:
            text_cap *= 4
        line_cap *= 4   # more text implies more lines either way
    out = []
    for i in range(n):
        if status[i] < 0:
            out.append(None)
            continue
        lo, hi = int(rli[i]), int(rli[i + 1])
        out.append([text[line_off[t]:line_off[t + 1]].tobytes()
                    .decode("ascii", "surrogateescape")
                    for t in range(lo, hi)])
    return out


def _pe_flips(opt, n_segs):
    pe_ori = opt.pe_ori
    return [n_segs == 2 and ((j == 0 and (pe_ori >> 1 & 1))
                             or (j == 1 and (pe_ori & 1)))
            for j in range(n_segs)]


def _map_pe(base, lib, segs, rg_id: str):
    """PE marshalling over a _MapUnitCtx's buffers (stateless: every
    scratch buffer lives on `base`, which is already per-thread)."""
    from . import constants as CC
    from .io.fastx import strip_pair_suffix
    opt = base.opt
    qlens = [len(s.seq) for s in segs]
    qlen_sum = qlens[0] + qlens[1]
    if qlen_sum == 0 or min(qlens) == 0:
        return None
    flips = _pe_flips(opt, 2)
    qa = []
    for j, s in enumerate(segs):
        a = CC.seq_to_nt4(s.seq)
        if flips[j]:
            a = np.where(a < 4, (3 - a).astype(np.uint8),
                         np.uint8(4))[::-1].copy()
        qa.append(a)
    base.optv[16], base.optv[17] = _map_gap_bounds(opt, qlen_sum)
    hash_ = CC.qname_hash(segs[0].name, qlen_sum, opt.seed)
    sam_mode = 1 if opt.flag & CC.MM_F_OUT_SAM else 0
    if sam_mode:
        names = [strip_pair_suffix(s.name).encode() for s in segs]
    else:
        names = [s.name.encode() for s in segs]
    seqs = [s.seq.encode() for s in segs]
    quals = [s.qual.encode() if s.qual else None for s in segs]
    copy_com = bool(opt.flag & CC.MM_F_COPY_COMMENT)
    coms = [(s.comment.encode() if copy_com and s.comment else None)
            for s in segs]
    rg_b = rg_id.encode() if rg_id else None
    blob, roffs = _mi_rname_blob(base.mi)
    want_text = 4 * qlen_sum + 65536
    if want_text > base.text_cap:
        base.text_cap = want_text
        base._alloc_text()
    p = base.ptrs
    grows = 0
    while True:
        n_lines = lib.mm2tpu_map_frag_pe(
            _np_ptr(qa[0]), qlens[0], _np_ptr(qa[1]), qlens[1],
            1 if flips[0] else 0, 1 if flips[1] else 0, hash_,
            p[0], p[1], p[2], base.n_seq, p[3], base.n_keys, p[4], p[5],
            base.k, base.w, base.hpc, p[8], p[6], p[7],
            names[0], len(names[0]),
            names[0], len(names[0]), names[1], len(names[1]),
            seqs[0], quals[0], coms[0], len(coms[0]) if coms[0] else 0,
            seqs[1], quals[1], coms[1], len(coms[1]) if coms[1] else 0,
            rg_b, len(rg_b) if rg_b else 0,
            _np_ptr(blob), _np_ptr(roffs), sam_mode,
            _np_ptr(base.text_buf), base.text_cap,
            _np_ptr(base.line_off), len(base.line_off),
            base.out_ptrs[3])
        if n_lines >= 0 or n_lines == -1 \
                or not base._grow_text(n_lines, grows):
            break
        grows += 1
    if n_lines < 0:
        return None
    offs = base.line_off[:n_lines + 1].tolist()
    tb = base.text_buf
    return [tb[offs[i]:offs[i + 1]].tobytes().decode(
                "ascii", "surrogateescape") for i in range(n_lines)]


def map_frag_pe_native(mi, opt, segs, rg_id: str = ""):
    """Map one 2-segment (paired-end) fragment fully natively and return
    its finished output lines, or None to fall back."""
    from . import constants as CC
    lib = load_ksw()
    if lib is None or len(segs) != 2:
        return None
    if opt.flag & CC.MM_F_INDEPEND_SEG:
        return None
    return _map_pe(_map_ctx(mi, opt), lib, segs, rg_id)


_map_ctx_local = _threading.local()


def _map_ctx(mi, opt):
    ctx = getattr(_map_ctx_local, "ctx", None)
    if ctx is None or ctx.mi is not mi or ctx.opt is not opt:
        ctx = _MapUnitCtx(mi, opt)
        _map_ctx_local.ctx = ctx
    return ctx


def map_unit_native(mi, opt, qname: str, seq: str):
    """Map one single-segment read fully natively (align_driver.cc
    mm2tpu_map_unit).  Returns (regions, rep_len) or None."""
    lib = load_ksw()
    if lib is None:
        return None
    return _map_ctx(mi, opt).map(lib, qname, seq)


def map_unit_text_native(mi, opt, rec, rg_id: str = ""):
    """Map one single-segment read and return its finished output lines
    (SAM records or PAF rows), or None to fall back."""
    lib = load_ksw()
    if lib is None:
        return None
    return _map_ctx(mi, opt).map_text(lib, rec, rg_id)


def map_batch_text_native(mi, opt, recs, rg_id: str = ""):
    """Map a batch of single-segment reads through ONE native call;
    returns per-read lists of output lines (None entries = fall back
    per read), or None when the batch path is unavailable."""
    lib = load_ksw()
    if lib is None:
        return None
    return _map_ctx(mi, opt).map_batch_text(lib, recs, rg_id)


def map_batch_pe_native(mi, opt, frag_segs, rg_id: str = ""):
    """Map a batch of 2-segment fragments through ONE native call; per-
    pair lists of output lines (None entries = fall back), or None when
    unavailable (no lib / independent-segment mode)."""
    from . import constants as CC
    lib = load_ksw()
    if lib is None or (opt.flag & CC.MM_F_INDEPEND_SEG):
        return None
    return _map_ctx(mi, opt).map_batch_pe_text(lib, frag_segs, rg_id)


def map_unit_text_chains_native(mi, opt, rec, rg_id, chains, rep_len,
                                mini_pos):
    """Finish one single-segment read from precomputed chains (device
    flow output) and return its output lines, or None to fall back."""
    lib = load_ksw()
    if lib is None:
        return None
    return _map_ctx(mi, opt).map_text_chains(lib, rec, rg_id, chains,
                                             rep_len, mini_pos)


def _map_gap_bounds(opt, qlen_sum):
    """compute_gap_bounds (map.c:357-366) for a single-segment unit."""
    if opt.flag & 0x1000:  # MM_F_SR
        gq = max(qlen_sum, opt.max_gap)
    else:
        gq = opt.max_gap
    if opt.max_gap_ref > 0:
        gr = opt.max_gap_ref
    elif opt.max_frag_len > 0:
        gr = max(opt.max_frag_len - qlen_sum, opt.max_gap)
    else:
        gr = opt.max_gap
    return gq, gr


def extd2_batch_native(jobs, mat, q, e, q2, e2):
    """Run a batch of extd2 extension jobs natively; returns list[Ez] or
    None. jobs: dicts with qseq/tseq (uint8), w, zdrop, end_bonus, flag."""
    lib = load_ksw()
    if lib is None:
        return None
    from .ops.ksw2 import Ez
    n = len(jobs)
    # bulk packing: per-job Python work is one list append + one slice
    # assign per sequence; offsets/params come from vectorized numpy ops
    # (the packing loop used to cost more than the C kernel itself)
    qseqs = [j["qseq"] for j in jobs]
    tseqs = [j["tseq"] for j in jobs]
    lens = np.empty(2 * n + 1, dtype=np.int64)
    lens[0] = 0
    lens[1::2] = [len(s) for s in qseqs]
    lens[2::2] = [len(s) for s in tseqs]
    offs = np.cumsum(lens)
    qoff = np.ascontiguousarray(offs[0:2 * n + 1:2])
    toff = np.ascontiguousarray(offs[1::2])
    pos = int(offs[-1])
    params = np.array([(j["w"], j["zdrop"], j["end_bonus"], j["flag"])
                       for j in jobs], dtype=np.int32).reshape(-1)
    per_cig = lens[1::2] + lens[2::2] + 4
    cig_offs = np.ascontiguousarray(np.cumsum(per_cig) - per_cig)
    cpos = int(per_cig.sum())
    seq_buf = np.empty(pos, dtype=np.uint8)
    ol = offs.tolist()
    for i in range(n):
        seq_buf[ol[2*i]:ol[2*i+1]] = qseqs[i]
        seq_buf[ol[2*i+1]:ol[2*i+2]] = tseqs[i]
    ma = _as_i8(mat)
    ez_out = np.empty((n, 11), dtype=np.int64)
    cig_buf = np.empty(max(cpos, 1), dtype=np.uint32)
    cig_lens = np.empty(n, dtype=np.int64)
    # fused mm_test_zdrop scan for jobs that will be retested (fill pass 1)
    zwant = np.array([1 if j.get("want_zdrop") else 0 for j in jobs],
                     dtype=np.uint8)
    any_z = bool(zwant.any()) if n else False
    zout = np.empty((n, 5), dtype=np.int64) if any_z else None
    lib.mm2tpu_extd2_batch(
        _np_ptr(seq_buf), _np_ptr(qoff), _np_ptr(toff), n, _np_ptr(params),
        _np_ptr_cached(ma), q, e, q2, e2, _np_ptr(ez_out), _np_ptr(cig_buf),
        _np_ptr(cig_offs), _np_ptr(cig_lens),
        _np_ptr(zwant) if any_z else None,
        _np_ptr(zout) if any_z else None)
    out = []
    rows = ez_out.tolist()          # one bulk conversion, not 11n genexprs
    offs = cig_offs.tolist()
    lens = cig_lens.tolist()
    zrows = zout.tolist() if any_z else None
    zw = zwant.tolist() if any_z else None
    for i in range(n):
        ez = Ez()
        r = rows[i]
        ez.max = r[0]; ez.zdropped = r[1]; ez.max_q = r[2]; ez.max_t = r[3]
        ez.mqe = r[4]; ez.mqe_t = r[5]; ez.mte = r[6]; ez.mte_q = r[7]
        ez.score = r[8]; ez.reach_end = r[9]
        nc = lens[i]
        if nc:
            o = offs[i]
            ez.cigar = cig_buf[o:o + nc].tolist()
        if zrows is not None and zw[i]:
            zr = zrows[i]
            ez.zscan = (zr[0], [[zr[1], zr[2]], [zr[3], zr[4]]])
        out.append(ez)
    return out


def exts2_batch_native(jobs, mat, q, e, q2, noncan):
    """Run a batch of splice (exts2) extension jobs natively; returns
    list[Ez] or None. jobs: dicts with qseq/tseq (uint8), zdrop, flag."""
    lib = load_ksw()
    if lib is None:
        return None
    from .ops.ksw2 import Ez
    n = len(jobs)
    qseqs = [j["qseq"] for j in jobs]
    tseqs = [j["tseq"] for j in jobs]
    lens = np.empty(2 * n + 1, dtype=np.int64)
    lens[0] = 0
    lens[1::2] = [len(s) for s in qseqs]
    lens[2::2] = [len(s) for s in tseqs]
    offs = np.cumsum(lens)
    qoff = np.ascontiguousarray(offs[0:2 * n + 1:2])
    toff = np.ascontiguousarray(offs[1::2])
    pos = int(offs[-1])
    params = np.array([(j["zdrop"], j["flag"]) for j in jobs],
                      dtype=np.int32).reshape(-1)
    per_cig = lens[1::2] + lens[2::2] + 4
    cig_offs = np.ascontiguousarray(np.cumsum(per_cig) - per_cig)
    cpos = int(per_cig.sum())
    seq_buf = np.empty(pos, dtype=np.uint8)
    ol = offs.tolist()
    for i in range(n):
        seq_buf[ol[2*i]:ol[2*i+1]] = qseqs[i]
        seq_buf[ol[2*i+1]:ol[2*i+2]] = tseqs[i]
    ma = _as_i8(mat)
    ez_out = np.empty((n, 11), dtype=np.int64)
    cig_buf = np.empty(max(cpos, 1), dtype=np.uint32)
    cig_lens = np.empty(n, dtype=np.int64)
    lib.mm2tpu_exts2_batch(
        _np_ptr(seq_buf), _np_ptr(qoff), _np_ptr(toff), n, _np_ptr(params),
        _np_ptr_cached(ma), q, e, q2, noncan, _np_ptr(ez_out), _np_ptr(cig_buf),
        _np_ptr(cig_offs), _np_ptr(cig_lens))
    out = []
    rows = ez_out.tolist()
    offs = cig_offs.tolist()
    lens = cig_lens.tolist()
    for i in range(n):
        ez = Ez()
        r = rows[i]
        ez.max = r[0]; ez.zdropped = r[1]; ez.max_q = r[2]; ez.max_t = r[3]
        ez.mqe = r[4]; ez.mqe_t = r[5]; ez.mte = r[6]; ez.mte_q = r[7]
        ez.score = r[8]; ez.reach_end = r[9]
        nc = lens[i]
        if nc:
            o = offs[i]
            ez.cigar = cig_buf[o:o + nc].tolist()
        out.append(ez)
    return out


def fix_bad_ends_native(a, as_, cnt, mlen, bw, min_match):
    """Native mm_fix_bad_ends scan. Returns (as, cnt) or None."""
    lib = load_align()
    if lib is None or not a.flags.c_contiguous:
        return None
    out = np.zeros(2, dtype=np.int64)
    lib.mm2tpu_fix_bad_ends(_np_ptr(a), as_, cnt, mlen, bw, min_match,
                            _np_ptr(out))
    return int(out[0]), int(out[1])


def decode_cigar_native(ops, n_ops, fin_i, fin_j, is_rev, min_intron_len):
    """Native walker-step-code RLE into a CIGAR list, or None."""
    lib = load_align()
    if lib is None:
        return None
    o = np.ascontiguousarray(ops[:n_ops], dtype=np.int8)
    out = np.empty(n_ops + 2, dtype=np.uint32)
    n = lib.mm2tpu_decode_cigar(_np_ptr(o), n_ops, fin_i, fin_j,
                                1 if is_rev else 0, min_intron_len,
                                _np_ptr(out))
    return out[:n].tolist()


def collect_seeds_native(mi, max_occ, mv, qlen_sum, skip_mode):
    """Native seed-hit collection over the CSR index tables (non-ava path).
    Returns (anchors(n,2) u64 sorted by x, rep_len, mini_pos) or None."""
    lib = load_align()
    if lib is None:
        return None
    mva = np.ascontiguousarray(mv, dtype=np.uint64)
    sizes = np.zeros(3, dtype=np.int64)
    h = lib.mm2tpu_collect_seeds(
        _np_ptr(mva), len(mva), _np_ptr(mi.keys), len(mi.keys),
        _np_ptr(mi.starts), _np_ptr(mi.values), max_occ, qlen_sum,
        skip_mode, _np_ptr(sizes))
    anchors = np.empty((int(sizes[0]), 2), dtype=np.uint64)
    mini = np.empty(int(sizes[1]), dtype=np.uint64)
    lib.mm2tpu_collect_take(ctypes.c_void_p(h), _np_ptr(anchors),
                            _np_ptr(mini))
    return anchors, int(sizes[2]), mini


_SK_SRC = os.path.join(_ROOT, "native", "sketch.cc")
_SK_SO = os.path.join(_ROOT, "native", "libmm2tpu_sketch.so")
_sk_lib = None
_sk_tried = False


def _load_sketch():
    if _sk_lib is not None:
        return _sk_lib
    # NB: _sk_tried may only be consulted under the lock — a concurrent
    # loader sets it before _sk_lib is published, and an unlocked read
    # would wrongly report "tried, no lib"
    with _load_lock:
        return _load_sketch_locked()


def _load_sketch_locked():
    global _sk_lib, _sk_tried
    if _sk_lib is not None or _sk_tried:
        return _sk_lib
    _sk_tried = True
    try:
        if (not os.path.exists(_SK_SO)
                or os.path.getmtime(_SK_SO) < os.path.getmtime(_SK_SRC)):
            _compile_so([_SK_SRC], _SK_SO)
        lib = ctypes.CDLL(_SK_SO)
        lib.mm2tpu_sketch_batch.restype = ctypes.c_void_p
        lib.mm2tpu_sketch_batch.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint32), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mm2tpu_sketch_take.restype = None
        lib.mm2tpu_sketch_take.argtypes = [ctypes.c_void_p,
                                           ctypes.POINTER(ctypes.c_uint64)]
        lib.mm2tpu_build_csr.restype = ctypes.c_int64
        lib.mm2tpu_build_csr.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.mm2tpu_csr_begin.restype = ctypes.c_void_p
        lib.mm2tpu_csr_begin.argtypes = []
        lib.mm2tpu_csr_add.restype = None
        lib.mm2tpu_csr_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int64]
        lib.mm2tpu_csr_total.restype = ctypes.c_int64
        lib.mm2tpu_csr_total.argtypes = [ctypes.c_void_p]
        lib.mm2tpu_csr_merge.restype = ctypes.c_int64
        lib.mm2tpu_csr_merge.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.mm2tpu_csr_finish.restype = None
        lib.mm2tpu_csr_finish.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_void_p]
        lib.mm2tpu_csr_abort.restype = None
        lib.mm2tpu_csr_abort.argtypes = [ctypes.c_void_p]
        lib.mm2tpu_csr_begin_spill.restype = ctypes.c_void_p
        lib.mm2tpu_csr_begin_spill.argtypes = [ctypes.c_char_p]
        lib.mm2tpu_csr_status.restype = ctypes.c_int
        lib.mm2tpu_csr_status.argtypes = [ctypes.c_void_p]
        _sk_lib = lib
    except Exception:
        _sk_lib = None
    return _sk_lib


def sketch_batch_cat_native(cat: np.ndarray, offs: np.ndarray,
                            rids, w: int, k: int, is_hpc: bool):
    """Sketch sequence segments of an already-concatenated nt4 buffer
    (segment s = cat[offs[s]:offs[s+1]]). Returns a list of (n_i, 2)
    uint64 arrays, or None if unavailable."""
    lib = _load_sketch()
    if lib is None:
        return None
    n = len(offs) - 1
    cat = _as_u8(cat)
    offs = np.ascontiguousarray(offs, dtype=np.int64)
    rid_arr = np.asarray(rids, dtype=np.uint32)
    counts = np.zeros(n, dtype=np.int64)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    handle = lib.mm2tpu_sketch_batch(
        ptr(cat, ctypes.c_uint8), ptr(offs, ctypes.c_int64), n, w, k,
        ptr(rid_arr, ctypes.c_uint32), 1 if is_hpc else 0,
        ptr(counts, ctypes.c_int64))
    total = int(counts.sum())
    rows = np.empty((total, 2), dtype=np.uint64)
    lib.mm2tpu_sketch_take(ctypes.c_void_p(handle),
                           ptr(rows, ctypes.c_uint64))
    out = []
    pos = 0
    for c in counts:
        out.append(rows[pos:pos + int(c)])
        pos += int(c)
    return out


def sketch_batch_native(nt4_seqs: list[np.ndarray], w: int, k: int,
                        rids: list[int], is_hpc: bool):
    """Sketch a batch of nt4-encoded sequences natively.
    Returns a list of (n_i, 2) uint64 arrays, or None if unavailable."""
    if _load_sketch() is None:
        return None
    n = len(nt4_seqs)
    offs = np.zeros(n + 1, dtype=np.int64)
    for i, s in enumerate(nt4_seqs):
        offs[i + 1] = offs[i] + len(s)
    cat = (np.concatenate(nt4_seqs) if offs[-1]
           else np.empty(0, np.uint8)).astype(np.uint8, copy=False)
    return sketch_batch_cat_native(cat, offs, rids, w, k, is_hpc)


def sdust_native(b4: np.ndarray, T: int, W: int):
    """Native symmetric-DUST intervals for an nt4 sequence, or None."""
    lib = load_ksw()
    if lib is None:
        return None
    b4 = _as_u8(b4)   # bound to a local: a temporary's buffer would be
    cap = max(len(b4) // 8, 64)  # freed before the native call reads it
    while True:
        out = np.empty(2 * cap, dtype=np.int64)
        n = lib.mm2tpu_sdust(_np_ptr(b4), len(b4), T, W,
                             _np_ptr(out), cap)
        if n <= cap:
            return [(int(out[2 * i]), int(out[2 * i + 1]))
                    for i in range(n)]
        cap = n




def build_csr_native(mvs: list):
    """One-call CSR build from per-contig minimizer arrays: split key/val,
    sort by (key, val) and emit unique keys + run starts without the
    concat/shift/nonzero numpy passes.  Returns (keys, starts, values) or
    None (no lib)."""
    lib = _load_sketch()
    if lib is None:
        return None
    mvs = [m for m in mvs if len(m)]
    N = sum(len(m) for m in mvs)
    if N == 0:
        return (np.empty(0, np.uint64), np.zeros(1, np.int64),
                np.empty(0, np.uint64))
    arrs = [np.ascontiguousarray(m, dtype=np.uint64) for m in mvs]
    ptrs = np.array([_np_ptr(a) for a in arrs], dtype=np.uint64)
    ns = np.array([len(a) for a in arrs], dtype=np.int64)
    ukey = np.empty(N, np.uint64)
    val = np.empty(N, np.uint64)
    starts = np.empty(N + 1, np.int64)
    nk = lib.mm2tpu_build_csr(_np_ptr(ptrs), _np_ptr(ns), len(arrs),
                              _np_ptr(ukey), _np_ptr(val), _np_ptr(starts))
    # trim the over-allocated unique buffers (copies release the slack)
    return ukey[:nk].copy(), starts[:nk + 1].copy(), val


class CsrBuilder:
    """Streaming CSR build (VERDICT r3 weak #5): feed per-contig minimizer
    arrays as they are sketched — each is copied into a native sorted
    block and the caller frees its array — then one k-way merge fills
    exact-size output tables.  Bit-identical to build_csr_native (values
    are unique genome-wide, so block merge == full sort) but holds every
    pair ~once instead of twice and never over-allocates keys/starts:
    ~18 GB less peak RSS at 3 Gbp.  Thread-safe add() for the -t sketch
    workers.  None if the native lib is unavailable (caller falls back to
    the accumulate-then-build path)."""

    def __init__(self, lib, spill_dir=None):
        self._lib = lib
        self._spill_requested = spill_dir is not None
        if spill_dir is not None:
            self._h = lib.mm2tpu_csr_begin_spill(
                os.fsencode(str(spill_dir)))
            if not self.spilling:   # mkstemp failed -> silent RAM fallback
                import sys
                print("[mm2tpu] WARNING: requested spill build could not "
                      f"create a temp file in {spill_dir}; building "
                      "unbounded in RAM", file=sys.stderr)
        else:
            self._h = lib.mm2tpu_csr_begin()

    @classmethod
    def create(cls, spill: bool | None = None):
        """spill=True (or MM2TPU_BUILD_SPILL=1/0) streams sorted blocks to
        an unlinked temp file (MM2TPU_SPILL_DIR or TMPDIR) instead of RAM —
        the bounded-memory build for genome-scale indexes (~8 GB less peak
        at 3 Gbp, measured same wall time; bit-identical CSR).  Default
        (unset): the caller (index/build.py) auto-enables spill when the
        estimated pair volume crosses MM2TPU_SPILL_AUTO_GB."""
        lib = _load_sketch()
        if lib is None:
            return None
        if spill is None:
            spill = os.environ.get("MM2TPU_BUILD_SPILL", "0") == "1"
        if not spill:
            return cls(lib)
        import tempfile
        sdir = os.environ.get("MM2TPU_SPILL_DIR") or tempfile.gettempdir()
        return cls(lib, spill_dir=sdir)

    @property
    def spilling(self) -> bool:
        """Whether blocks are actually going to disk right now (ADVICE r4:
        a requested spill can silently fall back to RAM on mkstemp failure
        or disk-full; callers deserve a signal)."""
        return self._h is not None \
            and self._lib.mm2tpu_csr_status(self._h) == 1

    def add(self, mv: np.ndarray) -> None:
        if len(mv) == 0:
            return
        a = np.ascontiguousarray(mv, dtype=np.uint64)
        self._lib.mm2tpu_csr_add(self._h, _np_ptr(a), len(a))

    def finish(self):
        """-> (keys, starts, values); the handle is consumed.  The handle
        stays owned (abortable) until the last native call: a MemoryError
        from the GB-scale output allocations must still free the native
        accumulator via abort(), not leak it."""
        lib, h = self._lib, self._h
        if self._spill_requested and lib.mm2tpu_csr_status(h) & 2:
            import sys
            print("[mm2tpu] WARNING: spill build lost its disk mid-build "
                  "(write failure); later blocks accumulated in RAM",
                  file=sys.stderr)
        try:
            n = lib.mm2tpu_csr_total(h)
            val = np.empty(n, np.uint64)
            nk = lib.mm2tpu_csr_merge(h, _np_ptr(val))
            if nk < 0:
                raise RuntimeError(
                    "CSR spill read failed mid-merge (disk error)")
            ukey = np.empty(nk, np.uint64)
            starts = np.empty(nk + 1, np.int64)
        except BaseException:
            self.abort()
            raise
        self._h = None
        lib.mm2tpu_csr_finish(h, _np_ptr(ukey), _np_ptr(starts))
        return ukey, starts, val

    def abort(self) -> None:
        if self._h is not None:
            self._lib.mm2tpu_csr_abort(self._h)
            self._h = None


def chain_dp_native(max_dist_x, max_dist_y, bw, max_skip, min_cnt, min_sc,
                    is_cdna, n_segs, anchors: np.ndarray):
    """Full native chaining DP (top-half scan + compact + bottom).
    Exact port of ops/chain.py:chain_dp. Returns Chains or None."""
    from .ops.chain import Chains
    lib = _load()
    if lib is None:
        return None
    n = len(anchors)
    if n == 0:
        return Chains(np.empty((0, 2), np.uint64), np.empty(0, np.uint64))
    ax = np.ascontiguousarray(anchors[:, 0], dtype=np.uint64)
    ay = np.ascontiguousarray(anchors[:, 1], dtype=np.uint64)
    out_a = np.empty((2 * n, 2), dtype=np.uint64)
    out_u = np.empty(2 * n, dtype=np.uint64)
    n_v = ctypes.c_int64(0)
    n_u = lib.mm2tpu_chain_dp(
        n, _np_ptr(ax), _np_ptr(ay), max_dist_x, max_dist_y, bw, max_skip,
        min_cnt, min_sc, 1 if is_cdna else 0, n_segs,
        _np_ptr(out_a), _np_ptr(out_u), ctypes.addressof(n_v))
    return Chains(out_a[:n_v.value].copy(), out_u[:n_u].copy())


def chain_bottom_native(anchors: np.ndarray, f: np.ndarray, p: np.ndarray,
                        min_cnt: int, min_sc: int):
    """Native compact+backtrack from device (f, p). Returns a Chains or None
    if the native library is unavailable."""
    from .ops.chain import Chains
    lib = _load()
    if lib is None:
        return None
    n = len(anchors)
    if n == 0:
        return Chains(np.empty((0, 2), np.uint64), np.empty(0, np.uint64))
    ax = np.ascontiguousarray(anchors[:, 0], dtype=np.uint64)
    ay = np.ascontiguousarray(anchors[:, 1], dtype=np.uint64)
    f32 = np.ascontiguousarray(f, dtype=np.int32)
    p32 = np.ascontiguousarray(p, dtype=np.int32)
    out_a = np.empty((2 * n, 2), dtype=np.uint64)
    out_u = np.empty(2 * n, dtype=np.uint64)
    n_v = ctypes.c_int64(0)
    ptr = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))
    n_u = lib.mm2tpu_chain_bottom(
        n, ptr(ax, ctypes.c_uint64), ptr(ay, ctypes.c_uint64),
        ptr(f32, ctypes.c_int32), ptr(p32, ctypes.c_int32),
        min_cnt, min_sc,
        ptr(out_a, ctypes.c_uint64), ptr(out_u, ctypes.c_uint64),
        ctypes.byref(n_v))
    return Chains(out_a[:n_v.value].copy(), out_u[:n_u].copy())


_PROF_STAGES = ("sketch", "collect", "chain", "finish", "align", "text",
                "_r6", "_r7")


def key_lookup_batch(keys: np.ndarray, qk: np.ndarray):
    """Batched lower_bound over the sorted key table via the native
    prefix directory (== np.searchsorted(keys, qk) positions). None when
    the native lib is unavailable or the table is small enough that
    numpy's plain search is already fine (keeps tests on both paths)."""
    if len(keys) < (1 << 20):
        return None
    # the ksw lib, not the align lib: the per-read driver lives there and
    # has already built (and content-cached) the directory for this
    # index — the align .so is a separate copy of the same TU with its
    # own cache, and building a second 100+ MB directory per process
    # showed up as the steal lane's first-chunk cost
    lib = load_ksw()
    if lib is None:
        return None
    k = np.ascontiguousarray(keys, dtype=np.uint64)  # no-copy when clean
    q = np.ascontiguousarray(qk, dtype=np.uint64)
    out = np.empty(len(q), np.int64)
    lib.mm2tpu_key_lookup_batch(_np_ptr(k), len(k), _np_ptr(q),
                                len(q), _np_ptr(out))
    return out


def prof_read() -> dict | None:
    """Per-stage wall nanoseconds of the native driver since start/reset
    (align_driver.cc ProfScope; requires MM2TPU_PROF=1 in the process
    env BEFORE the first native call). Stage 'align' nests inside
    'finish'. None if the native lib is unavailable."""
    lib = load_ksw()
    if lib is None:
        return None
    out = np.zeros(8, np.int64)
    lib.mm2tpu_prof_read(_np_ptr(out))
    return {k: int(v) for k, v in zip(_PROF_STAGES, out)
            if not k.startswith("_")}


def prof_reset() -> None:
    lib = load_ksw()
    if lib is not None:
        lib.mm2tpu_prof_reset()
        lib.mm2tpu_collect_prof_reset()


def collect_prof_read() -> dict | None:
    """Collect-stage sub-split (MM2TPU_PROF=1): nanoseconds in the key
    lookup vs occurrence expand+sort — the split that pinned the r5
    genome-scale collect cost to the per-minimizer key search."""
    lib = load_ksw()
    if lib is None:
        return None
    out = np.zeros(2, np.int64)
    lib.mm2tpu_collect_prof_read(_np_ptr(out))
    return {"key_lookup": int(out[0]), "expand_sort": int(out[1])}
