"""ctypes binding for the native FASTX reader (native/fastx_reader.cc) —
the C++ equivalent of the reference's bseq.c/kseq.h sequence-IO layer.
Batches cross the Python boundary as packed arenas, one ctypes round-trip
per multi-megabase block. Falls back to None when the toolchain or zlib
dev files are unavailable (io/fastx.py then uses the pure-Python parser)."""
from __future__ import annotations

import ctypes
import os
import threading

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "fastx_reader.cc")
_SO = os.path.join(_ROOT, "native", "libmm2tpu_fastx.so")
_lib = None
_tried = False
_load_lock = threading.Lock()


def _load():
    # serialized like native.py's loaders: two threads racing the stale-so
    # check would compile concurrently, and the loser would see _tried
    # mid-compile and silently pin itself to the pure-Python parser
    global _lib, _tried
    if _lib is not None:
        return _lib
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
            from ..native import _compile_so
            _compile_so([_SRC], _SO, extra=("-lz",))
        lib = ctypes.CDLL(_SO)
        lib.fxr_open.restype = ctypes.c_void_p
        lib.fxr_open.argtypes = [ctypes.c_char_p]
        lib.fxr_read_block.restype = ctypes.c_int64
        lib.fxr_read_block.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        for name in ("fxr_text", "fxr_bases"):
            getattr(lib, name).restype = ctypes.POINTER(ctypes.c_char)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.fxr_bases_len.restype = ctypes.c_int64
        lib.fxr_bases_len.argtypes = [ctypes.c_void_p]
        for name in ("fxr_name_off", "fxr_comment_off", "fxr_seq_off",
                     "fxr_seq_len", "fxr_qual_off"):
            getattr(lib, name).restype = ctypes.POINTER(ctypes.c_int64)
            getattr(lib, name).argtypes = [ctypes.c_void_p]
        lib.fxr_close.restype = None
        lib.fxr_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def read_fastx_native(path: str, block_bases: int = 8_000_000):
    """Yield (name, seq, qual|None, comment|None) tuples via the native
    reader, in blocks of ~block_bases."""
    lib = _load()
    h = lib.fxr_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        while True:
            n = lib.fxr_read_block(h, block_bases)
            if n < 0:    # hard IO/zlib error (unreadable path, bad gzip)
                raise OSError(f"{path}: read error (unreadable input or "
                              "corrupt gzip stream)")
            if n == 0:
                return
            blen = lib.fxr_bases_len(h)
            bases = ctypes.string_at(lib.fxr_bases(h), blen) if blen else b""
            text_p = lib.fxr_text(h)
            name_off = lib.fxr_name_off(h)
            comment_off = lib.fxr_comment_off(h)
            seq_off = lib.fxr_seq_off(h)
            seq_len = lib.fxr_seq_len(h)
            qual_off = lib.fxr_qual_off(h)
            for i in range(n):
                name = ctypes.string_at(
                    ctypes.byref(text_p.contents, name_off[i])).decode()
                co = comment_off[i]
                comment = None if co < 0 else ctypes.string_at(
                    ctypes.byref(text_p.contents, co)).decode()
                so, sl = seq_off[i], seq_len[i]
                seq = bases[so:so + sl].decode()
                qo = qual_off[i]
                qual = None if qo < 0 else bases[qo:qo + sl].decode()
                yield name, seq, qual, comment
    finally:
        lib.fxr_close(h)
