"""Build the port's CUDA sources (`csrc/*.cu`) with nvcc into one shared
library with a plain C interface, and load it with ctypes. Each source is
compiled by its own nvcc process, all started together, and the objects
are linked into the library.

The library lands in `build/cuda/<hash>/` under the checkout (gitignored),
keyed by a hash of the sources and the compiler flags, so a changed source
rebuilds and an unchanged one loads at once. Nothing is built when the
module is imported: `load()` builds on first use.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libmm2tpu_torch_kernels.so"

_lock = threading.Lock()
_lib = None


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def build() -> dict:
    """Compile csrc/*.cu unless this source hash is already built. Returns
    {"path", "seconds", "cached", "log"} (log: the compilers' output);
    raises with the compiler output on failure."""
    out_dir = os.path.join(BUILD_DIR, source_hash())
    so_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(so_path):
        return dict(path=so_path, seconds=0.0, cached=True, log="")
    os.makedirs(out_dir, exist_ok=True)
    # unique temp names + rename: a concurrent build never loads a
    # half-written library
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = f"{so_path}.{tag}.tmp"
    nvcc = nvcc_path()
    objs = [os.path.join(out_dir, f"{os.path.basename(src)}.{tag}.o")
            for src in sources()]
    t0 = time.perf_counter()
    log = ""
    try:
        procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
                 for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                             for src, obj in zip(sources(), objs))]
        failed = []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            log += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so_path)
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.remove(path)
    return dict(path=so_path, seconds=time.perf_counter() - t0,
                cached=False, log=log)


def load() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library and declare the C
    prototypes (every pointer and the stream as c_void_p)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build()["path"])
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.mm2tpu_chain_dp.restype = ci
            lib.mm2tpu_chain_dp.argtypes = [vp] * 12 + [ci] * 8 + [vp]
            lib.mm2tpu_ksw_forward.restype = ci
            lib.mm2tpu_ksw_forward.argtypes = ([vp] * 9 + [ctypes.c_longlong]
                                               + [ci] * 12 + [vp])
            lib.mm2tpu_ksw_walk.restype = ci
            lib.mm2tpu_ksw_walk.argtypes = [vp] * 5 + [ci] * 2 + [vp]
            _lib = lib
    return _lib
