# Frozen copy of minimap2_chaindp_tpu/utils/mlog.py, the JAX package's host
# golden model (at commit 241cda7 the same bytes as the port's
# minimap2_chaindp_tpu_torch/utils/mlog.py), the reference's host model: its
# native calls go to nonative.py, which returns None, so each takes its
# numpy or Python path.
"""The reference's stderr logging surface (misc.c realtime/cputime +
`[M::func::%.3f*%.2f]` lines, main.c:621-627 banner).

`verbose` mirrors the global mm_verbose: 1 by default (library use), set
to 3 by the CLI (main.c:304) unless -v overrides it."""
from __future__ import annotations

import os
import sys
import time

verbose = 1
dbg_flag = 0  # mm_dbg_flag bitfield (constants.MM_DBG_*)
_t0 = time.time()


def set_verbose(v: int) -> None:
    global verbose
    verbose = v


def set_dbg(flag: int) -> None:
    global dbg_flag
    dbg_flag = flag


def reset_timer() -> None:
    global _t0
    _t0 = time.time()


def _cpu() -> float:
    t = os.times()
    return t.user + t.system + t.children_user + t.children_system


def mlog(fn: str, msg: str, level: int = 3) -> None:
    """`[M::fn::wall*cpu] msg` (reference liftover of realtime()/cputime())."""
    if verbose < level:
        return
    wall = time.time() - _t0
    ratio = _cpu() / wall if wall > 0 else 0.0
    print(f"[M::{fn}::{wall:.3f}*{ratio:.2f}] {msg}", file=sys.stderr)


def mlog_plain(fn: str, msg: str, level: int = 3) -> None:
    if verbose >= level:
        print(f"[M::{fn}] {msg}", file=sys.stderr)


def banner(version: str, argv: list[str]) -> None:
    """Final Version/CMD/time banner (main.c:621-627)."""
    if verbose < 3:
        return
    print(f"[M::main] Version: {version}", file=sys.stderr)
    print("[M::main] CMD: mm2tpu " + " ".join(argv), file=sys.stderr)
    print(f"[M::main] Real time: {time.time() - _t0:.3f} sec; "
          f"CPU: {_cpu():.3f} sec", file=sys.stderr)
