"""Extension-job waves: the scheduler that gathers every in-flight read's
current jobs (`run_scheduler`) and the executors it hands them to.

Port of minimap2_chaindp_tpu/models/batch_align.py. `run_scheduler` is
copied from it (:200-230). `CudaAlignExecutor` takes the place of its
DeviceAlignExecutor (:30-197) with the same interface (`run(jobs) ->
thunks`) and counters (`n_device`, `n_native`, `n_host`): jobs with
len(qseq) + len(tseq) <= `native_max` go to the native host SIMD batch
first (the native crossover, :114-123); of the rest, jobs inside the
kernels' domain go to the CUDA ksw2 kernels with the backtrack walk on the
card (exts2 under splice scoring, extd2 otherwise); what is left, and
waves with fewer than MIN_DEV_JOBS such jobs, goes to the native host
batch, and to the NumPy model only where the native library is missing.
There is no timeout and no fallback: a CUDA error raises.
`HostAlignExecutor` is the host half alone (DeviceAlignExecutor with
use_device=False), which HostRuntime uses.

The kernels' domain is a rule on what a job's shape costs them, not the
JAX executor's caps of 16384 bases a side (the Pallas kernel's):
- its backtrack bytes (`ksw2_pack._p_sizes`: rows x the band's row
  stride) fit one launch's `ksw2_ext.P_BUDGET`, so that it is never the
  launch that exhausts the card. That is what a long job costs: its
  on-chip rows are sized by its band, not by its target (a 300-base
  spliced query over a 40 kb target needs a ring of 512 lanes), and a
  ring past shared memory takes the device-memory form;
- query plus target stay within LEN_MAX bases, so that its rows and
  target lanes fit the kernels' 32-bit indices (the device-memory
  form's scan key is 2^28 + t).
A job the card takes with a side past 16384 bases, which the JAX executor
leaves to the host, is counted as ext_long_device too.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext

import numpy as np
import torch

from .. import constants as C
from ..align import _host_thunk
from ..ops import ksw2 as K
from ..ops import ksw2_ext as KE
from ..ops.ksw2_pack import _job_fields, _p_sizes

__all__ = ["CudaAlignExecutor", "HostAlignExecutor", "run_scheduler"]

# query plus target bases of a job on the card: the kernels' 32-bit
# indices (see the module docstring)
LEN_MAX = 1 << 30
# a side longer than this counts the job as ext_long_device (the JAX
# executor's caps, :21-23 of the JAX package's module)
LONG_SIDE = 16384
MIN_DEV_JOBS = 4     # tiny waves aren't worth a device launch
# at or above this crossover the native one-call align skeleton stays on
# for the executor's opt (models/batch_align.py:25-27, :74-91)
NATIVE_MAX_DEFAULT = 100000


class HostAlignExecutor:
    """Executes extension-job waves on the host: one native SIMD batch call
    per wave (exts2 under splice scoring, extd2 otherwise; the
    single-affine q == q2, e == e2 case has no native batch), the NumPy
    model where the native library is missing. `timers`, when given, also
    receives the counts as ext_device / ext_native / ext_host."""

    def __init__(self, opt, timers=None):
        self.opt = opt
        self.timers = timers
        self.mat = K.gen_simple_mat(5, opt.a, opt.b)
        self.splice = bool(opt.flag & C.MM_F_SPLICE)
        self.n_device = self.n_native = self.n_host = 0
        self.n_long_device = 0
        self._lock = threading.Lock()   # two map_stream batch threads

    def _span(self, name: str):
        return nullcontext() if self.timers is None \
            else self.timers.time(name)

    def _count(self, name: str, n: int) -> None:
        if not n:
            return
        with self._lock:
            setattr(self, f"n_{name}", getattr(self, f"n_{name}") + n)
        if self.timers is not None:
            self.timers.count(f"ext_{name}", n)

    def _run_native(self, jobs, thunks, idxs) -> list:
        """Fill the slots `idxs` from one native SIMD batch call (exts2
        under splice scoring, extd2 otherwise; the single-affine q == q2,
        e == e2 case has none). Returns the slots it left empty."""
        o = self.opt
        nat_fn = None
        if idxs and self.splice:
            from ..native import exts2_batch_native
            nat_fn = lambda js: exts2_batch_native(js, self.mat, o.q, o.e,
                                                   o.q2, o.noncan)
        elif idxs and not (o.q == o.q2 and o.e == o.e2):
            from ..native import extd2_batch_native
            nat_fn = lambda js: extd2_batch_native(js, self.mat, o.q, o.e,
                                                   o.q2, o.e2)
        res = None
        if nat_fn is not None:
            with self._span("ext_native"):
                res = nat_fn([jobs[i] for i in idxs])
        if res is None:
            return idxs
        for i, ez in zip(idxs, res):
            thunks[i] = (lambda v=ez: v)
        self._count("native", len(idxs))
        return []

    def _run_host(self, jobs, thunks) -> list:
        """Fill every empty slot of `thunks` from the native batch, or
        lazily from the NumPy model."""
        rest = self._run_native(
            jobs, thunks, [i for i in range(len(jobs)) if thunks[i] is None])
        o = self.opt
        for i in rest:
            thunks[i] = _host_thunk(o, self.mat, jobs[i])
        self._count("host", len(rest))
        return thunks

    def run(self, jobs) -> list:
        return self._run_host(jobs, [None] * len(jobs))


class CudaAlignExecutor(HostAlignExecutor):
    """Executes extension-job waves: the native host batch for jobs of at
    most `native_max` bases (query plus target), the CUDA ksw2 kernels on
    `device` (the plain versions when it is the CPU) for the eligible rest,
    the native host batch for what is left. `timers`, when given, also
    receives the counts as ext_device / ext_native / ext_host.

    As the JAX executor's `_sync_native_skeleton` does, a crossover below
    NATIVE_MAX_DEFAULT switches `opt.native_skeleton` off, so that the
    align skeleton yields its jobs as waves; at or above it the native
    one-call skeleton aligns the units and no wave reaches the executor.
    The flag is only ever switched off, never on."""

    def __init__(self, opt, device="cuda", timers=None, native_max: int = 0):
        super().__init__(opt, timers)
        self.device = torch.device(device)
        self.native_max = int(native_max)
        if self.native_max < NATIVE_MAX_DEFAULT:
            opt.native_skeleton = False
        # the kernel modes' domains: splice scoring takes exts2; genomic
        # scoring takes extd2 unless it degenerates to the single-affine
        # extz path; both need the reference's precondition
        # -min(mat) <= 2 * (q + e) (ksw2_extd2_sse.c:91-92)
        if self.splice:
            self.enabled = opt.q2 > opt.q + opt.e \
                and -int(self.mat.min()) <= 2 * (opt.q + opt.e)
        else:
            self.enabled = not (opt.q == opt.q2 and opt.e == opt.e2) \
                and -int(self.mat.min()) <= 2 * min(opt.q + opt.e,
                                                    opt.q2 + opt.e2)

    def _eligible(self, jobs) -> tuple[np.ndarray, np.ndarray]:
        """Which of `jobs` lie in the kernels' domain (module docstring),
        and which of those have a side past LONG_SIDE bases."""
        qlen, tlen, flag, w = _job_fields(jobs, self.splice)
        ok = (qlen > 0) & (tlen > 0) & (qlen + tlen <= LEN_MAX) \
            & (_p_sizes(qlen, tlen, flag, w, self.splice)[1]
               <= KE.P_BUDGET)
        return ok & self.enabled, np.maximum(qlen, tlen) > LONG_SIDE

    def run(self, jobs) -> list:
        thunks: list = [None] * len(jobs)
        if self.native_max > 0:
            self._run_native(jobs, thunks, [
                i for i, j in enumerate(jobs)
                if len(j["qseq"]) + len(j["tseq"]) <= self.native_max])
        ok, long_side = self._eligible(jobs)
        dev = [i for i in np.flatnonzero(ok).tolist() if thunks[i] is None]
        if len(dev) < MIN_DEV_JOBS:
            dev = []
        if dev:
            o = self.opt
            # pack, upload, launches, the wait, read-back and CIGAR decode
            with self._span("ext_wave"):
                if self.splice:
                    res = KE.exts2_batch([jobs[i] for i in dev], self.mat,
                                         o.q, o.e, o.q2, o.noncan,
                                         device=self.device,
                                         timers=self.timers)
                else:
                    res = KE.extd2_batch([jobs[i] for i in dev], self.mat,
                                         o.q, o.e, o.q2, o.e2,
                                         device=self.device,
                                         timers=self.timers)
            for i, ez in zip(dev, res):
                thunks[i] = (lambda v=ez: v)
            self._count("device", len(dev))
            self._count("long_device", int(long_side[dev].sum()))
        if all(t is not None for t in thunks):
            return thunks
        with self._span("ext_host"):
            return self._run_host(jobs, thunks)


def run_scheduler(gens: list, executor) -> list:
    """Drive many wave-yielding generators to completion, executing the
    union of their current waves in one executor call per round.
    Returns each generator's StopIteration value, in order. Each round's
    advance of the generators (the Python align skeleton) is one
    `skeleton` span of the executor's timers, where it has them."""
    timers = getattr(executor, "timers", None)
    skeleton = (lambda: nullcontext()) if timers is None \
        else (lambda: timers.time("skeleton"))
    results = [None] * len(gens)
    live: dict[int, tuple] = {}
    with skeleton():
        for idx, g in enumerate(gens):
            try:
                live[idx] = (g, next(g))
            except StopIteration as e:
                results[idx] = e.value
    while live:
        all_jobs: list = []
        spans: dict[int, tuple[int, int]] = {}
        for idx, (g, wave) in live.items():
            spans[idx] = (len(all_jobs), len(wave))
            all_jobs.extend(wave)
        thunks = executor.run(all_jobs)
        nxt: dict[int, tuple] = {}
        with skeleton():
            for idx, (g, wave) in live.items():
                off, ln = spans[idx]
                try:
                    nxt[idx] = (g, g.send(thunks[off:off + ln]))
                except StopIteration as e:
                    results[idx] = e.value
        live = nxt
    return results
