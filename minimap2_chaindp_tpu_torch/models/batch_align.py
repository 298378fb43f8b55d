"""Extension-job waves on the card: the executor the wave scheduler
(`run_scheduler`, shared with the JAX package) hands every in-flight read's
current jobs to.

Port of minimap2_chaindp_tpu/models/batch_align.py:DeviceAlignExecutor
(:30-197) with the same interface (`run(jobs) -> thunks`) and counters
(`n_device`, `n_native`, `n_host`). Jobs inside the kernel's domain go to
the CUDA ksw2 kernels with the backtrack walk on the card (exts2 under
splice scoring, extd2 otherwise); the rest, and waves with fewer than
MIN_DEV_JOBS such jobs, go to the native host batch, and to the NumPy
model only where the native library is missing. There is no native
crossover for eligible jobs, no timeout and no fallback: a CUDA error
raises.
"""
from __future__ import annotations

import threading
from contextlib import nullcontext

import torch

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.align import _host_thunk
from minimap2_chaindp_tpu.models.batch_align import (MAX_QLEN, MAX_TLEN,
                                                     MIN_DEV_JOBS,
                                                     run_scheduler)
from minimap2_chaindp_tpu.ops import ksw2 as K

from ..ops import ksw2_ext as KE

__all__ = ["CudaAlignExecutor", "run_scheduler"]


class CudaAlignExecutor:
    """Executes extension-job waves: the CUDA ksw2 kernels on `device`
    (the plain versions when it is the CPU) for eligible jobs, the native
    host batch for the rest. `timers`, when given, also receives the
    counts as ext_device / ext_native / ext_host."""

    def __init__(self, opt, device="cuda", timers=None):
        self.opt = opt
        self.device = torch.device(device)
        self.timers = timers
        self.mat = K.gen_simple_mat(5, opt.a, opt.b)
        # the kernel modes' domains (batch_align.py:57-64): splice scoring
        # takes exts2; genomic scoring takes extd2 unless it degenerates to
        # the single-affine extz path; both need the reference's
        # precondition -min(mat) <= 2 * (q + e)
        self.splice = bool(opt.flag & C.MM_F_SPLICE)
        if self.splice:
            self.enabled = opt.q2 > opt.q + opt.e \
                and -int(self.mat.min()) <= 2 * (opt.q + opt.e)
        else:
            self.enabled = not (opt.q == opt.q2 and opt.e == opt.e2) \
                and -int(self.mat.min()) <= 2 * min(opt.q + opt.e,
                                                    opt.q2 + opt.e2)
        self.n_device = self.n_native = self.n_host = 0
        self._lock = threading.Lock()   # two map_stream batch threads

    def _count(self, name: str, n: int) -> None:
        if not n:
            return
        with self._lock:
            setattr(self, f"n_{name}", getattr(self, f"n_{name}") + n)
        if self.timers is not None:
            self.timers.count(f"ext_{name}", n)

    def _eligible(self, job) -> bool:
        ql, tl = len(job["qseq"]), len(job["tseq"])
        return self.enabled and 0 < ql <= MAX_QLEN and 0 < tl <= MAX_TLEN

    def run(self, jobs) -> list:
        thunks: list = [None] * len(jobs)
        dev = [i for i, j in enumerate(jobs) if self._eligible(j)]
        if len(dev) < MIN_DEV_JOBS:
            dev = []
        if dev:
            o = self.opt
            span = nullcontext() if self.timers is None \
                else self.timers.time("ext_wave")
            with span:   # pack, launches, read-back and CIGAR decode
                if self.splice:
                    res = KE.exts2_batch([jobs[i] for i in dev], self.mat,
                                         o.q, o.e, o.q2, o.noncan,
                                         device=self.device)
                else:
                    res = KE.extd2_batch([jobs[i] for i in dev], self.mat,
                                         o.q, o.e, o.q2, o.e2,
                                         device=self.device)
            for i, ez in zip(dev, res):
                thunks[i] = (lambda v=ez: v)
            self._count("device", len(dev))
        rest = [i for i in range(len(jobs)) if thunks[i] is None]
        nat_fn = None
        if rest and self.splice:
            from minimap2_chaindp_tpu.native import exts2_batch_native
            nat_fn = lambda js: exts2_batch_native(
                js, self.mat, self.opt.q, self.opt.e, self.opt.q2,
                self.opt.noncan)
        elif rest and not (self.opt.q == self.opt.q2
                           and self.opt.e == self.opt.e2):
            from minimap2_chaindp_tpu.native import extd2_batch_native
            nat_fn = lambda js: extd2_batch_native(
                js, self.mat, self.opt.q, self.opt.e, self.opt.q2,
                self.opt.e2)
        res = nat_fn([jobs[i] for i in rest]) if nat_fn is not None else None
        if res is not None:
            for i, ez in zip(rest, res):
                thunks[i] = (lambda v=ez: v)
            self._count("native", len(rest))
            rest = []
        for i in rest:
            thunks[i] = _host_thunk(self.opt, self.mat, jobs[i])
        self._count("host", len(rest))
        return thunks
