"""The largest input each kernel wrapper takes while a block of mapping
runs, kept in memory so that the kernels can be held against their plain
versions on it afterwards, in the same process (chip_smoke.py does so in
its phases 10-12):

    with kernel_inputs.record() as rec:
        ...                         # mapping runs on the card
    rec.chain["single"]             # (slots, args, kw) of the largest input
    rec.ksw                         # (cells, jobs, splice, noncan)

`record()` wraps the chain wrapper where the runtime's paths call it
(models/device_flow, models/runtime, models/device_pipeline) and keeps, by
mode (single, many_segs, cdna), the input with the most anchor slots; it
wraps ops/ksw2_ext.pack_jobs and _batch_async and keeps the extension
launch with the most DP cells (its jobs and mode; `rec.scoring[splice]`
the forward wrapper's scoring for that mode) and, apart in `rec.ksw_n`,
the launch with the most DP cells among those holding base code 4 (an N,
or an IUPAC code as seq_nt4_table reads it) in a query or target. Calls
from several threads (map_stream's two batch threads) are kept under one
lock. The wrappers themselves and their launch counts are untouched, and
the block's exit, by an exception too, puts the originals back.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np


def chain_mode(kw) -> str:
    return "cdna" if kw["is_cdna"] else (
        "many_segs" if kw["many_segs"] else "single")


class Recorder:
    def __init__(self):
        self.chain: dict[str, tuple] = {}   # mode -> (slots, args, kw)
        self.ksw = None                     # (cells, jobs, splice, noncan)
        self.ksw_n = None                   # the same, with a code 4
        self.scoring: dict[bool, tuple] = {}   # splice -> forward scoring
        self._lock = threading.Lock()


@contextlib.contextmanager
def record():
    from ..models import device_flow, device_pipeline, runtime
    from ..ops import ksw2_ext
    rec = Recorder()
    sites = (device_flow, device_pipeline, runtime)
    real_chain = {m: m.chain_scores_batch for m in sites}
    real_pack, real_batch = ksw2_ext.pack_jobs, ksw2_ext._batch_async

    def chain_at(site):
        def chain(*a, **kw):
            slots = a[1].numel()
            mode = chain_mode(kw)
            with rec._lock:
                if slots > rec.chain.get(mode, (0,))[0]:
                    rec.chain[mode] = (slots, a, dict(kw))
            return real_chain[site](*a, **kw)
        return chain

    def pack(jobs, *, splice, noncan=0):
        pk = real_pack(jobs, splice=splice, noncan=noncan)
        cells = int((pk["meta"][:, 0].astype(np.int64)
                     * pk["meta"][:, 1]).sum())
        has_n = any((j["qseq"] == 4).any() or (j["tseq"] == 4).any()
                    for j in jobs)
        with rec._lock:
            if rec.ksw is None or cells > rec.ksw[0]:
                rec.ksw = (cells, list(jobs), splice, noncan)
            if has_n and (rec.ksw_n is None or cells > rec.ksw_n[0]):
                rec.ksw_n = (cells, list(jobs), splice, noncan)
        return pk

    def batch(jobs, mat, gaps, *, splice, noncan, device, timers=None):
        with rec._lock:
            rec.scoring[splice] = ksw2_ext.forward_scoring(mat, gaps,
                                                           splice=splice)
        return real_batch(jobs, mat, gaps, splice=splice, noncan=noncan,
                          device=device, timers=timers)

    for m in sites:
        m.chain_scores_batch = chain_at(m)
    ksw2_ext.pack_jobs, ksw2_ext._batch_async = pack, batch
    try:
        yield rec
    finally:
        for m in sites:
            m.chain_scores_batch = real_chain[m]
        ksw2_ext.pack_jobs, ksw2_ext._batch_async = real_pack, real_batch

