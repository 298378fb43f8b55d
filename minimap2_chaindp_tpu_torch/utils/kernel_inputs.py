"""The largest input each kernel wrapper took in a run, kept so that the
kernels can be held against their plain versions on it afterwards, in
another process (chip_smoke.py does so for the bench's end-to-end rows and
its flow row, each of which runs in a process of its own).

    with kernel_inputs.record() as rec:
        ...                         # mapping runs on the card
    rec.save(directory)             # chain_<mode>.pt, ksw.pt
    kernel_inputs.load(directory, "cuda")

`record()` wraps the chain wrapper where the runtime's paths call it
(models/device_flow, models/runtime, models/device_pipeline) and keeps, by
mode (single, many_segs, cdna), the input with the most anchor slots; it
wraps ops/ksw2_ext.pack_jobs and _batch_async and keeps the extension
launch with the most DP cells: its jobs, mode and the forward wrapper's
scoring. The wrappers themselves and their launch counts are untouched.
"""
from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch


def chain_mode(kw) -> str:
    return "cdna" if kw["is_cdna"] else (
        "many_segs" if kw["many_segs"] else "single")


class Recorder:
    def __init__(self):
        self.chain: dict[str, tuple] = {}   # mode -> (slots, args, kw)
        self.ksw = None                     # (cells, jobs, splice, noncan)
        self.scoring: dict[bool, tuple] = {}   # splice -> forward scoring
        self._lock = threading.Lock()

    def save(self, directory: str) -> list[str]:
        """Write what was kept as CPU tensors under `directory`; returns
        the names written."""
        os.makedirs(directory, exist_ok=True)
        names = []
        for mode, (_slots, args, kw) in sorted(self.chain.items()):
            torch.save(dict(args=[a.cpu() for a in args], kw=kw),
                       os.path.join(directory, f"chain_{mode}.pt"))
            names.append(f"chain_{mode}")
        if self.ksw is not None:
            _cells, jobs, splice, noncan = self.ksw
            torch.save(dict(jobs=jobs, splice=splice, noncan=noncan,
                            scoring=self.scoring[splice]),
                       os.path.join(directory, "ksw.pt"))
            names.append("ksw")
        return names


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
        with rec._lock:
            if rec.ksw is None or cells > rec.ksw[0]:
                rec.ksw = (cells, list(jobs), splice, noncan)
        return pk

    def batch(jobs, mat, gaps, *, splice, noncan, device):
        with rec._lock:
            rec.scoring[splice] = ksw2_ext.forward_scoring(mat, gaps,
                                                           splice=splice)
        return real_batch(jobs, mat, gaps, splice=splice, noncan=noncan,
                          device=device)

    for m in sites:
        m.chain_scores_batch = chain_at(m)
    ksw2_ext.pack_jobs, ksw2_ext._batch_async = pack, batch
    try:
        yield rec
    finally:
        for m in sites:
            m.chain_scores_batch = real_chain[m]
        ksw2_ext.pack_jobs, ksw2_ext._batch_async = real_pack, real_batch


def load(directory: str, device) -> dict:
    """What save() wrote: {"chain_<mode>": (args on `device`, kw), "ksw":
    dict(jobs, splice, noncan, scoring)}."""
    out = {}
    for name in sorted(os.listdir(directory)):
        if not name.endswith(".pt"):
            continue
        d = torch.load(os.path.join(directory, name), weights_only=False)
        if name.startswith("chain_"):
            d = ([a.to(device) for a in d["args"]], d["kw"])
        out[name[:-3]] = d
    return out
