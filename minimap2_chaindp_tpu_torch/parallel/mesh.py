"""A ("data", "index") mesh of ranks on torch.distributed.

Port of minimap2_chaindp_tpu/parallel/mesh.py (`make_mesh` :19, the
shardings :28-42, `pad_to` :45). JAX runs a mesh from one process (SPMD);
here every rank is a process, and one host process still owns the reads,
the index and the output:
- rank 0 is the caller's own process. It sketches, packs, finishes and
  writes as on one device, and drives every step;
- ranks 1 .. D*I-1 are worker processes that Mesh starts (`spawn`). Each
  serves the steps in lockstep with rank 0 and never loads the genome.
Rank r sits at (data, index) = (r // I, r % I). The index-row group of a
rank holds the I ranks of its data row (the "index" axis: the shards of
one key-range-sharded table); the data-column group holds the D ranks of
its index column (the "data" axis).

A step (`Mesh.step`) is one function of the port, run on every rank:
rank 0 broadcasts a header (the function's import path, its static
arguments, the shapes of its inputs), scatters the inputs' data slices
(rank (d, i) gets rows d*R/D .. (d+1)*R/D), every rank runs the function
on its slice and its shard of the named tables (`Mesh.put`, sent once),
and the outputs of the index-0 ranks are gathered back to rank 0 along
the rows. The function talks to the other ranks only through `RankCtx`'s
`index` and `data` groups.

Backends: `--device cpu` runs every rank on the CPU over gloo; on CUDA,
rank r on cuda:r over nccl, which needs D*I cards. Ranks that share a card
(all on cuda:0, to check the sharded path on one card) talk over gloo,
which NCCL's one-rank-a-device rule leaves; gloo takes the CUDA tensors
in every collective the mesh uses (scatter, all_reduce, all_gather,
gather, and the header's broadcast_object_list) and moves them through
host memory itself. Every rank counts the bytes it sends to other ranks,
by collective (BYTE_KINDS; an all_reduce or all_gather counts the rank's
contribution once to every other member of the group); `Mesh.close` sums
them over the ranks. A 1 x 1 mesh sends none.

Faults are not hidden: a worker that raises prints its traceback and
exits non-zero, which fails rank 0's next collective; a rank that hangs
fails rank 0 at the group's timeout; a worker found dead before a step
raises there. After a fault the mesh is closed by terminating the workers.
"""
from __future__ import annotations

import datetime
import importlib
import os
import pickle
import shutil
import sys
import tempfile
import threading
import traceback

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 600.0        # a collective that waits longer fails
JOIN_S = 30.0            # close(): a worker that outlives this is killed
_PKG = __name__.rsplit(".", 2)[0]


def pad_to(x: np.ndarray, mult: int, fill=0) -> np.ndarray:
    """Pad axis 0 of `x` up to a multiple of `mult` with `fill`."""
    n = x.shape[0]
    m = (n + mult - 1) // mult * mult
    if m == n:
        return x
    pad = [(0, m - n)] + [(0, 0)] * (x.ndim - 1)
    return np.pad(x, pad, constant_values=fill)


def mesh_devices(n: int, device="cuda") -> list[str]:
    """The default device of each of `n` ranks: all "cpu" on the CPU; on
    CUDA rank r on cuda:r. Raises ValueError when the machine has fewer
    than `n` cards (the JAX runtime's message, runtime.py:1018-1023)."""
    kind = torch.device(device).type
    if kind == "cpu":
        return ["cpu"] * n
    if kind != "cuda":
        raise ValueError(f"a mesh runs on cpu or cuda, not {device!r}")
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < n:
        raise ValueError(f"--mesh of {n} ranks needs {n} devices; found "
                         f"{found} on platform 'cuda' (for a mesh on the "
                         "CPU use --device cpu)")
    return [f"cuda:{r}" for r in range(n)]


# what each rank counts: the bytes it sends by collective (the tables'
# scatter at set-up apart)
BYTE_KINDS = ("header", "scatter", "all_reduce", "all_gather", "gather",
              "tables")
STEP_KINDS = ("header", "scatter", "all_reduce", "all_gather", "gather")


def _stats() -> dict:
    return dict.fromkeys(BYTE_KINDS, 0)


class Comm:
    """Collectives of one rank over one group of `size` ranks. Results are
    new tensors on the input's device."""

    def __init__(self, group, size: int, stats: dict):
        self.group, self.size = group, size
        self._stats = stats

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise sum over the group (JAX psum)."""
        w = t.contiguous().clone()
        self._stats["all_reduce"] += \
            w.numel() * w.element_size() * (self.size - 1)
        dist.all_reduce(w, op=dist.ReduceOp.SUM, group=self.group)
        return w

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every member's `t`, in group rank order (JAX
        all_gather along a new leading axis)."""
        w = t.contiguous()
        self._stats["all_gather"] += \
            w.numel() * w.element_size() * (self.size - 1)
        out = [torch.empty_like(w) for _ in range(self.size)]
        dist.all_gather(out, w, group=self.group)
        return torch.stack(out)


class RankCtx:
    """What a step function sees on its rank: the rank's place, its
    torch device, its groups and the tables it holds."""

    def __init__(self, rank, shape, devices, backend, timeout_s, init):
        self.rank, self.shape = rank, tuple(shape)
        n_data, n_index = self.shape
        self.world = n_data * n_index
        self.data_idx, self.index_idx = divmod(rank, n_index)
        self.device = torch.device(devices[rank])
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.backend = backend
        self.stats = _stats()
        self.tables: dict[str, dict] = {}
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=self.world,
            timeout=datetime.timedelta(seconds=timeout_s))
        # every rank creates every group, in the same order
        rows = [[d * n_index + i for i in range(n_index)]
                for d in range(n_data)]
        cols = [[d * n_index + i for d in range(n_data)]
                for i in range(n_index)]
        row_groups = [dist.new_group(r) for r in rows]
        col_groups = [dist.new_group(c) for c in cols]
        self.index = Comm(row_groups[self.data_idx], n_index, self.stats)
        self.data = Comm(col_groups[self.index_idx], n_data, self.stats)
        self._out_group = col_groups[0]

    # --- the step protocol; run by every rank in the same order --------
    def bcast_header(self, header=None):
        obj = [header]
        dist.broadcast_object_list(obj, src=0)
        if self.rank == 0:
            self.stats["header"] += len(pickle.dumps(header)) \
                * (self.world - 1)
        return obj[0]

    def scatter(self, spec, parts=None, kind="scatter") -> torch.Tensor:
        """Rank 0 sends parts[r] to rank r; every rank returns its part on
        its device. spec = (shape, dtype name) of one part."""
        shape, dtype = spec
        out = torch.empty(shape, dtype=getattr(torch, dtype),
                          device=self.device)
        if self.rank == 0:
            self.stats[kind] += sum(p.numel() * p.element_size()
                                    for p in parts[1:])
        dist.scatter(out, parts if self.rank == 0 else None, src=0)
        return out

    def gather_rows(self, t: torch.Tensor):
        """The index-0 ranks' `t` gathered on rank 0 along axis 0 (rank 0
        returns the whole; the others None). Other ranks call nothing."""
        if self.index_idx != 0:
            return None
        w = t.contiguous()
        if self.rank != 0:
            self.stats["gather"] += w.numel() * w.element_size()
            dist.gather(w, None, dst=0, group=self._out_group)
            return None
        parts = [torch.empty_like(w) for _ in range(self.shape[0])]
        dist.gather(w, parts, dst=0, group=self._out_group)
        return torch.cat(parts)

    def serve(self, header, data_parts=None, table_parts=None):
        """Run one header's work on this rank. Rank 0 passes the parts to
        scatter and gets the gathered outputs back."""
        op = header["op"]
        if op == "put":
            self.tables[header["name"]] = {
                k: self.scatter(spec, table_parts and table_parts[k],
                                "tables")
                for k, spec in header["specs"].items()}
            return None
        if op == "stop":
            tot = torch.tensor([self.stats[k] for k in BYTE_KINDS],
                               dtype=torch.int64, device=self.device)
            dist.all_reduce(tot, op=dist.ReduceOp.SUM)
            return dict(zip(BYTE_KINDS, tot.tolist()))
        inputs = {k: self.scatter(spec, data_parts and data_parts[k])
                  for k, spec in header["specs"].items()}
        fn = _resolve(header["fn"])
        tables = self.tables.get(header["table"]) if header["table"] else None
        outs = fn(self, tables, **inputs, **header["static"])
        return [self.gather_rows(o) for o in outs]


def _resolve(path: str):
    """A step function from its "module:name" path, inside this package."""
    mod, name = path.split(":")
    if mod != _PKG and not mod.startswith(_PKG + "."):
        raise ValueError(f"a mesh step must live in {_PKG}: {path}")
    return getattr(importlib.import_module(mod), name)


def _worker(rank, shape, devices, backend, timeout_s, init):
    """A worker rank: serve headers until "stop"; any exception prints its
    traceback and exits the process non-zero."""
    torch.set_num_threads(1)
    try:
        ctx = RankCtx(rank, shape, devices, backend, timeout_s, init)
        while True:
            header = ctx.bcast_header()
            ctx.serve(header)
            if header["op"] == "stop":
                break
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)


class Mesh:
    """A D x I mesh whose rank 0 is this process (see the module
    docstring). `devices` (one per rank) defaults to `mesh_devices`; the
    backend is nccl when every rank has a card of its own, else gloo.
    Steps are serialised: one runs at a time."""

    def __init__(self, n_data: int, n_index: int, device="cuda",
                 devices: list | None = None,
                 timeout_s: float = TIMEOUT_S):
        if n_data < 1 or n_index < 1:
            raise ValueError(f"a mesh needs at least one rank on each axis: "
                             f"{n_data}x{n_index}")
        world = n_data * n_index
        if devices is None:
            devices = mesh_devices(world, device)
        devices = [str(torch.device(d)) for d in devices]
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        if dist.is_initialized():
            raise RuntimeError("this process already has a default process "
                               "group; close the other mesh first")
        cuda = all(d.startswith("cuda") for d in devices)
        self.backend = ("nccl" if cuda and len(set(devices)) == world
                        else "gloo")
        self.shape = (n_data, n_index)
        self.device = torch.device(devices[0])
        self._lock = threading.Lock()
        self._broken = False
        self._closed = False
        self._dir = tempfile.mkdtemp(prefix="mm2tpu_mesh_")
        init = "file://" + os.path.join(self._dir, "rendezvous")
        mp = torch.multiprocessing.get_context("spawn")
        self._procs = [mp.Process(
            target=_worker, daemon=True, name=f"mm2tpu-rank{r}",
            args=(r, self.shape, devices, self.backend, timeout_s, init))
            for r in range(1, world)]
        try:
            for p in self._procs:
                p.start()
            self.ctx = RankCtx(0, self.shape, devices, self.backend,
                               timeout_s, init)
        except BaseException:
            self._kill()
            shutil.rmtree(self._dir, ignore_errors=True)
            raise
        self.totals = None

    @property
    def n_data(self) -> int:
        return self.shape[0]

    @property
    def n_index(self) -> int:
        return self.shape[1]

    def _check_alive(self):
        if self._broken or self._closed:
            raise RuntimeError("the mesh is closed or failed")
        for p in self._procs:
            if p.exitcode is not None:
                self._broken = True
                raise RuntimeError(f"mesh {p.name} exited with code "
                                   f"{p.exitcode}")

    def _run(self, header, data_parts=None, table_parts=None):
        with self._lock:
            self._check_alive()
            try:
                self.ctx.bcast_header(header)
                return self.ctx.serve(header, data_parts, table_parts)
            except BaseException:
                self._broken = True
                raise

    def _wire_parts(self, a, split: bool) -> list:
        """The per-rank parts of one array: its data slices (split) or the
        shards stacked on axis 0 (a table), on rank 0's device."""
        t = torch.as_tensor(np.ascontiguousarray(a)).to(self.device)
        n_data, n_index = self.shape
        parts = t.chunk(n_data if split else n_index)
        return [parts[r // n_index] if split else parts[r % n_index]
                for r in range(n_data * n_index)]

    def put(self, name: str, shards: dict) -> None:
        """Send tables to the ranks, once: `shards[k]` stacks the I index
        shards of table k (equal shapes) on axis 0; rank (d, i) keeps
        shard i as ctx.tables[name][k]."""
        parts = {k: self._wire_parts(v, split=False)
                 for k, v in shards.items()}
        specs = {k: (tuple(p[0].shape), str(p[0].dtype).split(".")[-1])
                 for k, p in parts.items()}
        self._run(dict(op="put", name=name, specs=specs),
                  table_parts=parts)

    def step(self, fn, data: dict, table: str | None = None,
             **static) -> list:
        """Run `fn(ctx, tables, **data_slices, **static)` on every rank.
        `data` arrays (numpy or CPU tensors) have R rows, R a multiple of
        D; the returned tensors are the outputs of fn gathered along axis
        0 from the index-0 ranks (R rows each for row outputs)."""
        n_data = self.shape[0]
        parts = {}
        for k, v in data.items():
            if v.shape[0] % n_data:
                raise ValueError(f"{k}: {v.shape[0]} rows do not split "
                                 f"over {n_data} data ranks")
            parts[k] = self._wire_parts(v, split=True)
        specs = {k: (tuple(p[0].shape), str(p[0].dtype).split(".")[-1])
                 for k, p in parts.items()}
        header = dict(op="step", fn=f"{fn.__module__}:{fn.__qualname__}",
                      table=table, static=static, specs=specs)
        return self._run(header, data_parts=parts)

    def _kill(self):
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(JOIN_S)
            if p.is_alive():
                p.kill()
                p.join()

    def close(self) -> dict | None:
        """Stop the workers and tear the group down. Returns the bytes all
        ranks sent, by collective ({kind: bytes} over BYTE_KINDS), or None after a fault (the workers are then
        terminated)."""
        if self._closed:
            return self.totals
        try:
            if not self._broken:
                try:
                    self.totals = self._run(dict(op="stop"))
                except BaseException:
                    self._broken = True
            if not self._broken:
                for p in self._procs:
                    p.join(JOIN_S)
        finally:
            self._closed = True
            self._kill()
            # a failed nccl group may hang in its teardown; gloo's is local
            if dist.is_initialized() and (self.backend == "gloo"
                                          or not self._broken):
                dist.destroy_process_group()
            shutil.rmtree(self._dir, ignore_errors=True)
        return self.totals
