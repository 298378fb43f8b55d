"""The mesh against one card: the same reads mapped by TorchRuntime under
the `device` routing and over meshes of several shapes.

  python -m minimap2_chaindp_tpu_torch.utils.mesh_sweep [--mbp N]
      [--reads N] [--shapes 1x4,2x2,4x1] [--device cuda|cpu]   (repo root)

A `utils/genome_synth` genome of `--mbp` (2 Mbp contigs, seed 42) and
`--reads` simulated 10 kb reads at 10% error (seed 5), mapped under
map-ont with -a at -t 3: HostRuntime once (the lines every run must
equal), then one runtime per shape (`mesh_shape=(D, I)`, rank r on
cuda:r over nccl; gloo CPU ranks under `--device cpu`) and the device
routing, one after another, each warmed by one untimed pass and then
timed twice. Prints each run's reads/s, each mesh's set-up seconds (spawn,
the index shards' scatter, the first pass), its bytes a read (mesh_bytes,
all_gather, staged) and the index bytes sent at set-up and held by each
rank, and as the last line the whole result as JSON. Host wall clock; the card synchronised at the end of each run.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time


def log(msg: str) -> None:
    print(f"[mesh_sweep] {msg}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mbp", type=int, default=50)
    ap.add_argument("--reads", type=int, default=2000)
    ap.add_argument("--shapes", default="1x4,2x2,4x1")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    from .. import constants as C
    from ..cli import parse_mesh
    from ..index.build import build_index
    from ..io.fastx import read_fastx, read_frags
    from ..models.host_runtime import HostRuntime
    from ..models.runtime import TorchRuntime
    from ..options import set_opt
    from . import genome_synth as G
    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        log("FAILED: no CUDA device")
        return 1
    io, mo = set_opt("map-ont")
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    with tempfile.TemporaryDirectory(prefix="mm2tpu_mesh_sweep_") as d:
        ref, reads = os.path.join(d, "g.fa"), os.path.join(d, "r.fa")
        G.make_genome(ref, n_contigs=max(1, args.mbp // 2),
                      contig_len=2_000_000, seed=42)
        G.simulate(ref, reads, args.reads, 10_000, 0.10, seed=5)
        recs = list(read_fastx(ref))
        batches = list(read_frags([reads], mo.mini_batch_size, False))
    mi = build_index([r.name for r in recs],
                     [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits, n_threads=os.cpu_count() or 1)
    del recs
    mo.update(mi)
    n = sum(len(b) for b in batches)
    host = HostRuntime(mi, mo, n_threads=3)
    want = [ls for b in host.map_stream(batches) for ls in b]
    host.close()
    if cuda:
        log(f"{torch.cuda.device_count()} x {torch.cuda.get_device_name(0)}")
    out = {"reads": n, "mbp": args.mbp, "runs": {}}
    for label in ["device"] + args.shapes.split(","):
        kw = {} if label == "device" else dict(mesh_shape=parse_mesh(label))
        t0 = time.perf_counter()
        rt = TorchRuntime(mi, mo, device=args.device, n_threads=3, **kw)
        rates = []
        try:
            for i in range(3):           # a warm pass, then two timed
                t1 = time.perf_counter()
                got = [ls for b in rt.map_stream(batches) for ls in b]
                if cuda:
                    torch.cuda.synchronize()
                if got != want:
                    raise RuntimeError(f"{label}: lines differ from "
                                       "HostRuntime")
                if i == 0:
                    setup = time.perf_counter() - t0
                else:
                    rates.append(n / (time.perf_counter() - t1))
        finally:
            rt.close()
        c = rt.timers.counters
        rec = dict(rates=rates, setup_s=setup,
                   device_reads=c.get("device_reads", 0))
        if kw:                        # bytes over all three passes
            rec.update({k: c.get(k, 0) / (3 * n) for k in (
                "mesh_bytes", "mesh_allgather_bytes")},
                mesh_table_bytes=c.get("mesh_table_bytes", 0),
                shard_bytes=rt._flow.shard_bytes)
        out["runs"][label] = rec
        log(f"{label}: byte-identical; reads/s {rates[0]:.1f}, "
            f"{rates[1]:.1f}; set-up with the first pass {setup:.1f} s; "
            + ", ".join(f"{k} {v:.1f}" for k, v in rec.items()
                        if k.startswith("mesh_") and k != "mesh_table_bytes")
            + (f" a read; index shards {rec['mesh_table_bytes']} B sent "
               f"at set-up, {rec['shard_bytes']} B held by each rank"
               if kw else ""))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
