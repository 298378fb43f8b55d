"""Entry points of the port: the flagship op and a dry run of the mesh.

entry(device)              -> (fn, example_args): the chaining-DP kernel
                              over a padded 64 x 512 synthetic batch; fn(*args)
                              returns f. On a card that is the CUDA kernel
                              (csrc/chain_dp.cu); on the CPU, asked for
                              explicitly, its plain version.
dryrun_multichip(n, device) -> runs the sharded map and collect steps on an
                              n-rank ("data" x "index") mesh at tiny shapes,
                              then maps a synthetic genome end to end over
                              the mesh, byte-compared with HostRuntime.

Port of __graft_entry__.py (`_pack_example` :19-31, `entry` :34-51,
`dryrun_multichip` :54-200). The dry run's inputs come from
utils/genome_synth, not from a reference tree.

    python -m minimap2_chaindp_tpu_torch.entry [cuda|cpu]
    python -m minimap2_chaindp_tpu_torch.entry dryrun N [cuda|cpu]
"""
from __future__ import annotations

import os
import sys
import tempfile

import numpy as np
import torch

from .ops.chain_dp import chain_scores_batch
from .ops.chain_host import split_anchors
from .ops.chain_pack import pack_reads
from .utils.synth import synth_batch

# the flagship op's parameters (__graft_entry__.py:44-47)
CHAIN_KW = dict(max_dist_x=5000, max_dist_y=5000, bw=500, max_skip=25,
                is_cdna=False, many_segs=False)
_FIELDS = ("xhi", "rpos", "qpos", "span", "sid", "stw")


def pack_example(n_reads: int, anchors_per_read: int, seed: int = 0):
    """The synthetic chain batch of __graft_entry__._pack_example: returns
    (packed, nn, w1, exc, max_n) as numpy arrays."""
    reads = []
    for a in synth_batch(n_reads, anchors_per_read, seed=seed):
        xhi, rpos, qpos, span, sid = split_anchors(a)
        reads.append(dict(xhi=xhi, rpos=rpos, qpos=qpos, span=span, sid=sid,
                          avg_qspan=np.float32(span.sum())
                          / np.float32(len(a))))
    max_n = (anchors_per_read + 127) // 128 * 128
    packed, nn, w1, exc, _host_flag = pack_reads(reads, max_n, 5000)
    return packed, nn, w1, exc, max_n


def entry(device="cuda"):
    """(fn, example_args): fn runs chain_scores_batch on its arguments'
    device and returns f (64, 512) int32."""
    packed, nn, w1, exc, max_n = pack_example(64, 512)
    dev = torch.device(device)
    example_args = tuple(torch.from_numpy(a).to(dev) for a in (
        *(packed[k] for k in _FIELDS), nn, w1, exc))

    def fwd(xhi, rpos, qpos, span, sid, stw, nn, w1, exc):
        f, _p, _flag = chain_scores_batch(
            xhi, rpos, qpos, span, sid, stw, nn, w1, exc, max_n=max_n,
            **CHAIN_KW)
        return f

    return fwd, example_args


def _rank_devices(n: int, device) -> list[str]:
    """n ranks on the CPU, or on the cards: rank r on cuda:(r mod cards),
    so ranks share a card where there are fewer cards than ranks (the
    mesh then talks over gloo)."""
    if torch.device(device).type == "cpu":
        return ["cpu"] * n
    n_cards = torch.cuda.device_count()
    if n_cards == 0:
        raise RuntimeError("dryrun_multichip on cuda: no CUDA device")
    return [f"cuda:{r % n_cards}" for r in range(n)]


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """One step each of the sharded map and collect steps on an n-rank
    mesh (index axis 2 when n is even, as in JAX), then an end-to-end map
    of a synthetic genome over the same mesh shape, byte-compared with
    HostRuntime. Returns (and prints) a summary line; raises on any
    mismatch."""
    from .constants import MM_F_CIGAR, MM_F_OUT_SAM, seq_to_nt4
    from .index.build import build_index
    from .io.fastx import read_fastx, read_frags
    from .models.device_pipeline import (sharded_collect_step,
                                         sharded_map_step)
    from .models.host_runtime import HostRuntime
    from .models.runtime import TorchRuntime
    from .ops.seeds_device import shard_index_tables, split_u64
    from .options import set_opt
    from .parallel.mesh import Mesh, pad_to
    from .utils import genome_synth as G

    index_shards = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    data_size = n_devices // index_shards
    devices = _rank_devices(n_devices, device)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="mm2tpu_dryrun_") as d:
        ref, reads = os.path.join(d, "g.fa"), os.path.join(d, "r.fa")
        G.make_genome(ref, n_contigs=2, contig_len=100_000, seed=7)
        G.simulate(ref, reads, 8 * data_size, 400, 0.03, seed=9)
        io, mo = set_opt("map-ont")
        recs = list(read_fastx(ref))
        mi = build_index([r.name for r in recs],
                         [seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                         io.flag, io.bucket_bits)
        mo.update(mi)
        mesh = Mesh(data_size, index_shards, devices=devices)
        try:
            # the sharded map step at tiny shapes
            packed, nn, w1, exc, max_n = pack_example(8 * data_size, 128)
            n_reads = -(-packed["xhi"].shape[0] // data_size) * data_size
            batch = {k: pad_to(packed[k], data_size) for k in _FIELDS}
            batch.update(nn=pad_to(nn, data_size), w1=pad_to(w1, data_size),
                         exc=pad_to(exc, data_size, fill=-1))
            M = 128
            batch["qkeys"] = rng.integers(0, 1 << 30, (n_reads, M)) \
                .astype(np.int32)
            keys = np.sort(rng.integers(0, 1 << 30, 1024 * index_shards)
                           .astype(np.int32))
            mesh.put("dryrun_keys", dict(keys=keys))
            f, _p, _flag, occ, flagged = mesh.step(
                sharded_map_step, batch, table="dryrun_keys", max_n=max_n,
                max_dist=5000, bw=500, max_skip=25)
            if tuple(f.shape) != (n_reads, max_n) \
                    or tuple(occ.shape) != (n_reads, M):
                raise RuntimeError("the sharded map step's shapes are off")

            # sharded seed collection over the key-range-sharded index
            khi, klo, starts, vhi, vlo, _kp, _vp, _cuts = \
                shard_index_tables(mi, index_shards)
            mesh.put("dryrun_csr", dict(khi=khi, klo=klo, starts=starts,
                                        vhi=vhi, vlo=vlo))
            R2, M2, cap = 8 * data_size, 128, 256
            nq = min(len(mi.keys), M2)
            hi, lo = split_u64(mi.keys[:nq])
            q = dict(qhi=np.full((R2, M2), 0x7FFFFFFF, np.int32),
                     qlo=np.zeros((R2, M2), np.int32),
                     qvalid=np.zeros((R2, M2), np.int32))
            q["qhi"][:, :nq], q["qlo"][:, :nq] = hi, lo
            q["qvalid"][:, :nq] = 1
            z = np.zeros((R2, M2), np.int32)
            q.update(qpos=z, qspan=z, qseg=z, qtnd=z,
                     qls=np.zeros((R2, 1), np.int32))
            outs = mesh.step(sharded_collect_step, q, table="dryrun_csr",
                             max_occ=1 << 30, cap=cap)
            n_anch = int(outs[4][0])
            if n_anch < nq:
                raise RuntimeError("sharded collect lost occurrences")
        finally:
            mesh.close()

        # end to end over the mesh, against the host path
        mo.flag |= MM_F_OUT_SAM | MM_F_CIGAR          # -a
        batches = list(read_frags([reads], mo.mini_batch_size, False))
        host = HostRuntime(mi, mo)
        want = [ls for b in batches for ls in host.map_batch(b)]
        rt = TorchRuntime(mi, mo, device=devices[0],
                          mesh_shape=(data_size, index_shards),
                          mesh_devices=devices)
        try:
            got = [ls for b in rt.map_stream(batches) for ls in b]
        finally:
            rt.close()
        if got != want:
            raise RuntimeError("mesh SAM != HostRuntime SAM")
        c = rt.timers.counters
    line = (f"dryrun_multichip OK: mesh={data_size}x{index_shards} "
            f"({mesh.backend}, {devices[0]}), f={tuple(f.shape)}, "
            f"flagged={int(flagged[0])}, sharded_collect_anchors={n_anch}, "
            f"e2e byte-identical ({len(got)} reads, "
            f"{c.get('device_reads', 0)} chained on the mesh, "
            f"mesh_bytes={c.get('mesh_bytes', 0)})")
    print(line)
    return line


def main(argv) -> int:
    if argv and argv[0] == "dryrun":
        n = int(argv[1]) if len(argv) > 1 else 2
        dryrun_multichip(n, argv[2] if len(argv) > 2 else "cuda")
        return 0
    fn, args = entry(argv[0] if argv else "cuda")
    out = fn(*args)
    print("entry OK:", tuple(out.shape), out.dtype, out.device)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
