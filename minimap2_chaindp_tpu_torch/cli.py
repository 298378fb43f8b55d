"""minimap2-compatible command line of the PyTorch/CUDA port.

  python -m minimap2_chaindp_tpu_torch.cli [options] target.fa query.fa ...

Same options as `python -m minimap2_chaindp_tpu.cli` (the shared parser and
option handling), except `--device`:

  cuda  (default) TorchRuntime on cuda:0; exits non-zero without a GPU
  cpu   the same paths on the CPU, with the kernels' plain versions
  host  HostRuntime, the exact host path

`--mesh` is not supported. There is no silent fallback between devices.
`-t` sets the threads of index building and of `--device host`; the
port's runtime maps on two batch threads whatever `-t` is.
Follows minimap2_chaindp_tpu/cli.py:_main (:334-658) without the JAX
compile cache, the mesh, the link probe and deferred device init.
"""
from __future__ import annotations

import sys
from collections import deque

from minimap2_chaindp_tpu import constants as C
from minimap2_chaindp_tpu.cli import (_run_debug_sequential, apply_args,
                                      build_parser)
from minimap2_chaindp_tpu.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu.io.output import parse_rg_id, write_sam_hdr
from minimap2_chaindp_tpu.options import check_opt, set_opt

DEVICES = ("cuda", "cpu", "host")


def port_parser():
    """The shared parser with `--device cuda|cpu|host` (default cuda)."""
    p = build_parser()
    for act in p._actions:
        if act.dest == "device":
            act.choices = list(DEVICES)
            act.default = "cuda"
            act.help = ("compute path: cuda (the port's kernels), cpu (the "
                        "same paths with plain PyTorch) or host")
        elif act.dest == "threads":
            act.help = ("threads for index building and --device host; "
                        "under --device cuda|cpu mapping runs two batch "
                        "threads whatever -t is")
    return p


def _index_parts(ns, io):
    """Yield index parts: prebuilt single-part, stock multi-part .mmi, or
    FASTA split every ~batch_size bases (index.c:459, :921)."""
    from minimap2_chaindp_tpu.constants import seq_to_nt4
    from minimap2_chaindp_tpu.index.build import build_index
    from minimap2_chaindp_tpu.index.serialize import (is_mm2tpu_index,
                                                      is_mmi_index,
                                                      load_index,
                                                      load_mmi_parts)
    if is_mmi_index(ns.target) or is_mm2tpu_index(ns.target):
        parts = (load_mmi_parts(ns.target) if is_mmi_index(ns.target)
                 else [load_index(ns.target)])
        for j, mi in enumerate(parts):
            if j == 0 and (mi.k != io.k or mi.w != io.w):
                print(f"[WARNING] Indexing parameters (-k {mi.k} -w {mi.w}) "
                      "overriding command line", file=sys.stderr)
            yield mi
        return
    names, seqs, plen = [], [], 0
    for r in read_fastx(ns.target):
        names.append(r.name)
        seqs.append(seq_to_nt4(r.seq))
        plen += len(seqs[-1])
        if plen >= io.batch_size:
            yield build_index(names, seqs, io.w, io.k, io.flag,
                              io.bucket_bits, n_threads=ns.threads)
            names, seqs, plen = [], [], 0
    if names:
        yield build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                          n_threads=ns.threads)


def _announce(batches):
    """Print a QR line per fragment to stderr as its batch is read."""
    for b in batches:
        for frag in b:
            s0 = frag.segs[0]
            print(f"QR\t{s0.name}\t0\t{len(s0.seq)}", file=sys.stderr)
        yield b


def make_runtime(mi, mo, device: str, n_threads: int):
    if device == "host":
        from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
        return HostRuntime(mi, mo, n_threads=n_threads)
    from .models.runtime import TorchRuntime
    return TorchRuntime(mi, mo, device="cuda:0" if device == "cuda"
                        else "cpu", n_threads=n_threads)


def main(argv=None) -> int:
    try:
        return _main(argv)
    except BrokenPipeError:
        import os
        try:
            os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        except OSError:
            pass
        return 1


def _main(argv=None) -> int:
    from minimap2_chaindp_tpu.utils import mlog
    from minimap2_chaindp_tpu.utils.prefetch import prefetch
    mlog.reset_timer()
    if argv is None:
        argv = sys.argv[1:]
    argv_disp = list(argv)
    # a bare --cs must not consume the next token (getopt_long semantics)
    argv = ["--cs=short" if a == "--cs" else a for a in argv]
    ns = port_parser().parse_args(argv)
    if ns.mesh:
        print("[ERROR] --mesh is not supported by the PyTorch port",
              file=sys.stderr)
        return 1
    if ns.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("[ERROR] --device cuda: no CUDA device is available "
                  "(use --device cpu or --device host)", file=sys.stderr)
            return 1
    mlog.set_verbose(3 if ns.verbose is None else ns.verbose)
    io, mo = set_opt(None)
    if ns.preset:
        try:
            set_opt(ns.preset, io, mo)
        except ValueError:
            print(f"[ERROR] unknown preset '{ns.preset}'", file=sys.stderr)
            return 1
    if ns.sr:
        set_opt("sr", io, mo)
    if ns.splice:
        set_opt("splice", io, mo)
    apply_args(ns, io, mo)
    check_opt(io, mo)
    if (mo.flag & C.MM_F_CIGAR) and (io.flag & C.MM_I_NO_SEQ):
        print("[ERROR] the index was built without sequences; "
              "base-level alignment is disabled (main.c:214)",
              file=sys.stderr)
        return 1
    if not ns.query and not ns.dump_index:
        print("[ERROR] missing input: please specify a query file or -d",
              file=sys.stderr)
        return 1

    out = sys.stdout
    rg_id = parse_rg_id(ns.rg)
    parts = prefetch(_index_parts(ns, io), depth=1)
    dump_fp = None
    cur = next(parts, None)
    part_no = 0
    while cur is not None:
        mi = cur
        cur = next(parts, None)
        part_no += 1
        if (mo.flag & C.MM_F_CIGAR) and (mi.flag & C.MM_I_NO_SEQ):
            print("[ERROR] the prebuilt index doesn't contain sequences.",
                  file=sys.stderr)
            return 1
        mlog.mlog("main", f"loaded/built the index for {mi.n_seq} "
                  "target sequence(s)")
        if ns.query:
            mo.update(mi)
            mlog.mlog("mm_mapopt_update", f"mid_occ = {mo.mid_occ}")
        if mlog.verbose >= 3:
            # index stats at -v 3+ (reference mm_idx_stat, index.c:240-265)
            st = mi.stat()
            n = st["distinct_minimizers"]
            sum_occ = n * st["avg_occurrences"]
            mlog.mlog_plain(
                "mm_idx_stat", f"kmer size: {mi.k}; skip: {mi.w}; "
                f"is_hpc: {1 if mi.is_hpc else 0}; #seq: {mi.n_seq}")
            mlog.mlog(
                "mm_idx_stat", f"distinct minimizers: {n} "
                f"({100.0 * st['singleton_frac']:.2f}% are singletons); "
                f"average occurrences: {st['avg_occurrences']:.3f}; "
                f"average spacing: "
                f"{(st['total_bases'] / sum_occ) if sum_occ else 0.0:.3f}")
        if ns.dump_index:
            from minimap2_chaindp_tpu.index.serialize import (dump_index,
                                                              dump_mmi)
            if ns.dump_index.endswith(".mmi"):
                if dump_fp is None:
                    dump_fp = open(ns.dump_index, "wb")
                dump_mmi(mi, dump_fp)
            elif part_no > 1 or cur is not None:
                print("[ERROR] the index dump does not support multi-part "
                      "indexes; raise -I (or dump stock format via a .mmi "
                      "extension)", file=sys.stderr)
                return 1
            else:
                dump_index(mi, ns.dump_index)
            if not ns.query:
                continue

        dbg = 0
        if ns.print_seeds:
            dbg |= C.MM_DBG_PRINT_QNAME | C.MM_DBG_PRINT_SEED
        if ns.print_aln_seq:
            dbg |= C.MM_DBG_PRINT_QNAME | C.MM_DBG_PRINT_ALN_SEQ
        if dbg:
            # debug dumps live in the sequential host models (main.c:358)
            mlog.set_dbg(dbg)
            mo.native_skeleton = False
            _run_debug_sequential(mi, mo, ns, rg_id, out, part_no,
                                  cur is not None, argv_disp)
            continue

        runtime = make_runtime(mi, mo, ns.device, ns.threads)
        if (mo.flag & C.MM_F_OUT_SAM) and part_no == 1:
            is_multi = cur is not None
            if is_multi:
                print("[WARNING] For a multi-part index, no @SQ lines will "
                      "be outputted.", file=sys.stderr)
            print(write_sam_hdr(None if is_multi else mi, ns.rg, "2.10-r761",
                                "mm2tpu " + " ".join(argv_disp)), file=out)
        frag_mode = len(ns.query) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
        batches = prefetch(read_frags(ns.query, mo.mini_batch_size,
                                      frag_mode), depth=2)
        if ns.print_qname:  # MM_DBG_PRINT_QNAME (main.c:47, map.c:606)
            batches = _announce(batches)
        stash: deque = deque()

        def _tee(bs):
            for b in bs:
                stash.append(b)
                yield b

        for batch_lines in runtime.map_stream(_tee(batches), rg_id):
            flat = [line for lines in batch_lines for line in lines]
            if flat:
                flat.append("")          # trailing newline
                out.write("\n".join(flat))
            b = stash.popleft()
            mlog.mlog("worker_pipeline",
                      f"mapped {sum(len(f.segs) for f in b)} sequences")
        runtime.timers.report()
    if dump_fp is not None:
        dump_fp.close()
    mlog.banner("2.10-r761", argv_disp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
