"""minimap2-compatible command line of the PyTorch/CUDA port.

  python -m minimap2_chaindp_tpu_torch.cli [options] target.fa query.fa ...

Same options as `python -m minimap2_chaindp_tpu.cli` (`build_parser`,
`apply_args`, `_si` and `_run_debug_sequential` are copied from
minimap2_chaindp_tpu/cli.py:27-314), except `--device`:

  cuda  (default) TorchRuntime on cuda:0; exits non-zero without a GPU
  cpu   the same paths on the CPU, with the kernels' plain versions
  host  HostRuntime, the exact host path

`--mesh DATAxINDEX` (e.g. 2x2) runs the fused flow on a mesh of
DATA x INDEX ranks (parallel/mesh.py): the reads data-parallel over DATA,
the index key-range-sharded over INDEX, the output unchanged. Under
`--device cpu` the ranks are CPU processes on gloo; under `--device cuda`
rank r runs on cuda:r over nccl, and a machine with fewer cards exits
non-zero ("needs N devices"). The mesh pins the device routing; `--device
host` ignores it. MM2TPU_DEVICE_INDEX=1 sorts the index's minimizer pairs
on the run's device (index/build_device.py; the CPU under `--device
host`). There is no silent fallback between devices.
`-t` sets the threads of index building and the host lane: HostRuntime's
under `--device host`, TorchRuntime's (`-t` - 1 workers for the native
driver's calls) under `--device cuda|cpu`.

Under `--device cuda|cpu` the JAX package's environment picks the
runtime's routing (`runtime_kwargs`), so the same environment steers both
packages the same way:

  MM2TPU_DEVICE_FLOW=0         host   (every batch to a HostRuntime)
  MM2TPU_FLOW_SHARE=x          share  (a fraction x of the flow's reads)
  MM2TPU_STEAL=1               steal  (the work-stealing lanes)
  none of these                device (every read through the card)

MM2TPU_NATIVE_CHAIN_MAX, MM2TPU_NATIVE_EXT_MAX and MM2TPU_DEVICE_SEEDS=1
set the chain and extension crossovers (default 0: everything to the
card) and device seed collection. The routing is printed on the
`[timers]` line, then each span's wall time and count (`name=ms/n`) and
each counter (`name=n`). The spans (utils/trace.py) nest: `map_batch`
holds a batch's `seed` (`sketch`, `seed_hits`), `flow` (the fused flow:
`flow_prep`, its host seed stats and bucket fill, then its own `kernel`,
`bottom` and `seed` > `flow_seed_hits`), `kernel` (`chain_upload`,
`chain_launch`, `device_wait`), `pack`, `bottom`, `host_chain`, `align`
(`native_finish`, the flow's reads' native finish; `staged_align`, whose
rounds are `skeleton` spans, the staged units' native passes or the align
generators' advances, beside the executor's `ext_wave` with
`ext_pack`, `ext_upload`, `ext_launch`, `device_wait`, `ext_decode`, and
`ext_native`, `ext_host`) and `epilogue`; `feed_wait` is the wait for
the next input batch; the stealing lane's chunks are `steal_prep`,
`steal_flow` (around the lane's `flow`), `steal_finish`. `native_finish`,
`ext_native` and `ext_host` name both a span and a counter of reads or
jobs; `ext_device` counts the jobs the ksw2 kernels took, and
`ext_long_device` those of them with a side past 16384 bases. The flow's
routing counters, summed per batch: `flow_units`
(single-segment units with minimizers offered to it) = `flow_empty` (no
anchor) + `flow_out_minimizers`, `flow_out_anchors`, `flow_out_shard`,
`flow_out_qspan`, `flow_out_exc`, `flow_out_flag` (each reason a unit
leaves it for the staged path) + `device_reads`; `native_finish_bases`
and `native_finish_declined` are the query bases the native finish
finished and the reads it declined. The staged path's native finish
(models/replay.py) counts `replay_units` (staged units it finished),
`replay_declined` (staged units left to the align generators),
`replay_rounds` (its passes, one a round) and `replay_jobs` (the extension
jobs its passes recorded).
Follows minimap2_chaindp_tpu/cli.py:_main (:334-658) without the JAX
compile cache, the link probe and deferred device init.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import deque

from . import constants as C
from .io.fastx import read_fastx, read_frags
from .io.output import parse_rg_id, write_sam_hdr
from .options import IndexOptions, MapOptions, check_opt, set_opt

DEVICES = ("cuda", "cpu", "host")
VERSION = "0.1.0 (minimap2 2.10-r761 compatible)"
# the finished run's runtime counters, for tools that run the CLI in
# process (tools/e2e_bench.py); the counterpart of the JAX cli.py:19, 652-653
LAST_RUN_COUNTERS: dict = {}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mm2tpu", add_help=True,
        description="minimap2-compatible long/short-read aligner on "
                    "PyTorch and CUDA")
    a = p.add_argument
    # indexing
    a("-H", dest="hpc", action="store_true", help="use homopolymer-compressed k-mer")
    a("-k", type=int, default=None, help="k-mer size")
    a("-w", type=int, default=None, help="minimizer window size")
    a("-I", dest="batch_size", default=None, help="split index for every ~NUM bases")
    a("-d", dest="dump_index", default=None, help="dump index to file")
    # mapping
    a("-f", dest="mid_occ_frac", type=float, default=None)
    a("-g", dest="max_gap", default=None)   # _si: k/m/g ok
    a("-G", dest="max_intron_len", default=None)
    a("-F", dest="max_frag_len", default=None)
    a("-r", dest="bw", default=None)
    a("-n", "--min-count", dest="min_cnt", type=int, default=None)
    a("-m", "--min-chain-score", dest="min_chain_score", type=int,
      default=None)
    a("-X", dest="ava", action="store_true", help="skip self and dual mappings")
    a("-D", "--no-self", dest="no_diag", action="store_true",
      help="skip self mappings")
    a("-P", "--all-chain", dest="all_chains", action="store_true",
      help="retain all chains")
    a("-M", dest="mask_level", type=float, default=None)
    a("-C", "--cost-non-gt-ag", dest="noncan", type=int, default=None,
      help="cost of non-canonical splicing sites")
    a("-Y", dest="softclip2", action="store_true",
      help="use soft clipping for supplementary alignments")
    a("-y", dest="copy_comment", action="store_true")
    a("-v", dest="verbose", type=int, default=None)
    a("-2", dest="io_threads2", action="store_true",
      help="use two IO threads (always on: pipeline prefetching)")
    a("-V", action="version", version=VERSION)
    a("--bucket-bits", type=int, default=None)
    a("--seed", type=int, default=None)
    a("--mask-level", dest="mask_level2", type=float, default=None)
    a("--max-chain-skip", type=int, default=None)
    a("--min-dp-len", type=int, default=None)
    a("--end-bonus", type=int, default=None)
    a("--no-pairing", action="store_true")
    a("--splice-flank", default=None, choices=["yes", "no"])
    a("--idx-no-seq", action="store_true")
    a("--end-seed-pen", type=int, default=None)
    a("--dual", default=None, choices=["yes", "no"])
    a("--max-clip-ratio", type=float, default=None)
    a("--min-occ-floor", type=int, default=None)
    a("--no-kalloc", action="store_true", help="(accepted for compatibility)")
    a("--heap-sort", default=None, help="(accepted for compatibility)")
    a("--print-qname", action="store_true")
    a("--print-seeds", action="store_true",
      help="debug: dump per-chain anchors (CN lines) to stderr")
    a("--print-aln-seq", action="store_true",
      help="debug: dump each DP problem's sequences to stderr")
    a("-T", dest="sdust_thres", type=int, default=None,
      help="SDUST threshold; 0 to disable low-complexity minimizer masking")
    a("-p", dest="pri_ratio", type=float, default=None)
    a("-N", dest="best_n", type=int, default=None)
    # alignment
    a("-A", dest="match", type=int, default=None)
    a("-B", dest="mismatch", type=int, default=None)
    a("-O", dest="gap_open", default=None)
    a("-E", dest="gap_ext", default=None)
    a("-z", dest="zdrop", default=None)
    a("-s", "--min-dp-score", dest="min_dp_max", type=int, default=None)
    a("-u", dest="splice_strand", default=None)
    # io
    a("-a", "--sam", dest="sam", action="store_true", help="output SAM")
    a("-c", dest="cigar", action="store_true", help="output CIGAR in PAF")
    a("-Q", dest="no_qual", action="store_true")
    a("-L", dest="long_cigar", action="store_true")
    a("-R", dest="rg", default=None, help="SAM read group line")
    a("-t", dest="threads", type=int, default=3,
      help="threads for index building and the host lane (under --device "
           "cuda|cpu: -t - 1 workers for the native driver's calls)")
    a("-K", "--mb-size", dest="mini_batch", default=None)
    a("-x", dest="preset", default=None)
    a("--cs", dest="cs", nargs="?", const="short", default=None)
    a("--MD", dest="md", action="store_true")
    a("--for-only", action="store_true")
    a("--rev-only", action="store_true")
    a("--secondary", default=None, choices=["yes", "no", "y", "n"])
    a("--frag", default=None, choices=["yes", "no", "y", "n"])
    a("--sr", action="store_true")
    a("--splice", action="store_true")
    a("--no-long-join", action="store_true")
    a("--max-intron-len", dest="max_intron_len2", default=None)
    a("--soft-clipped", dest="softclip", action="store_true")
    a("--device", default="cuda", choices=list(DEVICES),
      help="compute path: cuda (the port's kernels), cpu (the same paths "
           "with plain PyTorch) or host")
    a("--mesh", default=None, metavar="DATAxINDEX",
      help="a mesh of ranks, e.g. 2x2: reads data-parallel over DATA "
           "ranks, the index key-range-sharded over INDEX ranks; output "
           "stays byte-identical")
    a("--version", action="version", version=VERSION)
    a("target")
    a("query", nargs="*")
    return p


def _run_debug_sequential(mi, mo, ns, rg_id, out, part_no, is_multi,
                          argv_disp) -> None:
    """--print-seeds / --print-aln-seq: single-threaded per-fragment mapping
    so the stderr dumps interleave deterministically (reference forces
    n_threads=1, main.c:358/361). QR/QM lines per map.c:606/449."""
    from .models.pipeline import map_fragment_output
    from .utils import mlog
    if (mo.flag & C.MM_F_OUT_SAM) and part_no == 1:
        if is_multi:
            print("[WARNING] For a multi-part index, no @SQ lines will "
                  "be outputted.", file=sys.stderr)
        print(write_sam_hdr(None if is_multi else mi, ns.rg, "2.10-r761",
                            "mm2tpu " + " ".join(argv_disp)), file=out)
    frag_mode = len(ns.query) > 1 or bool(mo.flag & C.MM_F_FRAG_MODE)
    for batch in read_frags(ns.query, mo.mini_batch_size, frag_mode):
        for frag in batch:
            s0 = frag.segs[0]
            print(f"QR\t{s0.name}\t0\t{len(s0.seq)}", file=sys.stderr)
            # QM follows the front half, before any result dump (map.c:449)
            qlen_sum = sum(len(s.seq) for s in frag.segs)
            print(f"QM\t{s0.name}\t{qlen_sum}\tcap=0,nCore=0,largest=0",
                  file=sys.stderr)
            lines = map_fragment_output(mi, mo, frag.segs, rg_id)
            for line in lines:
                print(line, file=out)
        mlog.mlog("worker_pipeline",
                  f"mapped {sum(len(f.segs) for f in batch)} sequences")


def _si(v) -> int:
    """Reference mm_parse_num (main.c:84-93): strtod's leading number, one
    optional k/m/g suffix, trailing junk ignored, rounded via +.499."""
    if v is None:
        return 0
    import re as _re
    s = str(v)
    m = _re.match(r"\s*[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?", s)
    if not m:
        return 0
    x = float(m.group(0))
    rest = s[m.end():]
    if rest[:1] in ("g", "G"):
        x *= 1e9
    elif rest[:1] in ("m", "M"):
        x *= 1e6
    elif rest[:1] in ("k", "K"):
        x *= 1e3
    return int(x + .499)


def apply_args(ns, io: IndexOptions, mo: MapOptions) -> None:
    if ns.hpc:
        io.flag |= C.MM_I_HPC
    if ns.k is not None:
        io.k = ns.k
    if ns.w is not None:
        io.w = ns.w
    if ns.batch_size is not None:
        io.batch_size = _si(ns.batch_size)
    if ns.mid_occ_frac is not None:
        mo.mid_occ_frac = ns.mid_occ_frac
    if ns.max_gap is not None:
        mo.max_gap = _si(ns.max_gap)
    if ns.max_frag_len is not None:
        mo.max_frag_len = _si(ns.max_frag_len)
    if ns.bw is not None:
        mo.bw = _si(ns.bw)
    if ns.min_cnt is not None:
        mo.min_cnt = ns.min_cnt
    if ns.min_chain_score is not None:
        mo.min_chain_score = ns.min_chain_score
    if ns.ava:  # -X = -D -P --no-long-join --dual=no (main.c:336)
        mo.flag |= (C.MM_F_ALL_CHAINS | C.MM_F_NO_DIAG | C.MM_F_NO_DUAL
                    | C.MM_F_NO_LJOIN)
    if ns.no_diag:
        mo.flag |= C.MM_F_NO_DIAG
    if ns.all_chains:
        mo.flag |= C.MM_F_ALL_CHAINS
    for v in (ns.mask_level, ns.mask_level2):
        if v is not None:
            mo.mask_level = v
    if ns.noncan is not None:
        mo.noncan = ns.noncan
    if ns.softclip2:
        mo.flag |= C.MM_F_SOFTCLIP
    if ns.copy_comment:
        mo.flag |= C.MM_F_COPY_COMMENT
    if ns.bucket_bits is not None:
        io.bucket_bits = ns.bucket_bits
    if ns.seed is not None:
        mo.seed = ns.seed
    if ns.max_chain_skip is not None:
        mo.max_chain_skip = ns.max_chain_skip
    if ns.min_dp_len is not None:
        mo.min_ksw_len = ns.min_dp_len
    if ns.end_bonus is not None:
        mo.end_bonus = ns.end_bonus
    if ns.no_pairing:
        mo.flag |= C.MM_F_INDEPEND_SEG
    if ns.splice_flank == "yes":
        mo.flag |= C.MM_F_SPLICE_FLANK
    elif ns.splice_flank == "no":
        mo.flag &= ~C.MM_F_SPLICE_FLANK
    if ns.idx_no_seq:
        io.flag |= C.MM_I_NO_SEQ
    if ns.end_seed_pen is not None:
        mo.anchor_ext_shift = ns.end_seed_pen
    if ns.dual == "no":
        mo.flag |= C.MM_F_NO_DUAL
    elif ns.dual == "yes":
        mo.flag &= ~C.MM_F_NO_DUAL
    if ns.max_clip_ratio is not None:
        mo.max_clip_ratio = ns.max_clip_ratio
    if ns.min_occ_floor is not None:
        mo.min_mid_occ = ns.min_occ_floor
    if ns.splice_strand is not None:
        u = ns.splice_strand
        if u == "b":
            mo.flag |= C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV
        elif u == "f":
            mo.flag = (mo.flag | C.MM_F_SPLICE_FOR) & ~C.MM_F_SPLICE_REV
        elif u == "r":
            mo.flag = (mo.flag | C.MM_F_SPLICE_REV) & ~C.MM_F_SPLICE_FOR
        elif u == "n":
            mo.flag &= ~(C.MM_F_SPLICE_FOR | C.MM_F_SPLICE_REV)
        else:
            raise SystemExit("[ERROR] unrecognized cDNA direction")
    if ns.sdust_thres is not None:
        mo.sdust_thres = ns.sdust_thres
    if ns.pri_ratio is not None:
        mo.pri_ratio = ns.pri_ratio
    if ns.best_n is not None:
        mo.best_n = ns.best_n
    if ns.match is not None:
        mo.a = ns.match
    if ns.mismatch is not None:
        mo.b = ns.mismatch
    if ns.gap_open is not None:
        parts = str(ns.gap_open).split(",")
        mo.q = int(parts[0])
        if len(parts) > 1:
            mo.q2 = int(parts[1])
    if ns.gap_ext is not None:
        parts = str(ns.gap_ext).split(",")
        mo.e = int(parts[0])
        if len(parts) > 1:
            mo.e2 = int(parts[1])
    if ns.zdrop is not None:
        parts = str(ns.zdrop).split(",")
        mo.zdrop = int(parts[0])
        if len(parts) > 1:
            mo.zdrop_inv = int(parts[1])
    if ns.min_dp_max is not None:
        mo.min_dp_max = ns.min_dp_max
    if ns.sam:
        mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    if ns.cigar:
        mo.flag |= C.MM_F_OUT_CG | C.MM_F_CIGAR
    if ns.no_qual:
        mo.flag |= C.MM_F_NO_QUAL
    if ns.long_cigar:
        mo.flag |= C.MM_F_LONG_CIGAR
    if ns.cs is not None:
        mo.flag |= C.MM_F_OUT_CS | C.MM_F_CIGAR
        if ns.cs == "long":
            mo.flag |= C.MM_F_OUT_CS_LONG
    if ns.md:
        mo.flag |= C.MM_F_OUT_MD | C.MM_F_CIGAR
    if ns.for_only:
        mo.flag |= C.MM_F_FOR_ONLY
    if ns.rev_only:
        mo.flag |= C.MM_F_REV_ONLY
    if ns.secondary in ("no", "n"):       # yes_or_no both ways
        mo.flag |= C.MM_F_NO_PRINT_2ND     # (main.c:95-106)
    elif ns.secondary in ("yes", "y"):
        mo.flag &= ~C.MM_F_NO_PRINT_2ND
    if ns.frag in ("yes", "y"):
        mo.flag |= C.MM_F_FRAG_MODE
    elif ns.frag in ("no", "n"):
        mo.flag &= ~C.MM_F_FRAG_MODE
    if ns.no_long_join:
        mo.flag |= C.MM_F_NO_LJOIN
    if ns.softclip:
        mo.flag |= C.MM_F_SOFTCLIP
    if ns.mini_batch is not None:
        mo.mini_batch_size = _si(ns.mini_batch)
    for v in (ns.max_intron_len, ns.max_intron_len2):
        if v is not None:
            mo.max_intron_len(_si(v))


def _index_parts(ns, io):
    """Yield index parts: prebuilt single-part, stock multi-part .mmi, or
    FASTA split every ~batch_size bases (index.c:459, :921). Under
    MM2TPU_DEVICE_INDEX=1 the pair sort runs on the run's device."""
    from .constants import seq_to_nt4
    from .index.build import build_index
    from .index.serialize import (is_mm2tpu_index, is_mmi_index, load_index,
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
    device = False
    if os.environ.get("MM2TPU_DEVICE_INDEX", "0") == "1":
        device = "cuda" if ns.device == "cuda" else "cpu"
    names, seqs, plen = [], [], 0
    for r in read_fastx(ns.target):
        names.append(r.name)
        seqs.append(seq_to_nt4(r.seq))
        plen += len(seqs[-1])
        if plen >= io.batch_size:
            yield build_index(names, seqs, io.w, io.k, io.flag,
                              io.bucket_bits, n_threads=ns.threads,
                              device=device)
            names, seqs, plen = [], [], 0
    if names:
        yield build_index(names, seqs, io.w, io.k, io.flag, io.bucket_bits,
                          n_threads=ns.threads, device=device)


def _announce(batches):
    """Print a QR line per fragment to stderr as its batch is read."""
    for b in batches:
        for frag in b:
            s0 = frag.segs[0]
            print(f"QR\t{s0.name}\t0\t{len(s0.seq)}", file=sys.stderr)
        yield b


def runtime_kwargs(env=None) -> dict:
    """TorchRuntime's routing arguments from the JAX package's environment
    names (see the module docstring)."""
    env = os.environ if env is None else env
    kw = dict(native_chain_max=int(env.get("MM2TPU_NATIVE_CHAIN_MAX", "0")),
              native_ext_max=int(env.get("MM2TPU_NATIVE_EXT_MAX", "0")),
              device_seeds=env.get("MM2TPU_DEVICE_SEEDS", "0") == "1")
    if env.get("MM2TPU_DEVICE_FLOW", "") == "0":
        kw["routing"] = "host"
    elif env.get("MM2TPU_FLOW_SHARE", "") != "":
        share = float(env["MM2TPU_FLOW_SHARE"])
        if not 0.0 < share < 1.0:
            raise ValueError(f"MM2TPU_FLOW_SHARE={share} is not in (0, 1)")
        kw.update(routing="share", flow_share=share)
    elif env.get("MM2TPU_STEAL", "") == "1":
        kw["routing"] = "steal"
    else:
        kw["routing"] = "device"
    return kw


def make_runtime(mi, mo, device: str, n_threads: int, routing_kw: dict,
                 mesh_shape=None):
    if device == "host":
        from .models.host_runtime import HostRuntime
        return HostRuntime(mi, mo, n_threads=n_threads)
    from .models.runtime import TorchRuntime
    return TorchRuntime(mi, mo, device="cuda:0" if device == "cuda"
                        else "cpu", n_threads=n_threads,
                        mesh_shape=mesh_shape, **routing_kw)


def parse_mesh(text: str) -> tuple[int, int]:
    """DATAxINDEX -> (DATA, INDEX); ValueError on anything else."""
    import re
    m = re.fullmatch(r"(\d+)x(\d+)", text.lower())
    if not m:
        raise ValueError(f"--mesh expects DATAxINDEX (e.g. 4x2), got "
                         f"'{text}'")
    return int(m.group(1)), int(m.group(2))


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
    from .utils import mlog
    from .utils.prefetch import prefetch
    mlog.reset_timer()
    if argv is None:
        argv = sys.argv[1:]
    argv_disp = list(argv)
    # a bare --cs must not consume the next token (getopt_long semantics)
    argv = ["--cs=short" if a == "--cs" else a for a in argv]
    ns = build_parser().parse_args(argv)
    mesh_shape = None
    if ns.mesh and ns.device != "host":
        from .parallel.mesh import mesh_devices
        try:
            mesh_shape = parse_mesh(ns.mesh)
            # the card count first: "needs N devices" on any machine
            mesh_devices(mesh_shape[0] * mesh_shape[1], ns.device)
        except ValueError as e:
            print(f"[ERROR] {e}", file=sys.stderr)
            return 1
    routing_kw = {}
    if ns.device != "host":
        try:
            routing_kw = runtime_kwargs()
        except ValueError as e:
            print(f"[ERROR] the routing environment: {e}", file=sys.stderr)
            return 1
        if mesh_shape is not None:
            # the mesh pins the device routing (the JAX runtime's --mesh)
            routing_kw.pop("flow_share", None)
            routing_kw["routing"] = "device"
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
            from .index.serialize import dump_index, dump_mmi
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

        try:
            runtime = make_runtime(mi, mo, ns.device, ns.threads, routing_kw,
                                   mesh_shape)
        except ValueError as e:
            print(f"[ERROR] {e}", file=sys.stderr)
            return 1
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
        runtime.close()
        if hasattr(runtime, "describe"):
            print(f"[timers] {runtime.describe()} "
                  f"{runtime.timers.summary()}", file=sys.stderr)
        else:
            runtime.timers.report()
        global LAST_RUN_COUNTERS
        LAST_RUN_COUNTERS = dict(runtime.timers.counters)
    if dump_fp is not None:
        dump_fp.close()
    mlog.banner("2.10-r761", argv_disp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
