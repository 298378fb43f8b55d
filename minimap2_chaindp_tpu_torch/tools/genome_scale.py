"""Genome-scale run of the port: build a repeat-seeded synthetic reference,
index it, map ONT- and PacBio-like reads, and report the index build's
time, peak memory and occurrence distribution, the load split and reads/s,
with the fast path on == off on the host and the card's lane == the host.

Port of tools/genome_scale.py. Every mapping goes through the port's CLI
(`cli.main()` in this process, SAM to a temp file):
  * the genome (utils/genome_synth.make_genome: 2 Mbp contigs, seed 42);
  * the in-process index build (native, map-ont's k/w): seconds, peak RSS,
    keys and occurrence distribution; then the build once more with the
    minimizer pairs sorted on the lane's device (MM2TPU_DEVICE_INDEX=1,
    index/build_device.py), its seconds and its tables held against the
    native build's;
  * the reads; the `-d` dump (`-H -d` for map-pb) and the mmap / eager
    load split;
  * map-ont and map-pb on the host with the fast path on (-t 4) and off
    (MM2TPU_NATIVE_SKELETON=0), which must be IDENTICAL, the Q60 accuracy
    line, and the `--device` lane's row beside it (-t 4): its reads/s, its
    SAM IDENTICAL to the host's, and on the card the peak device memory
    (torch.cuda.max_memory_allocated after reset_peak_memory_stats);
  * `paftools mapeval` through the port's tools/paftools.py (1% gate);
  * `--pe N` FR pairs under -x sr, on the host (construction-truth gate)
    and on the lane (IDENTICAL);
  * `--mesh DxI`: the lane with the index sharded over a mesh, IDENTICAL
    to the host (under --device cuda it needs D*I cards).
`--device cpu` runs the lane with the plain versions: its identity lines
count, its times are not measured. Any mismatch or failed gate exits
non-zero.

Not ported: the reference-binary differential (`--skip-ref`'s subject),
which needs a binary no machine of the port has.

Usage:
  python -m minimap2_chaindp_tpu_torch.tools.genome_scale [--mb 50]
      [--reads 500] [--read-len 10000] [--device cuda|cpu] [--pe N]
      [--mesh DxI] [--skip-mapeval] [--skip-build] [--dir DIR]
"""
from __future__ import annotations

import argparse
import contextlib
import io as _io
import os
import resource
import sys
import tempfile
import time

import numpy as np

from ..utils.genome_synth import make_genome, simulate, simulate_pairs


def peak_rss_mb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


@contextlib.contextmanager
def _env(extra):
    saved = {k: os.environ.get(k) for k in extra}
    os.environ.update(extra)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_cli(args, env_extra=None):
    """One in-process run of the port's CLI with env_extra set: (seconds,
    output lines other than headers). A failed run prints the tail of its
    stderr and exits."""
    from .. import cli
    err = _io.StringIO()
    with tempfile.TemporaryFile("w+") as out, _env(env_extra or {}):
        old = sys.stdout
        sys.stdout = out
        try:
            with contextlib.redirect_stderr(err):
                t0 = time.perf_counter()
                rc = cli.main(list(args))
                dt = time.perf_counter() - t0
        finally:
            sys.stdout = old
        out.seek(0)
        lines = [ln for ln in out.read().split("\n")
                 if not ln.startswith("@")]
    if rc != 0:
        print(err.getvalue()[-2000:], file=sys.stderr)
        raise SystemExit(f"CLI failed: {' '.join(args)}")
    return dt, lines


class Lane:
    """The port's lane set beside the host (`--device cuda|cpu`): each run
    through the CLI, on the card with its peak device memory."""

    def __init__(self, device):
        self.device = device
        self.on_card = device == "cuda"

    def run(self, args):
        """(seconds, lines, peak device MB or None)."""
        if not self.on_card:
            dt, lines = run_cli([*args, "--device", self.device])
            return dt, lines, None
        import torch
        torch.cuda.reset_peak_memory_stats()
        dt, lines = run_cli([*args, "--device", self.device])
        return dt, lines, torch.cuda.max_memory_allocated() / 1e6

    def rate(self, n, dt) -> str:
        return f"{n / dt:.1f} reads/s" if self.on_card \
            else "reads/s not measured (plain versions on the CPU)"


def identity(a, b) -> str:
    return "IDENTICAL" if a == b else "MISMATCH"


def gate(label, a, b):
    """Print the first differing line pair and exit unless a == b."""
    if a == b:
        return
    for x, y in zip(a + [""], b + [""]):
        if x != y:
            print(f"{label} lane: {x[:160]}")
            print(f"{label} host: {y[:160]}")
            break
    raise SystemExit(1)


def build_stats(ref, mb, lane):
    """The in-process native index build (time, peak RSS, occurrences),
    then the same build with the pair sort on the lane's device."""
    from ..constants import seq_to_nt4
    from ..index.build import build_index
    from ..io.fastx import read_fastx
    t0 = time.perf_counter()
    names, seqs = [], []
    for r in read_fastx(ref):
        names.append(r.name)
        seqs.append(seq_to_nt4(r.seq))
    # a tuple: build_index frees the entries of a list as it packs them
    mi = build_index(names, tuple(seqs), 10, 15, 0, 14)
    t_idx = time.perf_counter() - t0
    print(f"[index] build {t_idx:.1f}s  ({mb / t_idx:.1f} Mb/s, "
          f"{len(mi.keys) / 1e6:.1f}M keys, {len(mi.values) / 1e6:.1f}M "
          f"positions, peak RSS {peak_rss_mb():.0f} MB)")
    occ = np.diff(mi.starts)
    print(f"[index] occurrence dist: mean {occ.mean():.2f}  "
          f"p50 {int(np.percentile(occ, 50))}  "
          f"p99 {int(np.percentile(occ, 99))}  max {int(occ.max())}")
    t0 = time.perf_counter()
    md = build_index(names, seqs, 10, 15, 0, 14, device=lane.device)
    t_dev = time.perf_counter() - t0
    same = all(np.array_equal(getattr(mi, f), getattr(md, f))
               for f in ("keys", "starts", "values"))
    t_txt = f"{t_dev:.1f}s" if lane.on_card else "time not measured"
    print(f"[index] device build (MM2TPU_DEVICE_INDEX=1, pairs sorted on "
          f"{lane.device}): {t_txt}; tables {identity(same, True)}")
    if not same:
        raise SystemExit(1)


def map_presets(ns, lane, mmi, mmi_h, ont, pb):
    """Fast path on/off identity, accuracy, and the lane's row."""
    for label, preset, q in (("map-ont", "map-ont", ont),
                             ("map-pb", "map-pb", pb)):
        idx = mmi_h if preset == "map-pb" else mmi
        with open(q) as fh:
            nreads = sum(1 for ln in fh if ln.startswith(">"))
        dt_on, out_on = run_cli(["-ax", preset, "--device", "host",
                                 "-t", "4", idx, q])
        dt_off, out_off = run_cli(
            ["-ax", preset, "--device", "host", idx, q],
            {"MM2TPU_NATIVE_SKELETON": "0"})
        ident = identity(out_on, out_off)
        print(f"[{label}] {nreads} reads: fast-path {nreads / dt_on:.1f} "
              f"reads/s ({dt_on:.1f}s incl. index load), staged "
              f"{nreads / dt_off:.1f} reads/s — on/off {ident}")
        gate(f"[{label}] fast-path", out_off, out_on)
        dt_l, out_l, mem = lane.run(["-ax", preset, "-t", "4", idx, q])
        mem_txt = "" if mem is None else \
            f", peak device memory {mem:.1f} MB"
        secs = f" ({dt_l:.1f}s)" if lane.on_card else ""
        print(f"[{label}] --device {lane.device}: {lane.rate(nreads, dt_l)}"
              f"{secs}{mem_txt} — vs --device host "
              f"{identity(out_l, out_on)}")
        gate(f"[{label}] --device {lane.device}", out_l, out_on)
        # accuracy gate on read-name truth (paftools mapeval convention)
        wrong = n_q60 = 0
        for ln in out_on:
            t = ln.split("\t")
            if len(t) < 11 or t[0].startswith("["):
                continue
            if int(t[1]) & 0x904:
                continue
            _name, truth_name, st = t[0].split("!")[0:3]
            if int(t[4]) >= 60:
                n_q60 += 1
                if t[2] != truth_name or abs(int(t[3]) - int(st)) > 20000:
                    wrong += 1
        print(f"[{label}] accuracy: {n_q60} primary Q60, {wrong} wrong")


def mapeval(ns, mmi, ont):
    """paftools mapeval on the host's PAF (1% error-fraction gate)."""
    from . import paftools as pt
    paf_path = os.path.join(ns.dir, f"ont{ns.mb}.paf")
    _dt, paf_lines = run_cli(["-cx", "map-ont", "--device", "host", mmi,
                              ont])
    with open(paf_path, "w") as f:
        f.write("\n".join(ln for ln in paf_lines if ln) + "\n")
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        pt.main(["mapeval", paf_path])
    rows = [ln.split("\t") for ln in buf.getvalue().splitlines()
            if ln.startswith("Q")]
    print("[mapeval] mapq-threshold curve (Q mapq n_new err_acc "
          "err_frac n_acc):")
    for r in rows:
        print("[mapeval]   " + "\t".join(r))
    total, frac = int(rows[-1][5]), float(rows[-1][4])
    print(f"[mapeval] {total} mapped primaries, cumulative error "
          f"fraction {frac:.3g}")
    if frac > 0.01:
        raise SystemExit("[mapeval] error fraction above 1% gate")


def paired(ns, lane, ref, mmi):
    """FR pairs with construction truth, on the host and on the lane."""
    pe1 = os.path.join(ns.dir, f"pe{ns.mb}_{ns.pe}_1.fq")
    pe2 = os.path.join(ns.dir, f"pe{ns.mb}_{ns.pe}_2.fq")
    truth = simulate_pairs(ref, pe1, pe2, ns.pe, seed=21)
    _, out_pe = run_cli(["-ax", "sr", "--device", "host", mmi, pe1, pe2])
    by_read: dict = {}
    for ln in out_pe:
        t = ln.split("\t")
        if len(t) < 11 or int(t[1]) & 0x900:
            continue
        by_read.setdefault(t[0], []).append(t)
    n_proper = n_pos_ok = 0
    for i, (cname, st1, st2, ins) in enumerate(truth):
        rows = by_read.get(f"pp{i}", [])
        a = next((t for t in rows if int(t[1]) & 0x40), None)
        b = next((t for t in rows if int(t[1]) & 0x80), None)
        if not a or not b or not (int(a[1]) & 0x2):
            continue
        n_proper += 1
        if (a[2] == cname and b[2] == cname
                and abs(int(a[3]) - 1 - st1) <= 8
                and abs(int(b[3]) - 1 - st2) <= 8
                and abs(abs(int(a[8])) - ins) <= 16):
            n_pos_ok += 1
    dt_l, out_l, mem = lane.run(["-ax", "sr", mmi, pe1, pe2])
    mem_txt = "" if mem is None else f", peak device memory {mem:.1f} MB"
    print(f"[pe] {ns.pe} FR pairs at {ns.mb} Mb: {n_proper} proper, "
          f"{n_pos_ok} at the constructed position/insert; --device "
          f"{lane.device} {lane.rate(ns.pe, dt_l).replace('reads', 'pairs')}"
          f"{mem_txt} — vs --device host {identity(out_l, out_pe)}")
    gate("[pe]", out_l, out_pe)
    if n_proper < ns.pe * 0.9 or n_pos_ok < n_proper * 0.97:
        raise SystemExit("[pe] proper-pair gate failed")


def mesh(ns, lane, ref, mmi):
    """The lane with the index sharded over a DxI mesh against the host."""
    mq = os.path.join(ns.dir, f"mesh_reads{ns.mb}_{ns.mesh_reads}.fa")
    if not os.path.exists(mq):
        simulate(ref, mq, ns.mesh_reads, 1000, 0.10, seed=9)
    dt_m, out_m, _mem = lane.run(["-ax", "map-ont", "--mesh", ns.mesh, mmi,
                                  mq])
    _, out_h = run_cli(["-ax", "map-ont", "--device", "host", mmi, mq])
    print(f"[mesh {ns.mesh}] {ns.mesh_reads} reads over the sharded "
          f"{ns.mb} Mb index on {lane.device}: {identity(out_m, out_h)} "
          f"({'%.1fs' % dt_m if lane.on_card else 'time not measured'})")
    gate(f"[mesh {ns.mesh}]", out_m, out_h)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=int, default=50)
    ap.add_argument("--reads", type=int, default=500)
    ap.add_argument("--read-len", type=int, default=10000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the port's lane beside the host")
    ap.add_argument("--mesh", default=None, metavar="DxI",
                    help="also map --mesh-reads reads on the lane with the "
                         "index sharded over a DxI mesh and compare with "
                         "the host run")
    ap.add_argument("--mesh-reads", type=int, default=100)
    ap.add_argument("--pe", type=int, default=0, metavar="N",
                    help="also map N simulated FR pairs (-x sr) against "
                         "the prebuilt index and gate on construction "
                         "truth (proper-pair rate, position, TLEN)")
    ap.add_argument("--skip-mapeval", action="store_true")
    ap.add_argument("--skip-build", action="store_true",
                    help="skip the in-process build timing/stats pass")
    ap.add_argument("--dir", default=None,
                    help="where the genome, reads and indexes are kept "
                         "(default: genome_scale under the temp directory)")
    ns = ap.parse_args(argv)
    if ns.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("[genome_scale] --device cuda: no CUDA device "
                             "is available (use --device cpu)")
    ns.dir = ns.dir or os.path.join(tempfile.gettempdir(), "genome_scale")
    os.makedirs(ns.dir, exist_ok=True)
    lane = Lane(ns.device)

    n_contigs = max(1, ns.mb // 2)
    ref = os.path.join(ns.dir, f"genome{ns.mb}.fa")
    if not os.path.exists(ref):
        dt = make_genome(ref, n_contigs=n_contigs)
        print(f"[genome] {ns.mb} Mb ({n_contigs} x 2.0 Mb contigs) "
              f"synthesized in {dt:.1f}s")
    if not ns.skip_build:
        build_stats(ref, ns.mb, lane)

    tag = f"{ns.mb}_{ns.reads}x{ns.read_len}"
    ont = os.path.join(ns.dir, f"ont{tag}.fa")
    pb = os.path.join(ns.dir, f"pb{tag}.fa")
    if not os.path.exists(pb):
        simulate(ref, ont, ns.reads, ns.read_len, 0.10, seed=5)
        simulate(ref, pb, max(ns.reads // 2, 50), ns.read_len, 0.12, seed=6)
        print(f"[reads] {ns.reads} x {ns.read_len} ONT-like, "
              f"{max(ns.reads // 2, 50)} PacBio-like")

    # dump the index once, map from it: reads/s without per-run rebuilds
    mmi = os.path.join(ns.dir, f"genome{ns.mb}.mm2i")
    if not os.path.exists(mmi):
        dtd, _ = run_cli(["--device", "host", "-d", mmi, ref])
        print(f"[index] dump+load path: -d wrote "
              f"{os.path.getsize(mmi) / 1e6:.0f} MB in {dtd:.1f}s")
    mmi_h = os.path.join(ns.dir, f"genomeH{ns.mb}.mm2i")
    if not os.path.exists(mmi_h):
        run_cli(["--device", "host", "-H", "-d", mmi_h, ref])

    # the load split: the mmap'd load, its first-touch walk, the eager load
    from ..index.serialize import load_index
    t0 = time.perf_counter()
    mi2 = load_index(mmi, mmap=True)
    t_mm = time.perf_counter() - t0
    t0 = time.perf_counter()
    int(mi2.keys.sum() + mi2.values.sum() + mi2.starts.sum()
        + int(mi2.S.sum()))
    t_touch = time.perf_counter() - t0
    del mi2
    t0 = time.perf_counter()
    load_index(mmi, mmap=False)
    t_eager = time.perf_counter() - t0
    print(f"[load] mmap {t_mm * 1e3:.1f} ms + full first-touch walk "
          f"{t_touch:.1f}s; eager load {t_eager:.1f}s "
          f"({os.path.getsize(mmi) / 1e6:.0f} MB)")

    map_presets(ns, lane, mmi, mmi_h, ont, pb)
    if not ns.skip_mapeval:
        mapeval(ns, mmi, ont)
    if ns.pe:
        paired(ns, lane, ref, mmi)
    if ns.mesh:
        mesh(ns, lane, ref, mmi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
