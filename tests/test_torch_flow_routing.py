"""The fused flow's routing counters and the native finish's counters, on
the CPU with the kernels' plain versions. TorchRuntime maps the
benchmark's tiny ONT mix (benchmark/tests/tiny.py) and one read past the
flow's last minimizer bucket: its SAM lines equal the plain reference's
(benchmark/reference, through benchmark/run.reference), the routing
counters add up (flow_units = flow_empty + every flow_out_* +
device_reads), and native_finish_bases is the summed length of the reads
the native finish took. Each reason a read leaves the flow is then forced
on DeviceFlow.run alone and counted under its own name."""
import numpy as np
import pytest
import torch

from benchmark import run as R
from benchmark.tests import tiny
from benchmark.traffic import synth
from minimap2_chaindp_tpu_torch import constants as C
from minimap2_chaindp_tpu_torch import native
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.io.fastx import read_fastx, read_frags
from minimap2_chaindp_tpu_torch.models import device_flow as DF
from minimap2_chaindp_tpu_torch.models.pipeline import (prepare_frag,
                                                        seed_unit)
from minimap2_chaindp_tpu_torch.models.runtime import TorchRuntime
from minimap2_chaindp_tpu_torch.ops import chain_pack as CP
from minimap2_chaindp_tpu_torch.options import set_opt
from minimap2_chaindp_tpu_torch.utils.timers import Timers

torch.set_num_threads(1)

SEED = 2**31 + 17
# past M_BUCKETS[-1] (4096) minimizers at map-ont's w=10 (about 0.19 a base)
LONG = 25_000


def _flow_identity(c) -> int:
    """flow_units less what the counters say became of each unit."""
    return c.get("flow_units", 0) - c.get("device_reads", 0) - sum(
        c.get(k, 0) for k in DF.FLOW_COUNTERS[1:])


def long_read(genome, rng, err: dict, path: str) -> None:
    """One read of LONG bases from the genome's longest run without N, with
    the mix's errors, written to `path` as FASTA."""
    best = (0, 0, 0)
    for ci, (_name, a) in enumerate(genome):
        edges = np.flatnonzero(np.diff(np.concatenate(
            [[1], (a | 0x20) == ord("n"), [1]]).astype(np.int8)))
        runs = edges.reshape(-1, 2)
        i = int(np.argmax(runs[:, 1] - runs[:, 0]))
        best = max(best, (int(runs[i, 1] - runs[i, 0]), ci, int(runs[i, 0])))
    size, ci, start = best
    assert size >= LONG
    src = genome[ci][1][start:start + LONG]
    seq, n = synth.mutate(rng, src, np.array([LONG]), err["rate"],
                          err["sub"], err["del"])
    with open(path, "wb") as fh:
        fh.write(synth.records(["long"], seq, n, fastq=False))


@pytest.fixture(scope="module")
def ont_inputs(tmp_path_factory):
    """(mi, mo, genome path, frags): the tiny ONT mix's reads, then one
    read of LONG bases from the same genome."""
    d = tmp_path_factory.mktemp("ont")
    config, mix = tiny.CONFIGS["ont"], tiny.MIXES["ont"]
    inputs = R.make_inputs(config, mix, SEED, str(d))
    genome, _loci = synth.build(
        np.random.default_rng([SEED, R.GENOME_STREAM]), config["genome"])
    long_fa = str(d / "long.fa")
    long_read(genome, np.random.default_rng(SEED), mix["error"], long_fa)
    io, mo = set_opt(config["preset"])
    mo.flag |= C.MM_F_OUT_SAM | C.MM_F_CIGAR
    recs = list(read_fastx(inputs["genome"]))
    mi = build_index([r.name for r in recs],
                     [C.seq_to_nt4(r.seq) for r in recs], io.w, io.k,
                     io.flag, io.bucket_bits)
    mo.update(mi)
    frags = [f for files in (inputs["files"], [long_fa])
             for b in read_frags(files, 10**9, False) for f in b]
    return mi, mo, inputs["genome"], frags


@pytest.fixture(scope="module")
def mapped(ont_inputs):
    """The reads mapped by TorchRuntime in two batches, its counters and
    the length of each read the native finish took."""
    mi, mo, _genome, frags = ont_inputs
    finished = []
    real = native.map_unit_text_chains_native

    def finish(mi_, opt, seg, *a, **kw):
        got = real(mi_, opt, seg, *a, **kw)
        finished.append(None if got is None else len(seg.seq))
        return got
    mp = pytest.MonkeyPatch()
    mp.setattr(native, "map_unit_text_chains_native", finish)
    try:
        rt = TorchRuntime(mi, mo, device="cpu")
        half = len(frags) // 2
        lines = [ls for b in rt.map_stream(iter([frags[:half],
                                                 frags[half:]]))
                 for ls in b]
        rt.close()
    finally:
        mp.undo()
    return lines, dict(rt.timers.counters), finished


def test_sam_equals_the_reference(ont_inputs, mapped):
    _mi, mo, genome, frags = ont_inputs
    lines, _c, _f = mapped
    out = R.reference(dict(genome=genome, preset="map-ont", flags=["-a"],
                           workers=2, frags=[R.frag_job(f) for f in frags]))
    assert out["mid_occ"] == mo.mid_occ
    assert lines == out["lines"]
    assert lines[-1][0].split("\t")[2] != "*"     # the long read maps


def test_flow_counters_add_up(mapped):
    _lines, c, _f = mapped
    assert c["flow_out_minimizers"] >= 1          # the long read
    assert c["device_reads"] >= 1
    assert _flow_identity(c) == 0
    # every unit the flow chained went to the native finish or was declined
    assert c["device_reads"] == c.get("native_finish", 0) + c.get(
        "native_finish_declined", 0)


def test_native_finish_counts_bases(mapped):
    _lines, c, finished = mapped
    took = [n for n in finished if n is not None]
    assert took and c["native_finish"] == len(took)
    assert c["native_finish_bases"] == sum(took)
    assert c.get("native_finish_declined", 0) == finished.count(None)


def _units(mi, mo, frags):
    return [(u, seed_unit(mi, mo, u, collect_hits=False))
            for f in frags for u in prepare_frag(mo, f.segs)[2]]


def _flag_first_row(real):
    def chain(*a, **kw):
        f, p, flag = real(*a, **kw)
        flag = flag.clone()
        flag[0, 0] = 1
        return f, p, flag
    return chain


@pytest.mark.parametrize("reason", ["flow_out_anchors", "flow_out_qspan",
                                    "flow_out_exc", "flow_out_flag"])
def test_each_reason_is_counted(ont_inputs, reason):
    """Each way out of the flow, forced: a last capacity bucket of 64
    anchors, every avg_qspan under 1.6, every exception table overflowing,
    the kernel's skip flag on the first row of each bucket."""
    mi, mo, _genome, frags = ont_inputs
    units = _units(mi, mo, frags)
    mp = pytest.MonkeyPatch()
    if reason == "flow_out_anchors":
        mp.setattr(DF, "CAP_BUCKETS", (64,))
    elif reason == "flow_out_qspan":
        real_stats = DF.host_seed_stats

        def stats(*a):
            n, _span, *rest = real_stats(*a)
            return (n, n, *rest)          # avg_qspan 1.0
        mp.setattr(DF, "host_seed_stats", stats)
    elif reason == "flow_out_exc":
        mp.setattr(CP, "clin_slope_exc", lambda avg: (0.0, None))
    else:
        mp.setattr(DF, "chain_scores_batch",
                   _flag_first_row(DF.chain_scores_batch))
    timers = Timers()
    try:
        DF.DeviceFlow(mi, mo, device="cpu").run(units, timers)
    finally:
        mp.undo()
    c = timers.counters
    assert c[reason] >= 1 and c["flow_out_minimizers"] == 1
    assert _flow_identity(c) == 0
    if reason == "flow_out_flag":
        assert c["fallback"] == c[reason]
    if reason in ("flow_out_qspan", "flow_out_exc"):
        assert c.get("device_reads", 0) == 0
    assert {"flow", "flow_prep"} <= set(timers.acc)
