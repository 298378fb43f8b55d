"""The staged path's native finish (models/replay.py, csrc/align_replay.cc)
on the CPU, the ksw2 kernels through their plain versions: TorchRuntime
with the native finish and with it turned off (the align generators under
run_scheduler) on the same batch write the same SAM bytes, which are the
JAX package's HostRuntime's too, and the native finish takes no more
extension waves. Cases: sr pairs with indels and mismatch clusters (z-drop
re-runs), map-ont reads with a long deletion (a z-drop split) and with an
inversion (the inversion rescue) on the staged path, units with no chains,
a read with 20+ regions (the generators' inversion rescue loses regions
the native driver and HostRuntime keep: that case compares the rest). A
splice run and a single-affine run are declined
and keep the generators. The counters add up, and the driver's copy in
csrc/ is held against native/align_driver.cc."""
import difflib
import os

import numpy as np
import pytest
import torch

from minimap2_chaindp_tpu.index.build import build_index as jax_build_index
from minimap2_chaindp_tpu.models.host_runtime import HostRuntime
from minimap2_chaindp_tpu.options import set_opt as jax_set_opt
from minimap2_chaindp_tpu_torch import constants as C
from minimap2_chaindp_tpu_torch.index.build import build_index
from minimap2_chaindp_tpu_torch.io.fastx import Frag, SeqRecord
from minimap2_chaindp_tpu_torch.models import replay as RP
from minimap2_chaindp_tpu_torch.models import runtime as RT
from minimap2_chaindp_tpu_torch.ops import ksw2 as K
from minimap2_chaindp_tpu_torch.options import set_opt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAM = C.MM_F_OUT_SAM | C.MM_F_CIGAR
# lines of csrc/align_driver.cc that may differ from native/align_driver.cc
# (removed + added): the header's three lines and a blank, the hook's eight
# declarations and a blank, its three lines in run_ext, update_extra's
# test (one line out, one in)
DRIVER_COPY_BUDGET = 18
BASES = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
REPEAT = 700        # the element repeated REPEAT_N times over the genome
REPEAT_N = 24


def _revcomp(s: bytes) -> bytes:
    return s[::-1].translate(COMP)


def _subs(rng, s: bytes, rate: float) -> bytes:
    b = np.frombuffer(s, np.uint8).copy()
    hit = rng.random(len(b)) < rate
    b[hit] = BASES[rng.integers(0, 4, int(hit.sum()))]
    return b.tobytes()


def make_genome():
    """Four random 120 kb contigs with REPEAT_N copies (1% apart) of one
    REPEAT-base element; returns (names, seqs as str, the element)."""
    rng = np.random.default_rng(2**31 + 20)
    seqs = [BASES[rng.integers(0, 4, 120_000)].tobytes() for _ in range(4)]
    elem = BASES[rng.integers(0, 4, REPEAT)].tobytes()
    for i in range(REPEAT_N):
        c = i % 4
        st = 2_000 + (i // 4) * 15_000
        s = seqs[c]
        seqs[c] = s[:st] + _subs(rng, elem, 0.01) + s[st + REPEAT:]
    return [f"c{i}" for i in range(4)], [s.decode() for s in seqs], elem


@pytest.fixture(scope="module")
def genome():
    return make_genome()


def _frag(name, *seqs):
    return Frag([SeqRecord(name, s.decode() if isinstance(s, bytes) else s)
                 for s in seqs])


def _sr_pairs(genome, rng):
    """Pairs with substitutions, small indels and 20-base mismatch
    clusters (z-drop re-runs of the ungapped fill), one random pair (no
    anchors) and one of 15-base mates (no minimizers)."""
    seqs = [s.encode() for s in genome[1]]
    frags = []
    for i in range(30):
        c = seqs[i % 4]
        ins = int(rng.integers(400, 600))
        st = int(rng.integers(20_000, len(c) - ins))
        mates = [bytearray(_subs(rng, c[st:st + 160], 0.02)),
                 bytearray(_subs(rng, c[st + ins - 160:st + ins], 0.02))]
        for m in mates:
            if rng.random() < 0.5:
                p, n = int(rng.integers(40, 110)), int(rng.integers(1, 11))
                if rng.random() < 0.5:
                    del m[p:p + n]
                else:
                    m[p:p] = BASES[rng.integers(0, 4, n)].tobytes()
            if rng.random() < 0.4:
                p = int(rng.integers(50, 100))
                m[p:p + 20] = BASES[rng.integers(0, 4, 20)].tobytes()
        frags.append(_frag(f"p{i}", bytes(mates[0][:150]),
                           _revcomp(bytes(mates[1][-150:]))))
    rand = BASES[rng.integers(0, 4, 300)].tobytes()
    frags.append(_frag("rand", rand[:150], rand[150:]))
    frags.append(_frag("short", b"ACGTTGCAACGTTGC", b"TTGCAACGTTGCAAC"))
    return frags


def _ont_reads(genome, rng, kind, n=4):
    """map-ont reads of about 2.5 kb, 4% substitutions: `div` with its
    middle 800 bases random (a z-drop split), `inv` with its middle 400
    bases reversed and complemented (the inversion rescue), `rep` the
    repeated element."""
    seqs = [s.encode() for s in genome[1]]
    frags = []
    for i in range(n):
        c = seqs[i % 4]
        st = int(rng.integers(20_000, len(c) - 5_000))
        if kind == "div":
            s = c[st:st + 900] + BASES[rng.integers(0, 4, 800)].tobytes() \
                + c[st + 1_700:st + 2_600]
        elif kind == "inv":
            s = c[st:st + 1_100] + _revcomp(c[st + 1_100:st + 1_500]) \
                + c[st + 1_500:st + 2_600]
        else:
            s = genome[2]
        s = _subs(rng, s, 0.04)
        frags.append(_frag(f"{kind}{i}", s if i % 2 else _revcomp(s)))
    return frags


CASES = {
    # name: (preset, frags, options)
    "sr-pairs-indels": ("sr", _sr_pairs, {}),
    "ont-split": ("map-ont", lambda g, r: _ont_reads(g, r, "div", 2), {}),
    "ont-inversion": ("map-ont", lambda g, r: _ont_reads(g, r, "inv"), {}),
    "no-chains": ("sr", lambda g, r: _sr_pairs(g, r)[-2:], {}),
    "many-regions": ("map-ont", lambda g, r: _ont_reads(g, r, "rep", 2),
                     {"best_n": 30}),
}


def _index(build, set_opt_, genome, preset, tweaks):
    io, mo = set_opt_(preset)
    mo.flag |= SAM
    for k, v in tweaks.items():
        setattr(mo, k, v)
    mi = build(genome[0], tuple(genome[1]), io.w, io.k, io.flag,
               io.bucket_bits)
    mo.update(mi)
    return mi, mo


def _run(genome, preset, frags, tweaks, monkeypatch, replay=True):
    """TorchRuntime on the CPU over the staged path alone (the fused flow
    off): its lines, counters, the staged units' regions and the waves
    handed to the executor."""
    mi, mo = _index(build_index, set_opt, genome, preset, tweaks)
    monkeypatch.setattr(RT, "flow_mode_ok", lambda opt: False)
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    if not replay:
        monkeypatch.setattr(rt._replay, "takes", lambda: False)
    waves, regs = [], []
    run, finish = rt.align_exec.run, rt._finish_staged
    monkeypatch.setattr(rt.align_exec, "run",
                        lambda jobs: waves.append(list(jobs)) or run(jobs))
    monkeypatch.setattr(rt, "_finish_staged", lambda p, c: (
        lambda out: regs.extend(out) or out)(finish(p, c)))
    lines = rt.map_batch(frags)
    return lines, dict(rt.timers.counters), regs, waves


def _flat(regs):
    return [r for segs in regs for rs in segs for r in rs]


def _fields(r):
    """A region's fields apart from its id, parent and rank-dependent
    sam_pri and mapq."""
    return (r.rid, r.rs, r.re, r.qs, r.qe, r.rev, r.split, r.split_inv,
            r.score, r.cnt, r.mlen, r.blen, r.p.dp_score, r.p.dp_max,
            r.p.cigar)


def _host_lines(genome, preset, frags, tweaks):
    mi, mo = _index(jax_build_index, jax_set_opt, genome, preset, tweaks)
    return HostRuntime(mi, mo).map_batch(frags)


@pytest.mark.parametrize("case", sorted(CASES))
def test_replay_matches_generators(genome, case, monkeypatch):
    preset, make, tweaks = CASES[case]
    frags = make(genome, np.random.default_rng(2**31 + len(case)))
    got, c, regs, waves = _run(genome, preset, frags, tweaks, monkeypatch)
    with monkeypatch.context() as m:
        want, c0, regs0, waves0 = _run(genome, preset, frags, tweaks, m,
                                       replay=False)
    assert got == _host_lines(genome, preset, frags, tweaks)
    if case == "ont-inversion":
        # the generators' align1_inv slices the query from its end where
        # the reversed local alignment reaches into the padding (q_off < 0;
        # native/align_driver.cc and the reference read before the gap's
        # start), and so may lose a rescued region: all else is equal
        def strip(rr):
            return [[[_fields(r) for r in rs if not r.inv] for rs in segs]
                    for segs in rr]
        assert strip(regs) == strip(regs0)
        assert sum(r.inv for r in _flat(regs)) \
            > sum(r.inv for r in _flat(regs0))
    else:
        assert got == want
    n_units = len(regs)
    assert c["replay_units"] == n_units and "replay_declined" not in c
    assert c0["replay_declined"] == n_units and "replay_units" not in c0
    # the inversion rescue's extension is a wave of its own here; the
    # generators run it on the host inside their advance
    assert len(waves) <= len(waves0) + (case == "ont-inversion")
    assert c["replay_rounds"] == len(waves) + 1
    assert c.get("replay_jobs", 0) == sum(len(w) for w in waves)
    flat = _flat(regs)
    if case == "sr-pairs-indels":
        # re-runs of ungapped fills: neither extension nor first-pass fill
        reruns = [j for w in waves for j in w if not j["flag"] & (
            K.KSW_EZ_EXTZ_ONLY | K.KSW_EZ_APPROX_MAX)]
        assert reruns and any(
            op & 0xF in (1, 2) for r in flat for op in r.p.cigar)
    elif case == "ont-split":
        assert any(r.split for r in flat)
    elif case == "ont-inversion":
        assert any(r.inv for r in flat) and any(r.split_inv for r in flat)
    elif case == "no-chains":
        assert all(segs == [[], []] for segs in regs) and not waves
    else:
        assert max(len(rs) for segs in regs for rs in segs) >= 20


@pytest.mark.parametrize("kind", ["splice", "single-affine"])
def test_replay_declines(genome, kind, monkeypatch):
    """A splice run and a single-affine run keep the align generators: no
    unit is replayed, every staged unit is counted declined."""
    if kind == "splice":
        preset, tweaks = "splice", {}
        frags = _ont_reads(genome, np.random.default_rng(5), "inv")[:2]
    else:
        # the units that need no extension: the generators have no
        # single-affine extension with a CIGAR (align.py's extz2)
        preset, tweaks = "sr", {"q2": 12, "e2": 2}
        frags = _sr_pairs(genome, np.random.default_rng(6))[-2:]
    got, c, regs, waves = _run(genome, preset, frags, tweaks, monkeypatch)
    assert "replay_units" not in c and "replay_rounds" not in c
    assert c["replay_declined"] == len(regs) == len(frags)
    assert got == _host_lines(genome, preset, frags, tweaks)


def test_replay_counters(genome, monkeypatch):
    """map_stream's two batch threads: replay_units + replay_declined is
    the staged units, replay_rounds counts a pass a round and at least one
    whenever a job ran, replay_jobs the jobs the executor was handed."""
    frags = _sr_pairs(genome, np.random.default_rng(7))
    mi, mo = _index(build_index, set_opt, genome, "sr", {})
    rt = RT.TorchRuntime(mi, mo, device="cpu")
    jobs = []
    run = rt.align_exec.run
    monkeypatch.setattr(rt.align_exec, "run",
                        lambda js: jobs.append(len(js)) or run(js))
    got = [ls for b in rt.map_stream([frags[:16], frags[16:]]) for ls in b]
    c = rt.timers.counters
    assert c["replay_units"] + c.get("replay_declined", 0) \
        == c["staged_frags"] == len(frags)
    assert c["replay_rounds"] >= 1 + (c["replay_jobs"] > 0)
    assert c["replay_rounds"] == len(jobs) + 2   # a last pass a batch
    assert c["replay_jobs"] == sum(jobs) > 0
    assert got == _host_lines(genome, "sr", frags, {})


def test_table_asks_each_job_once(genome, monkeypatch):
    """One unit with 24 regions: no job is handed to the card twice, in
    one wave or across waves (a result in the table is never asked for
    again, and a job two regions share is recorded once)."""
    frags = _ont_reads(genome, np.random.default_rng(8), "rep")[:1]
    _got, c, regs, waves = _run(genome, "map-ont", frags, {"best_n": 30},
                                monkeypatch)
    keys = [(j["qseq"].tobytes(), j["tseq"].tobytes(), j["w"], j["zdrop"],
             j["end_bonus"], j["flag"]) for w in waves for j in w]
    assert len(keys) == len(set(keys)) == c["replay_jobs"] > 0
    assert len(regs[0][0]) >= 20


def test_load_while_another_thread_builds(monkeypatch, tmp_path):
    """Threads that ask for the library while one builds it wait for the
    build (map_stream's two batch threads in a run's first batches): none
    is told there is no library."""
    import shutil
    import threading
    built = RP.load()[0]._name
    monkeypatch.setattr(RP, "_libs", None)
    monkeypatch.setattr(RP, "_tried", False)
    monkeypatch.setattr(RP, "lib_path", lambda: str(tmp_path / "lib.so"))

    def slow_build(srcs, path, extra=()):
        threading.Event().wait(0.3)
        shutil.copy(built, path)
    monkeypatch.setattr(RP.N, "_compile_so", slow_build)
    got = []
    threads = [threading.Thread(target=lambda: got.append(RP.load()))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(got) == 8 and all(g is not None for g in got)


def test_driver_copy_is_the_original():
    """csrc/align_driver.cc is native/align_driver.cc with the replay hook,
    within DRIVER_COPY_BUDGET lines; the library builds from it."""
    def lines(*p):
        with open(os.path.join(ROOT, *p)) as fh:
            return fh.read().splitlines()
    diff = [ln for ln in difflib.unified_diff(
        lines("native", "align_driver.cc"),
        lines("minimap2_chaindp_tpu_torch", "csrc", "align_driver.cc"),
        lineterm="", n=0)
        if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
    assert len(diff) <= DRIVER_COPY_BUDGET, "\n".join(diff)
    assert RP.load() is not None
