"""The comparison that decides `correct` is shown to fail.

The control: the reference put in the program's place with the DP's score
differences held in int4 lanes in place of int8 (one guarantee of the
configuration broken: the alignments of minimap2 v2.10), on every preset,
judged by the run's own comparison (`run.judge`). The faults: the harness
driven on the CPU with the timed path broken underneath it, once per fault a
cell can have (a step that returns its state unchanged, half the batch left
out, an answer altered where it is made), on each kind of traffic; the sound
run beside them comes out correct."""
import pytest

from benchmark import run as R
from benchmark.tests import tiny


def broken(runtime, fault: str):
    """The runtime with its map_batch broken by `fault`."""
    real = runtime.map_batch
    first = []

    def stale(frags, rg_id=""):
        out = real(frags, rg_id)
        if first:    # the state of the first batch, never advanced
            return (first[0] + [[]] * len(frags))[:len(frags)]
        first.append(out)
        return out

    def half(frags, rg_id=""):
        keep = len(frags) // 2
        return real(frags[:keep], rg_id) + [[] for _ in frags[keep:]]

    def alter(frags, rg_id=""):
        out = real(frags, rg_id)
        f = out[0][0].split("\t")
        f[4] = str((int(f[4]) + 1) % 61)     # the MAPQ of one answer
        out[0] = ["\t".join(f)] + out[0][1:]
        return out

    runtime.map_batch = dict(stale=stale, half=half, alter=alter)[fault]
    return runtime


@pytest.mark.parametrize("kind", ["ont", "sr", "cdna"])
def test_the_control_is_not_correct(kind, tmp_path):
    from minimap2_chaindp_tpu_torch.io.fastx import read_frags
    config, mix = tiny.CONFIGS[kind], dict(tiny.MIXES[kind], batches=1)
    inputs = R.make_inputs(config, mix, 23, str(tmp_path))
    frags = [f for b in read_frags(inputs["files"], 10**9,
                                   inputs["frag_mode"]) for f in b]
    out = R.reference(dict(genome=inputs["genome"], preset=config["preset"],
                           flags=config["flags"], workers=2, control=True,
                           frags=[R.frag_job(f) for f in frags]))
    picks = [(0, j) for j in range(len(frags))]
    ctl = dict(zip(picks, out["control_lines"]))
    checks, failed = R.judge([frags], picks, lambda b, j: ctl[b, j],
                             out["lines"], {}, {})
    assert checks["sample_mismatch"][0] >= 1 and failed >= 1
    same, _ = R.judge([frags], picks, lambda b, j: out["lines"][j],
                      out["lines"], {}, {})
    assert same == {"sample_mismatch": (0, 0), "pass_mismatch": (0, 0)}


@pytest.mark.parametrize("kind", ["ont", "sr", "cdna"])
@pytest.mark.parametrize("fault", [None, "stale", "half", "alter"])
def test_a_broken_timed_path_is_not_correct(fault, kind, monkeypatch):
    from minimap2_chaindp_tpu_torch import cli
    make = cli.make_runtime
    if fault:
        monkeypatch.setattr(cli, "make_runtime",
                            lambda *a: broken(make(*a), fault))
    res = R.run_cell(tiny.cell(), tiny.CONFIGS[kind], tiny.MIXES[kind],
                     2**31 + 11, 1.0, False, device="cpu")
    assert res["correct"] is (fault is None), res["checked"]
    assert list(res)[-1] == "checked"


def test_judge_holds_every_pass_to_its_warm_up():
    pool = [["a", "b"], ["c"]]
    lines = {(0, 0): ["x"], (0, 1): ["y"], (1, 0): ["z"]}
    picks = list(lines)
    ok, failed = R.judge(pool, picks, lambda b, j: lines[b, j],
                         [["x"], ["y"], ["z"]], {0: ["d0", "d0"], 1: ["d1"]},
                         {0: "d0", 1: "d1"})
    assert ok == {"sample_mismatch": (0, 0), "pass_mismatch": (0, 0)}
    assert failed == 0
    # a window pass that differs from the warm-up, the first one included
    bad, failed = R.judge(pool, picks, lambda b, j: lines[b, j],
                          [["x"], ["y"], ["z"]], {0: ["e", "d0"], 1: ["d1"]},
                          {0: "d0", 1: "d1"})
    assert bad["pass_mismatch"] == (1, 0) and failed == 2


def test_the_sample_covers_every_batch():
    pool = [[(b, j) for j in range(50 + b)] for b in range(8)]
    pool = [[type("F", (), {"segs": [type("S", (), {"seq": "A" * (1 + j)})]})
             for j in range(len(p))] for p in pool]
    for n in (8, 12, 16):
        picks = R.sample(pool, set(range(8)), n, 2**33 + 5)
        assert picks == R.sample(pool, set(range(8)), n, 2**33 + 5)
        per = [sum(b == k for b, _ in picks) for k in range(8)]
        assert min(per) >= n // 8 and len(set(picks)) == len(picks)
        assert (7, 56) in picks          # the longest
    assert R.sample(pool, {2}, 1000, 1) == [(2, j) for j in range(52)]
