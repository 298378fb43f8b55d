"""The window's arithmetic, the roofline counts on hand-counted launches and
the per-layer readers on a hand-made record."""
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import roofline as RF
from benchmark import run as R
from benchmark.metrics import (card_chain_share_pct, chain_roofline_pct,
                               device_idle_pct, ksw2_roofline_pct,
                               seed_ms_per_mbase, staged_align_ms_per_mbase)


class SlowRuntime:
    """map_stream as TorchRuntime's: two batches in flight, each taking
    `dt` seconds; one SAM line per fragment."""

    def __init__(self, dt):
        self.dt = dt

    def map_batch(self, frags, rg_id=""):
        time.sleep(self.dt)
        return [[f"{f.segs[0].name}\t0"] for f in frags]

    def map_stream(self, batches, rg_id=""):
        with ThreadPoolExecutor(2) as ex:
            futs = deque()
            for b in batches:
                futs.append(ex.submit(self.map_batch, b))
                if len(futs) >= 2:
                    yield futs.popleft().result()
            while futs:
                yield futs.popleft().result()


def frag(name, n):
    return SimpleNamespace(segs=[SimpleNamespace(name=name, seq="A" * n)])


def test_window_counts_what_was_handed_and_waits_for_the_drain():
    pool = [[frag(f"b{b}r{j}", 100 + b) for j in range(3)] for b in range(3)]
    w = R.drive(SlowRuntime(0.2), lambda: iter(pool), len(pool), 0.5)
    t = w["tally"]
    n = t["batches"]
    assert n >= 3 and t["frags"] == 3 * n
    assert t["bases"] == sum(3 * (100 + i % 3) for i in range(n))
    # the batches in flight at the deadline are waited for: the window
    # closes after the last one handed came back
    assert w["t_end"] - w["t0"] >= 0.2 * n / 2
    assert set(w["first"]) == {0, 1, 2}
    assert all(len(set(d)) == 1 for d in w["digests"].values())
    assert w["first"][1][2] == ["b1r2\t0"]


def test_window_hands_at_least_one_batch():
    pool = [[frag("r", 10)]]
    w = R.drive(SlowRuntime(0.0), lambda: iter(pool), 1, 0.0)
    assert w["tally"]["batches"] == 1


def test_chain_work_hand_counted():
    # two reads; read 0 has 3 anchors with window starts 0, 0, 1: pairs
    # 0 + 1 + 1 = 2; read 1 has 1 anchor: 0 pairs; padding never counts
    stw = np.array([[0, 0, 1, 0], [0, 0, 0, 0]], np.int32)
    nn = np.array([[3], [1]], np.int32)
    ops, nbytes = RF.chain_work(stw, nn, 1000, "single")
    assert ops == 2 * 34
    assert nbytes == 1000 + 2 * 8 * 4 + 2 * 4
    assert RF.chain_work(stw, nn, 0, "cdna")[0] == 2 * 55


def test_ksw_work_hand_counted():
    ez = SimpleNamespace(zdropped=0, max_t=-1, max_q=-1,
                         cigar=[(3 << 4) | 0, (1 << 4) | 1])
    job = dict(qseq=np.zeros(3, np.uint8), tseq=np.zeros(2, np.uint8), w=-1,
               flag=0)
    f_ops, f_by, w_ops, w_by = RF.ksw_work([job], [ez], False)
    # an unbanded 3 x 2 matrix: 6 cells at 55 operations
    assert f_ops == 6 * 55
    assert f_by == 6 + 3 + 2 + 2 * RF.JOB_BYTES
    assert w_ops == 4 * RF.WALK_OPS_PER_STEP and w_by == 8 + 2 * RF.JOB_BYTES
    # a band of width 0 keeps the diagonal only; score-only keeps no CIGAR
    job0 = dict(job, w=0, flag=RF.KSW_EZ_SCORE_ONLY | RF.KSW_EZ_APPROX_MAX)
    f_ops, _, w_ops, _ = RF.ksw_work([job0], [ez], False)
    assert f_ops == 2 * (55 - 4 - 16) and w_ops == 0
    # z-dropped at (1, 0): anti-diagonals 0 and 1 only
    zd = SimpleNamespace(zdropped=1, max_t=1, max_q=0, cigar=[])
    assert RF.ksw_work([job], [zd], True)[0] == 3 * 47


def test_least_time():
    assert RF.least_s(RF.HBM_BYTES_S, 0) == pytest.approx(1.0)
    assert RF.least_s(0, RF.INT32_OPS_S) == pytest.approx(1.0)


def test_readers():
    rec = dict(timers=dict(seed=0.5, align=2.0),
               counters=dict(device_reads=90, staged_device_reads=5,
                             native_finish=90, staged_frags=10),
               frags=100, bases=10_000_000, window_s=10.0,
               device=dict(busy_s=0.25, window_s=10.0,
                           kernel_s=dict(chain=0.1, ksw=0.0),
                           least_s=dict(chain=0.02, ksw=0.0)))
    assert card_chain_share_pct.read(rec) == pytest.approx(95.0)
    assert seed_ms_per_mbase.read(rec) == pytest.approx(50.0)
    assert staged_align_ms_per_mbase.read(rec) is None
    assert chain_roofline_pct.read(rec) == pytest.approx(20.0)
    assert ksw2_roofline_pct.read(rec) is None
    assert device_idle_pct.read(rec) == pytest.approx(97.5)
    rec["counters"].update(native_finish=0, staged_frags=100)
    assert staged_align_ms_per_mbase.read(rec) == pytest.approx(200.0)
