"""Synthetic anchor generation for benchmarks and stress tests.

Models the anchor statistics of a long noisy read mapped to one locus: a
noisy diagonal of seed hits (the true chain) plus scattered off-diagonal
hits, sorted by x like collect_seed_hits output."""
from __future__ import annotations

import numpy as np


def synth_read_anchors(rng: np.random.Generator, n: int, read_len: int = 10000,
                       span: int = 15) -> np.ndarray:
    n_diag = int(n * 0.8)
    n_noise = n - n_diag
    qp_d = np.sort(rng.integers(0, read_len, n_diag))
    rp_d = qp_d + rng.integers(-50, 50, n_diag) + 100
    qp_n = rng.integers(0, read_len, n_noise)
    rp_n = rng.integers(0, read_len + 200, n_noise)
    rp = np.concatenate([rp_d, rp_n])
    qp = np.concatenate([qp_d, qp_n])
    rp = np.maximum(rp, 0)
    x = rp.astype(np.uint64)  # rid 0, forward strand
    y = (np.uint64(span) << np.uint64(32)) | qp.astype(np.uint64)
    a = np.stack([x, y], axis=1)
    return a[np.argsort(a[:, 0], kind="stable")]


def synth_batch(n_reads: int, anchors_per_read: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [synth_read_anchors(rng, anchors_per_read) for _ in range(n_reads)]
