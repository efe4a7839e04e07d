"""Host-side data pipeline: batching iterators + client-stacked batches.

A numpy-only copy of the reference package's `data/pipeline.py` (the port
depends on nothing of the reference): for the same arguments and seed both
yield equal arrays (tests/test_torch_data.py).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, *,
            seed: int = 0, drop_last: bool = True) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Shuffled epoch iterator."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(x))
    end = (len(x) // batch_size) * batch_size if drop_last else len(x)
    for i in range(0, max(end, 1), batch_size):
        sel = idx[i : i + batch_size]
        if len(sel) == 0:
            break
        yield x[sel], y[sel]


def client_stacked_batch(xs: list[np.ndarray], ys: list[np.ndarray],
                         batch_size: int, *, seed: int = 0):
    """One (N, B, ...) stacked batch — one sub-batch per FL client.

    Clients with fewer than `batch_size` samples sample with replacement.
    """
    rng = np.random.default_rng(seed)
    bx, by = [], []
    for x, y in zip(xs, ys):
        sel = rng.choice(len(x), size=batch_size, replace=len(x) < batch_size)
        bx.append(x[sel])
        by.append(y[sel])
    return np.stack(bx), np.stack(by)


def lm_batches(stream: np.ndarray, batch_size: int, seq_len: int, *,
               seed: int = 0) -> Iterator[np.ndarray]:
    """Random-crop LM batches (tokens only; labels = tokens shifted)."""
    rng = np.random.default_rng(seed)
    n = len(stream) - seq_len - 1
    while True:
        starts = rng.integers(0, n, size=batch_size)
        yield np.stack([stream[s : s + seq_len + 1] for s in starts])
