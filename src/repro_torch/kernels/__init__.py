"""Hand-written Hopper kernels, their plain PyTorch versions and dispatch."""
from __future__ import annotations

import threading

_COUNT_LOCK = threading.Lock()


def count_launch(counter: dict, key, n: int = 1) -> None:
    """Add ``n`` to ``counter[key]`` (0 when absent) under one lock: kernels
    launch from several threads at once (a server's dispatcher, a router's
    replicas), and ``+= n`` on a dict entry is a read-modify-write."""
    with _COUNT_LOCK:
        counter[key] = counter.get(key, 0) + n
