"""Faults planted in the port, for the readings that set a cell's limits
(`readings.py --faults`) and for the test that a broken run is not
correct (`test_dfl_bench_faults.py`).  Each is a context manager that
patches the port while open; build the runner inside it.

  * ``unchanged``: local training returns its state unchanged (every
    gradient the simulator binds reads zero, so each step is a no-op);
  * ``half_batch``: each client's shard fed as the first half of its own
    samples (the rest left out of the gradient, the mean taken over that
    half; the train loss it reports is that half's too);
  * ``no_exchange``: the exchange between clients left out (every client
    keeps its own trained model; a one-card cell has no exchange between
    cards, and this stands in for it);
  * ``altered``: one answer altered where it is produced (the first
    scenario's first client's train loss of the first round, by 1 %).
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


@contextlib.contextmanager
def _patched(owner, name, value):
    orig = getattr(owner, name)
    setattr(owner, name, value(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def _unchanged(orig):
    def grad(fn, *args, **kwargs):
        inner = orig(fn, *args, **kwargs)

        def call(*a, **k):
            return torch.zeros_like(inner(*a, **k))
        return call
    return grad


def _half_batch(orig):
    def pad(data):
        return orig(dataclasses.replace(
            data, train_x=[x[:len(x) // 2] for x in data.train_x],
            train_y=[y[:len(y) // 2] for y in data.train_y]))
    return pad


def _no_exchange(orig):
    def dispatch(w_seg, *args, **kwargs):
        _, e, bias = orig(w_seg, *args, **kwargs)
        return w_seg, e, bias
    return dispatch


def _altered(orig):
    def result(metrics, labels):
        res = orig(metrics, labels)
        res.loss = np.array(res.loss)
        res.loss[0, 0, 0] *= 1.01
        return res
    return result


def planted(fault: str):
    """A context manager under which the port runs with ``fault``."""
    if fault == "unchanged":
        return _patched(torch.func, "grad", _unchanged)
    if fault == "half_batch":
        from repro_torch.fl import simulator

        return _patched(simulator, "_pad_shards", _half_batch)
    if fault == "no_exchange":
        from repro_torch.core import protocols

        return _patched(protocols, "dispatch_round_seg", _no_exchange)
    if fault == "altered":
        from repro_torch.fl import scenarios

        return _patched(scenarios, "_metrics_to_grid_result", _altered)
    raise ValueError(f"unknown fault {fault!r}: choose from {FAULTS}")
