"""The yardstick's arithmetic: model FLOPs from shapes and the card's
published peaks.

A configuration's file states its model's forward FLOPs for one sample
(an image, or a sequence of ``seq_len`` tokens): twice the multiply-adds
of its convolution, linear and LSTM products, nothing else
(`test_dfl_bench_flops.py` holds each to `torch.utils.flop_counter`).
A scenario-round of a D-FL sweep costs, per client, local training's
forward and backward (3x the forward) for each epoch over its own samples,
the evaluation forward over its own samples (the train loss) and over the
test set (the accuracy).  Tiled padding of a shard is not counted.
"""
from __future__ import annotations

import json
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "peaks.json"


def peaks(device_name: str) -> dict:
    """The published peaks of the card ``device_name`` (its name as
    `torch.cuda.get_device_name` gives it); a card not in the table
    raises rather than borrow another's figures."""
    table = json.loads(PEAKS_FILE.read_text())["cards"]
    if device_name not in table:
        raise KeyError(f"no published peaks for {device_name!r} in "
                       f"{PEAKS_FILE.name}: add the card's data-sheet figures")
    return table[device_name]


def scenario_round_flops(forward_per_sample: float, sizes, epochs: int,
                         test_samples: int) -> float:
    """One scenario's round: every client's training and evaluation."""
    own = sum(sizes)
    return forward_per_sample * (3 * epochs * own + own
                                 + len(sizes) * test_samples)
