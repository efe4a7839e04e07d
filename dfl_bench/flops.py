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

A model that holds a share of its experts (a configuration's ``routed``
entry) does routed work that depends on its data: each (token, k)
selection of a held expert costs ``flops_per_selection``.  The yardstick
counts what the usual MoE convention counts, the active parameters a
token: the expected selections a token makes on the held experts in each
MoE layer (k x held / E, ``selections_per_token``), over the sample's
``seq_len`` tokens, whatever the router of the code under test chose.
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


def forward_flops(config: dict) -> float:
    """The FLOPs of one sample's forward that a sweep is credited with:
    the static products, plus the expected routed work where the
    configuration states a ``routed`` term (exactly
    ``forward_flops_per_sample`` where it states none)."""
    routed = config.get("routed")
    if routed is None:
        return config["forward_flops_per_sample"]
    return (config["forward_flops_per_sample"]
            + routed["flops_per_selection"]
            * sum(routed["selections_per_token"]) * config["data"]["seq_len"])


def counted_flops(config: dict, samples: int, selections: int = 0) -> float:
    """The FLOPs a forward over ``samples`` samples does, where its router
    made ``selections`` (token, k) selections on the held experts: what a
    FLOP counter reads for that batch."""
    routed = config.get("routed")
    static = config["forward_flops_per_sample"] * samples
    if routed is None:
        return static
    return static + routed["flops_per_selection"] * selections


def scenario_round_flops(forward_per_sample: float, sizes, epochs: int,
                         test_samples: int) -> float:
    """One scenario's round: every client's training and evaluation."""
    own = sum(sizes)
    return forward_per_sample * (3 * epochs * own + own
                                 + len(sizes) * test_samples)
