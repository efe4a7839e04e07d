"""A run whose timed path is broken underneath comes out not correct: the
harness's whole CPU path at a small size (no look for a card), once for
each fault a sweep cell can have (`faults.FAULTS`: local training's state
returned unchanged, each shard fed as the first half of its samples, the
exchange between clients left out, one answer altered where it is made).
"""
import pytest
import torch

from dfl_bench import faults, harness, testing


def _run(kind):
    # One call, every scenario of it compared: the altered row is row 0.
    c = testing.tiny_cell(kind, protocols=testing.PROTOCOLS[:1],
                          seeds_per_point=1,
                          network={**testing.tiny_cell(kind).cell["network"],
                                   "tx_power_dbm": [20.0]})
    return harness.run_cell(c, seed=11, seconds=0.0, trace=False,
                            device=torch.device("cpu"), t_start=0.0)


@pytest.mark.parametrize("kind", ["char", "image", "tokens"])
def test_sound_run_is_correct(kind):
    run = _run(kind)
    assert run.correct, run.checks


@pytest.mark.parametrize("kind", ["char", "image", "tokens"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_fault_is_not_correct(kind, fault):
    with faults.planted(fault):
        run = _run(kind)
    assert not run.correct, (fault, run.checks)
    assert run.failed == 1
