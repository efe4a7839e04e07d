"""The control comes out not correct: the reference put in the program's
place and computed in TF32 (the precision below the configurations'
float32 with TF32 off) fails a limit of each cell, at the cell's own size
on the card, on three seeds, on the rows a run compares (`readings.py
--control` reads more seeds).  TF32 exists on the card alone.

    python -m pytest -q -m cuda dfl_bench/test_dfl_bench_control.py
"""
import pytest
import torch

from dfl_bench import harness, traffic

CELLS = ["resnet56.ra", "charrnn.grid12", "resnet56.grid12"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 exists on the card alone")
    from repro_torch import resolve_device

    return resolve_device(torch.device("cuda", 0))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(name, card):
    c = harness.load_cell(name)
    fails = []
    for seed in (1, 2, 3):
        inputs = harness.make_inputs(c, seed, card)
        seeds = traffic.call_seeds(seed, 0, c.cell["seeds_per_point"])
        _, rows = harness.sample(c, seed, 1)
        low = harness.reference_rows(c, inputs, seeds, rows, card,
                                     tf32=True)
        want = harness.reference_rows(c, inputs, seeds, rows, card)
        numbers = harness.compare(low, want, inputs.test_count,
                                  c.cell.get("loss_floor", 0.0))
        fails.append(any(numbers[k] > v
                         for k, v in c.cell["limits"].items()))
    assert all(fails)
