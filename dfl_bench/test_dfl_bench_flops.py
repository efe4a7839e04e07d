"""Each configuration's stated forward FLOPs a sample against
`torch.utils.flop_counter.FlopCounterMode` over the port's forward and the
reference's, on a batch of two at full width (CPU), and its parameter
count; and the per-round count `flops.scenario_round_flops` sums."""
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from dfl_bench import flops, harness, reference, traffic

CONFIGS = harness.names("configs")


def _batch(config):
    data = config["data"]
    if data["kind"] == "image":
        return torch.randn(2, data["hw"], data["hw"], data["channels"])
    return torch.randint(data["vocab"], (2, data["seq_len"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_match_flop_counter(name):
    from repro_torch.models import registry

    config = harness.load_json(harness.find("configs", name))
    model = config["model"]
    sim = registry.sim_model(model["sim_model"])
    params = sim.init_fn(torch.Generator().manual_seed(0), **model["init"])
    x = _batch(config)
    counted = []
    for forward in (sim.apply_fn,
                    reference.model(config["reference"]).forward):
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            forward(params, x)
        counted.append(counter.get_total_flops() / 2)
    assert counted == [config["forward_flops_per_sample"]] * 2
    assert sum(t.numel() for t in params.values()) == config["parameters"]


def test_scenario_round_flops():
    # 2 clients of 3 and 5 samples, 2 epochs, 4 test samples, F = 10:
    # training 3 * 2 * 8, the train loss 8, the test 2 * 4 passes.
    assert flops.scenario_round_flops(10, [3, 5], 2, 4) == 10 * (48 + 8 + 8)


def test_peaks_are_the_data_sheets_and_refuse_other_cards():
    card = flops.peaks("NVIDIA H100 80GB HBM3")
    assert card["flops"]["float32"] == 67e12
    assert card["hbm_bytes_per_s"] == 3.35e12
    with pytest.raises(KeyError):
        flops.peaks("NVIDIA H100 PCIe")


def test_weights_have_the_layout_scales():
    layout = [("b", (3,), 0.0), ("w", (400, 50), 0.5)]
    w = traffic.Weights(layout, 7, torch.device("cpu"))(11)
    assert list(w) == ["b", "w"] and w["w"].shape == (400, 50)
    assert torch.equal(w["b"], torch.zeros(3))
    assert abs(float(w["w"].std()) - 0.5) < 0.01
    again = traffic.Weights(layout, 7, torch.device("cpu"))(11)
    assert torch.equal(w["w"], again["w"])
