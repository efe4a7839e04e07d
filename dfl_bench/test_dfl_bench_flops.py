"""Each configuration's stated forward FLOPs a sample against
`torch.utils.flop_counter.FlopCounterMode` over the port's forward and the
reference's, on a seeded batch of two at full width (CPU), and its
parameter count; the routed term of a model that holds a share of its
experts, on a plain-torch stand-in; the per-round count
`flops.scenario_round_flops` sums; and the initial weights' draw."""
import hashlib
import math

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from dfl_bench import flops, harness, reference, traffic

CONFIGS = harness.names("configs")


def _batch(config, seed=0):
    gen = torch.Generator().manual_seed(seed)
    data = config["data"]
    if data["kind"] == "image":
        return torch.randn(2, data["hw"], data["hw"], data["channels"],
                           generator=gen)
    return torch.randint(data["vocab"], (2, data["seq_len"]), generator=gen)


def _counted(forward, params, x) -> int:
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        forward(params, x)
    return counter.get_total_flops()


def _selections(ref, params, x) -> int:
    """The (token, k) selections on held experts that the reference's
    router makes on ``x`` (0 for a model without routed experts)."""
    count = getattr(ref, "routed_selections", None)
    return 0 if count is None else int(count(params, x))


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_flops_match_flop_counter(name):
    from repro_torch.models import registry

    config = harness.load_json(harness.find("configs", name))
    model = config["model"]
    sim = registry.sim_model(model["sim_model"])
    params = sim.init_fn(torch.Generator().manual_seed(0), **model["init"])
    ref = reference.model(config["reference"])
    x = _batch(config)
    want = flops.counted_flops(config, 2, _selections(ref, params, x))
    assert [_counted(f, params, x) for f in (sim.apply_fn, ref.forward)] == [
        want] * 2
    assert sum(t.numel() for t in params.values()) == config["parameters"]


class ToyShare:
    """A plain-torch language model that holds a share of its experts: an
    embedding, one MoE layer whose router scores all E experts (sigmoid
    scores; an expert bias used for the selection alone; the top k
    normalised; no token dropped) of which the first HELD are held here,
    each a SwiGLU of width FF, and a linear head.  What the absent experts
    would add is left out."""

    V, D, FF, E, K, HELD, S = 40, 16, 24, 8, 2, 2, 12

    @classmethod
    def params(cls, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        shapes = {"embed": (cls.V, cls.D), "router": (cls.D, cls.E),
                  "bias": (cls.E,), "w1": (cls.HELD, cls.D, cls.FF),
                  "w3": (cls.HELD, cls.D, cls.FF),
                  "w2": (cls.HELD, cls.FF, cls.D), "head": (cls.D, cls.V)}
        params = {k: torch.randn(s, generator=gen)
                  for k, s in shapes.items()}
        params["bias"] *= 0.01       # small beside the scores it shifts
        return params

    @classmethod
    def _route(cls, params, h):
        scores = torch.sigmoid(h @ params["router"])
        top = torch.topk(scores + params["bias"], cls.K, dim=-1).indices
        gate = scores.gather(-1, top)
        return top, gate / gate.sum(dim=-1, keepdim=True)

    @classmethod
    def forward(cls, params, tokens):
        h = params["embed"][tokens.long()].reshape(-1, cls.D)
        top, gate = cls._route(params, h)
        out = torch.zeros_like(h)
        for e in range(cls.HELD):
            tok, slot = (top == e).nonzero(as_tuple=True)
            x = h[tok]
            y = (F.silu(x @ params["w1"][e]) * (x @ params["w3"][e])
                 ) @ params["w2"][e]
            out.index_add_(0, tok, y * gate[tok, slot, None])
        return ((h + out) @ params["head"]).reshape(*tokens.shape, cls.V)

    @classmethod
    def routed_selections(cls, params, tokens):
        h = params["embed"][tokens.long()].reshape(-1, cls.D)
        return int((cls._route(params, h)[0] < cls.HELD).sum())

    @classmethod
    def config(cls) -> dict:
        return {"forward_flops_per_sample":
                2 * cls.S * cls.D * (cls.E + cls.V),
                "routed": {"flops_per_selection": 2 * 3 * cls.D * cls.FF,
                           "selections_per_token": [cls.K * cls.HELD
                                                    / cls.E]},
                "data": {"kind": "tokens", "vocab": cls.V,
                         "seq_len": cls.S}}


def test_routed_flops_follow_the_routers_selections():
    toy, params = ToyShare, ToyShare.params(3)
    config = toy.config()
    got = []
    for seed in (1, 2):
        x = _batch(config, seed)
        selections = _selections(toy, params, x)
        assert _counted(toy.forward, params, x) == flops.counted_flops(
            config, 2, selections)
        got.append(selections)
    # The routed work depends on the batch: the two counts differ, and
    # neither is all or none of the 2 x S x K selections.
    assert got[0] != got[1]
    assert all(0 < n < 2 * toy.S * toy.K for n in got), got
    # The yardstick credits the expected work, k x held / E a token.
    assert flops.forward_flops(config) == (
        config["forward_flops_per_sample"]
        + 2 * 3 * toy.D * toy.FF * 0.5 * toy.S)


@pytest.mark.parametrize("name", CONFIGS)
def test_round_flops_without_a_routed_term_are_the_stated_ones(name):
    config = harness.load_json(harness.find("configs", name))
    stated = config["forward_flops_per_sample"]
    routed = config.get("routed")
    if routed is None:
        # The very number the configuration states, as before routed terms.
        assert flops.forward_flops(config) is stated
    else:
        assert flops.forward_flops(config) == stated + routed[
            "flops_per_selection"] * sum(routed["selections_per_token"]) * (
                config["data"]["seq_len"])
    sizes = traffic.client_sizes(200, 10, 5)
    assert flops.scenario_round_flops(flops.forward_flops(config), sizes,
                                      2, 500) == flops.forward_flops(
        config) * (3 * 2 * sum(sizes) + sum(sizes) + 10 * 500)


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


def test_a_leaf_with_an_offset_draws_it_added():
    layout = [("norm", (64,), 0.0, 1.0), ("w", (400, 50), 0.5, 2.0),
              ("b", (3,), 0.0)]
    w = traffic.Weights(harness.scaled(layout, {"w": 0.5}), 7,
                        torch.device("cpu"))(11)
    assert torch.equal(w["norm"], torch.ones(64))
    assert torch.equal(w["b"], torch.zeros(3))
    assert abs(float(w["w"].mean()) - 2.0) < 0.01
    assert abs(float(w["w"].std()) - 0.25) < 0.01


def _digest(weights: dict) -> str:
    return hashlib.sha256(b"".join(t.numpy().tobytes()
                                   for t in weights.values())).hexdigest()


# sha256 of the draws of three-element layouts, taken before a layout
# could state an offset: the bytes, -0.0 of a zero-scaled leaf included.
DRAWS = {
    "small":
        "03aadc33115355199b9cfde01955bbc6f47ec9698207c5b06ed71798c1fe5cb2",
    "resnet56-cifar10":
        "292c535791604a03c4565258c5690ea8ef3201714ac5c73bc850523f9293307a",
    "charrnn-shakespeare":
        "7d02b0f03a47d2a3be7f9ef0671d521df53684d878082d6ee7f23518e2f32684",
}


@pytest.mark.parametrize("name", sorted(DRAWS))
def test_three_element_layouts_draw_the_pinned_weights(name):
    if name == "small":
        layout = [("b", (3,), 0.0), ("w", (40, 5), 0.5),
                  ("k", (2, 3, 3, 4), 0.125)]
    else:
        config = harness.load_json(harness.find("configs", name))
        layout = harness.scaled(reference.model(config["reference"]).layout(
            config["model"]["init"]), config.get("init_scales"))
    assert all(len(entry) == 3 for entry in layout)
    w = traffic.Weights(layout, 2 ** 33 + 7, torch.device("cpu"))(12345)
    assert sum(math.prod(t.shape) for t in w.values()) == sum(
        math.prod(shape) for _, shape, _ in layout)
    assert _digest(w) == DRAWS[name]
