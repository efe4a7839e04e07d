"""Local training of a model with convolutions, one client at a time over
its own samples (`fl.simulator.build_sim`), against the vmap(grad) path
over the tiled shards, on the CPU.

The reference is the same model with each HWIO kernel held as a rank-2
leaf (reshaped back inside the forward): the simulator then sees no conv
kernel and binds vmap(grad) over every client's shard tiled to the
largest, the path every model took before.  Leaves, segments and weights
are the same, so the two sims' rounds agree to float32 rounding.

* Shards of 3, 5 and 7 samples (the largest no multiple of the others).
* One `round_step` under protocol "none" (the trained rows alone) and
  under R&A; `advance_chunk_batch` under the scenario vmap with a
  per-client epoch vector and a participation mask.
* The kernels go channels-last under a batch's vmap over G > 1 scenarios
  (grouped convolutions) and stay HWIO views otherwise (`vmap_size`).
* The counter: a conv model computes its own samples only; `mlp`,
  `charrnn` and a MoE language model (rank-4 expert leaves, token inputs)
  still bind the vmap path (one gradient call an epoch, over the tiled
  shards).
"""
import functools
import warnings

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import topology
from repro_torch.data import synthetic
from repro_torch.data.synthetic import FederatedDataset
from repro_torch.fl import scenarios, simulator
from repro_torch.models import registry, smallnets

SIZES = [3, 5, 7]
N = len(SIZES)
HW, CH = 8, 3
EPOCHS = 2

MODELS = {
    "cnn": (functools.partial(smallnets.init_cnn, in_hw=(HW, HW), in_ch=CH,
                              c1=4, c2=8, fc=16), smallnets.apply_cnn),
    "resnet": (functools.partial(smallnets.init_resnet, depth=8, width=4,
                                 in_ch=CH), smallnets.apply_resnet),
}


def _data() -> FederatedDataset:
    rng = np.random.default_rng(0)
    return FederatedDataset(
        [rng.normal(size=(s, HW, HW, CH)).astype(np.float32) for s in SIZES],
        [rng.integers(0, 10, size=s).astype(np.int32) for s in SIZES],
        rng.normal(size=(6, HW, HW, CH)).astype(np.float32),
        rng.integers(0, 10, size=6).astype(np.int32))


def _flat_kernels(init, apply):
    """The model with every HWIO kernel held as a (H * W * I, O) leaf."""
    shapes = {k: tuple(v.shape) for k, v in
              init(torch.Generator().manual_seed(0)).items() if v.ndim == 4}

    def flat_init(gen):
        return {k: v.reshape(-1, v.shape[-1]) if k in shapes else v
                for k, v in init(gen).items()}

    def flat_apply(params, x):
        return apply({k: v.reshape(shapes[k]) if k in shapes else v
                      for k, v in params.items()}, x)

    return flat_init, flat_apply


def _sims(model: str):
    """(the conv sim, its vmap(grad) twin) on the same data and statics."""
    init, apply = MODELS[model]
    statics = dict(seg_len=64, local_epochs=EPOCHS, n_rounds=1,
                   agg_impl="torch", device="cpu")
    return (simulator.build_sim(init, apply, _data(), **statics),
            simulator.build_sim(*_flat_kernels(init, apply), _data(),
                                **statics))


def _net():
    return topology.make_network(topology.TABLE_II_COORDS[:N],
                                 edge_density=0.8, packet_len_bits=2048,
                                 n_clients=N, tx_power_dbm=17.0)


def _scenario(protocol: str, **kw):
    cfg = simulator.SimConfig(protocol=protocol, seg_len=64,
                              local_epochs=EPOCHS, lr=0.05, seed=3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return simulator.make_scenario(_net(), cfg, **kw)


def _rows(state):
    """A `round_step` state's params, each client's flattened in leaf
    order."""
    return torch.cat([v.reshape(N, -1) for v in state["params"].values()],
                     dim=1)


def _init_state(model):
    params = MODELS[model][0](torch.Generator().manual_seed(3))
    return {"params": {k: v[None].expand((N,) + tuple(v.shape))
                       for k, v in params.items()}}


def _flat_state(state):
    return {"params": {k: v.reshape(N, -1, v.shape[-1]) if v.ndim == 5
                       else v for k, v in state["params"].items()}}


def _allclose(got, want):
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_client_gradients_equal_vmap_over_tiled_shards(model):
    """Gradients alone: the trained rows of one round without exchange,
    each client's own samples weighed by their count in its tiled shard."""
    conv, ref = _sims(model)
    sc = _scenario("none")
    state = _init_state(model)
    got, _ = conv.round_step(state, sc)
    want, _ = ref.round_step(_flat_state(state), sc)
    _allclose(_rows(got), _rows(want))
    moved = _rows(got) - _rows(state)
    assert moved.abs().max() > 0


@pytest.mark.parametrize("model", sorted(MODELS))
def test_round_step_matches_vmap_path(model):
    conv, ref = _sims(model)
    sc = _scenario("ra", participation=[1.0, 0.0, 1.0],
                   local_epochs=[1, 2, 0])
    state = _init_state(model)
    u = torch.rand((N, N, conv.n_segments),
                   generator=torch.Generator().manual_seed(5))
    got, gm = conv.round_step(state, sc, u=u)
    want, wm = ref.round_step(_flat_state(state), sc, u=u)
    _allclose(_rows(got), _rows(want))
    _allclose(gm["loss"], wm["loss"])
    assert torch.equal(gm["acc"], wm["acc"])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_batched_rounds_match_vmap_path(model):
    """`advance_chunk_batch` under the scenario vmap (G = 2 seeds), with a
    per-client epoch vector and a participation mask."""
    conv, ref = _sims(model)
    grid = scenarios.ScenarioGrid.product(
        networks=[("n", _net())], protocols=[("ra", "ra_normalized")],
        seeds=[0, 1], lrs=[0.05], aggregator=0,
        participation=[("p", [1.0, 1.0, 0.0])], local_epochs=[2, 1, 2])
    axes, args = scenarios._hoist_uniform(grid.scenarios)
    out = []
    for sim in (conv, ref):
        sb = sim.prepare_batch(args, axes)
        state, metrics = sim.advance_chunk_batch(sim.init_scan_batch(sb), sb)
        out.append((state["w"], metrics))
    (w_got, m_got), (w_want, m_want) = out
    _allclose(w_got, w_want)
    _allclose(m_got["loss"], m_want["loss"])
    assert torch.equal(m_got["acc"], m_want["acc"])


def _grad_calls(monkeypatch) -> list:
    """Record each call of a gradient `torch.func.grad` binds."""
    calls, orig = [], torch.func.grad

    def grad(fn, *args, **kwargs):
        inner = orig(fn, *args, **kwargs)

        def call(*a, **k):
            calls.append(tuple(a[1].shape))
            return inner(*a, **k)
        return call

    monkeypatch.setattr(torch.func, "grad", grad)
    return calls


@pytest.mark.parametrize("model", sorted(MODELS))
def test_conv_model_computes_own_samples_only(model, monkeypatch):
    calls = _grad_calls(monkeypatch)
    conv, _ = _sims(model)
    calls.clear()
    before = dict(simulator.SAMPLE_PASSES)
    conv.round_step(_init_state(model), _scenario("ra"))
    got = {k: v - before.get(k, 0)
           for k, v in simulator.SAMPLE_PASSES.items()}
    assert got == {"computed": EPOCHS * sum(SIZES),
                   "own": EPOCHS * sum(SIZES)}
    # One call a client an epoch, over that client's own samples.
    assert [c[0] for c in calls] == SIZES * EPOCHS


def _vmap_model(name: str):
    if name == "granite-moe":
        model = registry.sim_model("nwp:granite_moe_1b_a400m", vocab=90)
        assert any(v.ndim == 4 for v in
                   model.init_fn(torch.Generator().manual_seed(0)).values())
        data = synthetic.fed_char_stream(n_clients=N, sequences_per_client=4,
                                         test_sequences=4, seq_len=5)
        return model.init_fn, model.apply_fn, data
    if name == "mlp":
        rng = np.random.default_rng(1)
        data = FederatedDataset(
            [rng.normal(size=(s, 6)).astype(np.float32) for s in SIZES],
            [rng.integers(0, 10, size=s).astype(np.int32) for s in SIZES],
            rng.normal(size=(4, 6)).astype(np.float32),
            rng.integers(0, 10, size=4).astype(np.int32))
        return (functools.partial(smallnets.init_mlp_clf, d_in=6,
                                  d_hidden=4), smallnets.apply_mlp_clf, data)
    data = synthetic.fed_char_stream(n_clients=N, sequences_per_client=4,
                                     test_sequences=4, seq_len=5)
    return (functools.partial(smallnets.init_charrnn, vocab=90, embed=4,
                              hidden=8), smallnets.apply_charrnn, data)


@pytest.mark.parametrize("model", ["mlp", "charrnn", "granite-moe"])
def test_other_models_bind_vmap_path(model, monkeypatch):
    """Models without convolutions, and a language model whose experts are
    rank-4 leaves, keep vmap(grad) over the tiled shards."""
    calls = _grad_calls(monkeypatch)
    init, apply, data = _vmap_model(model)
    sim = simulator.build_sim(init, apply, data, seg_len=64,
                              local_epochs=EPOCHS, n_rounds=1,
                              device="cpu")
    sizes = [len(x) for x in data.train_x]
    assert len(set(sizes)) > 1
    calls.clear()
    before = dict(simulator.SAMPLE_PASSES)
    params = init(torch.Generator().manual_seed(0))
    sim.round_step({"params": {k: v[None].expand((N,) + tuple(v.shape))
                               for k, v in params.items()}},
                   _scenario("ra"))
    got = {k: v - before.get(k, 0)
           for k, v in simulator.SAMPLE_PASSES.items()}
    assert got == {"computed": EPOCHS * N * max(sizes),
                   "own": EPOCHS * sum(sizes)}
    # One vmapped call an epoch: each call sees one client's tiled shard.
    assert [c[0] for c in calls] == [max(sizes)] * EPOCHS


def test_vmap_size_multiplies_the_batch_sizes():
    x = torch.zeros(2, 3, 5)
    assert repro_torch.vmap_size(x) == 1

    def size(t):
        return torch.tensor(repro_torch.vmap_size(t * 2))

    assert torch.func.vmap(size)(x[0]).tolist() == [3] * 3
    assert torch.func.vmap(size, in_dims=1)(x).tolist() == [3] * 3
    assert torch.func.vmap(torch.func.vmap(size))(x).tolist() == [[6] * 3] * 2


@pytest.mark.parametrize("g", [1, 2])
def test_kernels_go_channels_last_only_for_grouped_convolutions(g,
                                                                monkeypatch):
    conv, _ = _sims("resnet")
    calls = []

    def counted(params):
        calls.append(len(params))
        return smallnets.channels_last_kernels(params)

    monkeypatch.setattr(simulator, "channels_last_kernels", counted)
    grid = scenarios.ScenarioGrid.product(
        networks=[("n", _net())], protocols=[("ra", "ra_normalized")],
        seeds=range(g), lrs=[0.05], aggregator=0)
    axes, args = scenarios._hoist_uniform(grid.scenarios)
    sb = conv.prepare_batch(args, axes)
    conv.advance_chunk_batch(conv.init_scan_batch(sb), sb)
    assert len(calls) == (0 if g == 1 else EPOCHS * N)
