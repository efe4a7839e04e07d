"""PyTorch port vs the JAX reference: the slice as a whole.

The reference's `round_step` (jitted) and the port's `round_step` advance
the same client-stacked weights round by round: the initial weights cross
from the reference's ``init_fn(PRNGKey(seed))`` through
`interop.params_from_jax`, and each round's uniforms are replayed from the
reference's key chain (``key, k_round = split(key)``).  The port is given
the reference's ``link_eps`` (the two packages' float32 channel math may
differ in the last bits, and a mask draw must not fall into that gap).

Tolerances per round: parameters and per-client train loss within 1e-4
(float32 gradient descent through GEMM/conv sums taken in another order),
per-client test accuracy equal or apart by at most one test sample.
"""
import dataclasses
import functools
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import codec_uniforms, round_uniforms  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro.optim import optimizers as joptimizers  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

SEED = 0


def _as_images(data, hw):
    """The same dataset with each sample reshaped to (H, W, 1) NHWC."""
    shape = (-1,) + hw + (1,)
    return dataclasses.replace(
        data, train_x=[x.reshape(shape) for x in data.train_x],
        test_x=data.test_x.reshape(shape))


@functools.lru_cache(maxsize=None)
def _bench(model: str, optimizer: str | None = None):
    """(reference sim, jitted round_step, reference init, data pair, net,
    statics) for one of the two slice configurations."""
    if model == "mlp":   # examples/quickstart.py
        kw = dict(n_clients=10, samples_per_client=80)
        jdata = jsynthetic.fed_image_classification(**kw)
        tdata = synthetic.fed_image_classification(**kw)
        jinit = functools.partial(jsmall.init_mlp_clf, d_in=32, d_hidden=48)
        apply_pair = (jsmall.apply_mlp_clf, smallnets.apply_mlp_clf)
        statics = dict(seg_len=256, local_epochs=3, n_rounds=3)
    else:                # a narrow paper CNN on 8x8x1 images
        kw = dict(n_clients=10, d=64, samples_per_client=40, test_size=200)
        jdata = _as_images(jsynthetic.fed_image_classification(**kw), (8, 8))
        tdata = _as_images(synthetic.fed_image_classification(**kw), (8, 8))
        jinit = functools.partial(jsmall.init_cnn, in_hw=(8, 8), c1=4, c2=8,
                                  fc=16)
        apply_pair = (jsmall.apply_cnn, smallnets.apply_cnn)
        statics = dict(seg_len=64, local_epochs=2, n_rounds=2)
    jnet = jtopology.make_network(
        jtopology.TABLE_II_COORDS, edge_density=0.5, packet_len_bits=100_000,
        n_clients=10, tx_power_dbm=17.0)
    jopt = ((lambda lr: joptimizers.adamw(lr, eps=ADAMW_EPS))
            if optimizer == "adamw_eps" else optimizer)
    jsim = jsimulator.build_sim(jinit, apply_pair[0], jdata, agg_impl="jnp",
                                local_optimizer=jopt, **statics)
    return jsim, jax.jit(jsim.round_step), jinit, tdata, jnet, apply_pair[1], \
        statics


def _port_network(jnet):
    tnet = topology.make_network(
        topology.TABLE_II_COORDS, edge_density=0.5, packet_len_bits=100_000,
        n_clients=10, tx_power_dbm=17.0)
    return dataclasses.replace(tnet, link_eps=torch.from_numpy(
        np.array(jnet.link_eps)))


def _replay(model, protocol, mode, agg_impl, *, optimizer=None,
            **scenario_kw):
    """Replay ``n_rounds`` rounds of both packages' `round_step` from the
    reference's weights and draws; ``scenario_kw`` go to both
    `make_scenario`s (a (T, N) participation schedule is sliced per round
    with `Scenario.at_round`)."""
    jsim, step, jinit, tdata, jnet, tapply, statics = _bench(model, optimizer)
    cfg = simulator.SimConfig(protocol=protocol, mode=mode, seed=SEED,
                              agg_impl=agg_impl, **statics)
    jcfg = jsimulator.SimConfig(protocol=protocol, mode=mode, seed=SEED,
                                **statics)
    with warnings.catch_warnings():   # 100,000-bit PER vs K-value segments
        warnings.simplefilter("ignore")
        jsc = jsimulator.make_scenario(jnet, jcfg, **scenario_kw).prepare()
        tsc = simulator.make_scenario(_port_network(jnet), cfg,
                                      **scenario_kw)

    key = jax.random.PRNGKey(SEED)
    params0 = jinit(key)
    tparams0 = interop.params_from_jax(jax.tree.map(np.asarray, params0))
    n = jsim.n_clients
    tsim = simulator.build_sim(
        lambda g: tparams0, tapply, tdata, seg_len=cfg.seg_len,
        local_epochs=cfg.local_epochs, n_rounds=cfg.n_rounds,
        agg_impl=agg_impl, device="cpu",
        local_optimizer=((lambda lr: optimizers.adamw(lr, eps=ADAMW_EPS))
                         if optimizer == "adamw_eps" else optimizer))
    assert tsim.n_segments == jsim.n_segments
    jstate = {"params": jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), params0)}
    tstate = {"params": {k: v[None].expand((n,) + tuple(v.shape))
                         for k, v in tparams0.items()}}
    test_n = len(tdata.test_y)
    for t in range(cfg.n_rounds):
        key, k_round = jax.random.split(key)
        jstate, jm = step(jstate, k_round, jsc.at_round(t))
        u = round_uniforms(protocol, k_round, n, jsim.n_segments)
        u_codec = codec_uniforms(k_round, n, jsim.n_segments, cfg.seg_len)
        tstate, tm = tsim.round_step(tstate, tsc.at_round(t), u=u,
                                     u_codec=u_codec)
        want = interop.params_from_jax(
            jax.tree.map(np.asarray, jstate["params"]))
        assert list(tstate["params"]) == list(want)
        for name, leaf in want.items():
            np.testing.assert_allclose(tstate["params"][name].numpy(),
                                       leaf.numpy(), atol=1e-4, rtol=0,
                                       err_msg=name)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   atol=1e-4, rtol=0)
        acc_gap = np.abs(tm["acc"].numpy() - np.asarray(jm["acc"]))
        assert acc_gap.max() <= 1.0 / test_n + 1e-6
        np.testing.assert_allclose(float(tm["bias"]), float(jm["bias"]),
                                   rtol=1e-4, equal_nan=True)


@pytest.mark.parametrize("protocol,mode,agg_impl", [
    ("ra", "ra_normalized", "kernel"),
    ("ra", "substitution", "torch"),
    ("aayg", "ra_normalized", "kernel"),
    ("cfl", "ra_normalized", "auto"),
    ("ideal_cfl", "ra_normalized", "auto"),
])
def test_quickstart_mlp_three_rounds_match_round_step(protocol, mode,
                                                      agg_impl):
    _replay("mlp", protocol, mode, agg_impl)


@pytest.mark.parametrize("mode", ["ra_normalized", "substitution"])
def test_narrow_cnn_two_rounds_match_round_step(mode):
    _replay("cnn", "ra", mode, "kernel")


def test_cnn_forward_and_losses_match_reference():
    key = jax.random.PRNGKey(3)
    params = jsmall.init_cnn(key, in_hw=(8, 8), c1=4, c2=8, fc=16)
    x = np.random.default_rng(0).normal(size=(5, 8, 8, 1)).astype(np.float32)
    y = np.array([0, 3, 9, 3, 1], np.int32)
    tparams = interop.params_from_jax(jax.tree.map(np.asarray, params))
    assert list(tparams) == ["conv1", "conv2", "fc1.b", "fc1.w", "fc2.b",
                             "fc2.w"]
    want = np.asarray(jsmall.apply_cnn(params, jnp.asarray(x)))
    got = smallnets.apply_cnn(tparams, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(
        float(smallnets.ce_loss(got, torch.from_numpy(y))),
        float(jsmall.ce_loss(jnp.asarray(want), jnp.asarray(y))), rtol=1e-5)
    assert float(smallnets.accuracy(got, torch.from_numpy(y))) == float(
        jsmall.accuracy(jnp.asarray(want), jnp.asarray(y)))
    # The port's own init has the reference's leaf names, shapes and order.
    own = smallnets.init_cnn(torch.Generator().manual_seed(0))
    ref = interop.params_from_jax(jax.tree.map(
        lambda s: np.zeros(s.shape, s.dtype),
        jax.eval_shape(jsmall.init_cnn, key)))
    assert [(k, tuple(v.shape)) for k, v in own.items()] == [
        (k, tuple(v.shape)) for k, v in ref.items()]
    assert sum(v.numel() for v in own.values()) == 421_546


def test_interop_rows_follow_reference_leaf_order():
    tree = {"b": {"w": np.arange(6.0).reshape(2, 3), "a": np.ones((2, 1))},
            "a": [np.zeros((2, 2)), np.full((2,), 5.0)]}
    flat = interop.params_from_jax(tree)
    assert list(flat) == ["a.0", "a.1", "b.a", "b.w"]
    rows = interop.rows_from_params(flat, seg_len=3)
    jrows = jprotocols._to_segments(jax.tree.map(jnp.asarray, tree), 3)[0]
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jrows))
    back = interop.params_from_rows(rows, flat)
    for k in flat:
        np.testing.assert_array_equal(back[k].numpy(), flat[k].numpy())


def test_run_on_own_rng_and_device_rule(monkeypatch):
    data = synthetic.fed_image_classification(n_clients=4, samples_per_client=20)
    net = topology.make_network(topology.TABLE_II_COORDS[:4],
                                packet_len_bits=8192)
    init = functools.partial(smallnets.init_mlp_clf, d_in=32, d_hidden=8)
    cfg = simulator.SimConfig(protocol="ra", seg_len=256, local_epochs=1,
                              n_rounds=4, eval_every=2, cfl_aggregator=1)
    res = simulator.run(init, smallnets.apply_mlp_clf, data, net, cfg,
                        device="cpu")
    assert res.acc_per_client.shape == (2, 4)
    assert res.loss_per_client.shape == (2, 4) and res.bias_norms.shape == (4,)
    assert np.isfinite(res.loss_per_client).all()
    again = simulator.run(init, smallnets.apply_mlp_clf, data, net, cfg,
                          device="cpu")
    np.testing.assert_array_equal(again.loss_per_client, res.loss_per_client)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulator.build_sim(init, smallnets.apply_mlp_clf, data, seg_len=256,
                            local_epochs=1, n_rounds=1)
    with pytest.raises(ValueError, match="eval_every"):
        simulator.build_sim(init, smallnets.apply_mlp_clf, data, seg_len=256,
                            local_epochs=1, n_rounds=3, eval_every=2,
                            device="cpu")


# A (T, N) participation schedule (T = 3 rounds) and heterogeneous epochs.
_SCHEDULE = np.array([[1, 1, 0, 1, 1, 0, 1, 1, 1, 0],
                      [0, 1, 1, 1, 0, 1, 1, 0, 1, 1],
                      [1, 0, 1, 1, 1, 1, 0, 1, 0, 1]], np.float32)
_EPOCHS = np.array([1, 3, 2, 3, 1, 2, 3, 0, 5, 2], np.int32)

CODEC_CASES = {
    "ra_topk0.3": (("ra", "ra_normalized", "kernel"),
                   dict(codec="topk", compress_ratio=0.3)),
    "ra_substitution_quant0.25": (("ra", "substitution", "kernel"),
                                  dict(codec="quant", compress_ratio=0.25)),
    "aayg_topk0.5": (("aayg", "ra_normalized", "kernel"),
                     dict(codec="topk", compress_ratio=0.5)),
    "cfl_quant0.5": (("cfl", "ra_normalized", "auto"),
                     dict(codec="quant", compress_ratio=0.5)),
    "ra_schedule_epochs": (("ra", "ra_normalized", "kernel"),
                           dict(participation=_SCHEDULE,
                                local_epochs=_EPOCHS)),
    "ra_quant_participation": (("ra", "ra_normalized", "kernel"),
                               dict(codec="quant", compress_ratio=0.25,
                                    participation=_SCHEDULE[0])),
}


@pytest.mark.parametrize("case", list(CODEC_CASES))
def test_quickstart_mlp_codec_and_participation_match_round_step(case):
    (protocol, mode, agg_impl), kw = CODEC_CASES[case]
    _replay("mlp", protocol, mode, agg_impl, **kw)


# AdamW at the reference's default eps = 1e-8 divides a gradient by its own
# size, so where a gradient is float32 noise (a ReLU unit at its kink) the
# two packages' 1-ulp gradient differences become steps of ~lr apart
# (`test_adamw_default_eps_departs_only_off_the_loss`).  The round replay
# therefore runs AdamW with eps = 1e-4, through the factory form of
# `local_optimizer`, in both packages.
ADAMW_EPS = 1e-4


def test_quickstart_mlp_adamw_heterogeneous_epochs_match_round_step():
    # Adam freezes the moments with the row after a client's own count:
    # freezing the row alone gives another result here (not under GD).
    _replay("mlp", "ra", "ra_normalized", "kernel", optimizer="adamw_eps",
            local_epochs=_EPOCHS)


def test_adamw_default_eps_departs_only_off_the_loss():
    """One round of local AdamW (eps 1e-8, protocol "none") from the same
    weights: the train loss and accuracy agree, and every parameter that
    departs by more than 1e-4 had a first-step gradient below 1e-5 in the
    reference (float32 noise that Adam's g / (|g| + eps) blows up)."""
    jsim, step, jinit, tdata, jnet, tapply, statics = _bench("mlp", "adamw")
    cfg = simulator.SimConfig(protocol="none", seed=SEED, **statics)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsc = jsimulator.make_scenario(jnet, jsimulator.SimConfig(
            protocol="none", seed=SEED, **statics)).prepare()
        tsc = simulator.make_scenario(_port_network(jnet), cfg)
    key = jax.random.PRNGKey(SEED)
    params0 = jinit(key)
    tparams0 = interop.params_from_jax(jax.tree.map(np.asarray, params0))
    tsim = simulator.build_sim(
        lambda g: tparams0, tapply, tdata, seg_len=cfg.seg_len,
        local_epochs=cfg.local_epochs, n_rounds=1, local_optimizer="adamw",
        device="cpu")
    n = jsim.n_clients
    jstate, jm = step({"params": jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), params0)},
        key, jsc)
    tstate, tm = tsim.round_step({"params": {
        k: v[None].expand((n,) + tuple(v.shape))
        for k, v in tparams0.items()}}, tsc)
    np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                               atol=1e-4, rtol=0)
    acc_gap = np.abs(tm["acc"].numpy() - np.asarray(jm["acc"]))
    assert acc_gap.max() <= 1.0 / len(tdata.test_y) + 1e-6
    xs, ys = jsimulator._pad_shards(jsynthetic.fed_image_classification(
        n_clients=10, samples_per_client=80))
    g1 = jax.vmap(jax.grad(lambda prm, x, y: jsmall.ce_loss(
        jsmall.apply_mlp_clf(prm, x), y)), in_axes=(None, 0, 0))(
            params0, xs, ys)
    g1 = interop.params_from_jax(jax.tree.map(np.asarray, g1))
    want = interop.params_from_jax(jax.tree.map(np.asarray,
                                                jstate["params"]))
    departed, largest = 0, 0.0
    for name, leaf in want.items():
        gap = np.abs(tstate["params"][name].numpy() - leaf.numpy())
        far = gap > 1e-4
        departed += int(far.sum())
        largest = max(largest, float(gap.max()))
        assert (np.abs(g1[name].numpy())[far] < 1e-5).all(), name
    print(f"adamw eps 1e-8, one round: {departed} parameters departed by "
          f"more than 1e-4, the largest by {largest:.3g}")


def _margin(scores: np.ndarray, k: int) -> float:
    """Gap between the k-th and (k+1)-th largest score (inf when k = N)."""
    s = np.sort(scores)[::-1]
    return float("inf") if k >= len(s) else float(s[k - 1] - s[k])


@pytest.mark.parametrize("policy,kw", [
    ("loss", {}),
    ("budget", dict(codec="topk", compress_ratio=0.5)),
], ids=["loss", "budget_topk0.5"])
def test_quickstart_mlp_closed_loop_matches_advance_chunk(policy, kw):
    """The closed loop replayed through both packages' `advance_chunk`:
    selected masks exactly, rows / losses / signals within 1e-4.  A mask
    is compared only where the selecting scores leave a margin above 1e-4
    between the k-th and (k+1)-th client; a seed without one fails."""
    jsim, _step, jinit, tdata, jnet, tapply, statics = _bench("mlp")
    cfg = simulator.SimConfig(seed=SEED, agg_impl="kernel", **statics)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jsc = jsimulator.make_scenario(
            jnet, jsimulator.SimConfig(seed=SEED, **statics),
            sampling_policy=policy, select_frac=0.5, **kw).prepare()
        tsc = simulator.make_scenario(_port_network(jnet), cfg,
                                      sampling_policy=policy,
                                      select_frac=0.5, **kw)
    tparams0 = interop.params_from_jax(jax.tree.map(
        np.asarray, jinit(jax.random.PRNGKey(SEED))))
    tsim = simulator.build_sim(
        lambda g: tparams0, tapply, tdata, seg_len=cfg.seg_len,
        local_epochs=cfg.local_epochs, n_rounds=cfg.n_rounds,
        agg_impl="kernel", device="cpu")
    n, s_total = jsim.n_clients, jsim.n_segments
    k = int(jsel.select_count(0.5, n))
    admission = np.asarray(jrouting.admission_scores(
        jnp.asarray(tdata.weights(), jnp.float32), jsc.rho[:n, :n]))
    advance = jax.jit(jsim.advance_chunk)
    jstate, tstate = jsim.init_scan(jsc), tsim.init_scan(tsc)
    np.testing.assert_allclose(tstate["sig"].loss.numpy(),
                               np.asarray(jstate["sig"].loss), atol=1e-5)
    for c in range(cfg.n_rounds):
        scores = (np.asarray(jstate["sig"].loss) if policy == "loss"
                  else admission)
        margin = _margin(scores, k)
        assert margin > 1e-4, (
            f"round {c}: selection margin {margin:.3g} <= 1e-4, the two "
            f"packages may pick different clients; compare another way")
        _key, k_round = jax.random.split(jstate["key"])
        jstate, jm = advance(jstate, jsc, c)
        tstate, tm = tsim.advance_chunk(
            tstate, tsc, u=[round_uniforms("ra", k_round, n, s_total)],
            u_codec=[codec_uniforms(k_round, n, s_total, cfg.seg_len)])
        np.testing.assert_array_equal(tm["selected"][0].numpy(),
                                      np.asarray(jm["selected"]))
        assert int(tm["selected"].sum()) == k
        np.testing.assert_allclose(tstate["w"].numpy(),
                                   np.asarray(jstate["w"]), atol=1e-4,
                                   rtol=0)
        np.testing.assert_allclose(tm["loss"].numpy(), np.asarray(jm["loss"]),
                                   atol=1e-4, rtol=0)
        for sig in ("loss", "upd_norm"):
            np.testing.assert_allclose(
                getattr(tstate["sig"], sig).numpy(),
                np.asarray(getattr(jstate["sig"], sig)), atol=1e-4, rtol=0)


# The reference's own invariants, exactly, on the port's CPU path.
def _toy():
    data = synthetic.fed_image_classification(n_clients=4,
                                              samples_per_client=20)
    net = topology.make_network(topology.TABLE_II_COORDS[:4],
                                edge_density=0.8, packet_len_bits=8192,
                                n_clients=4, tx_power_dbm=17.0)
    init = functools.partial(smallnets.init_mlp_clf, d_in=32, d_hidden=8)
    return data, net, init


def _toy_cfg(protocol="ra", mode="ra_normalized", **kw):
    return simulator.SimConfig(protocol=protocol, mode=mode, seg_len=256,
                               local_epochs=2, n_rounds=3, seed=1,
                               cfl_aggregator=1, agg_impl="kernel", **kw)


def _assert_runs_equal(a, b):
    for key in ("acc", "loss", "bias"):
        np.testing.assert_array_equal(a[key].numpy(), b[key].numpy(),
                                      err_msg=key)


ALL_PROTOCOLS = [("ra", "ra_normalized"), ("ra", "substitution"),
                 ("aayg", "ra_normalized"), ("cfl", "ra_normalized"),
                 ("ideal_cfl", "ra_normalized"), ("none", "ra_normalized")]


@pytest.mark.parametrize("protocol,mode", ALL_PROTOCOLS,
                         ids=["+".join(pm) for pm in ALL_PROTOCOLS])
def test_codec_none_and_uniform_policy_are_exact_no_ops(protocol, mode):
    data, net, init = _toy()
    cfg = _toy_cfg(protocol, mode)
    sim = simulator.build_sim(init, smallnets.apply_mlp_clf, data,
                              seg_len=256, local_epochs=2, n_rounds=3,
                              agg_impl="kernel", device="cpu")
    base = sim.run_scenario(simulator.make_scenario(net, cfg))
    for codec, ratio in (("none", 0.5), ("topk", 1.0)):
        _assert_runs_equal(base, sim.run_scenario(simulator.make_scenario(
            net, cfg, codec=codec, compress_ratio=ratio)))
    sched = np.array([[1, 0, 1, 1], [1, 1, 0, 1], [0, 1, 1, 1]], np.float32)
    open_loop = sim.run_scenario(simulator.make_scenario(
        net, cfg, participation=sched))
    closed = sim.run_scenario(simulator.make_scenario(
        net, cfg, participation=sched, sampling_policy="uniform"))
    _assert_runs_equal(open_loop, closed)
    np.testing.assert_array_equal(closed["selected"].numpy(), sched)
    assert "selected" not in open_loop
    if protocol == "ra":   # no schedule: the uniform base is all ones
        _assert_runs_equal(base, sim.run_scenario(simulator.make_scenario(
            net, cfg, sampling_policy="uniform")))


@pytest.mark.parametrize("epochs", [None, [1, 2, 0, 2]], ids=["static",
                                                              "per_client"])
def test_sgd_momentum0_is_exactly_plain_gd(epochs):
    data, net, init = _toy()
    cfg = _toy_cfg()
    sc = simulator.make_scenario(net, cfg, local_epochs=epochs)
    runs = [simulator.build_sim(
        init, smallnets.apply_mlp_clf, data, seg_len=256, local_epochs=2,
        n_rounds=3, local_optimizer=opt, device="cpu").run_scenario(sc)
        for opt in (None, "sgd", optimizers.sgd(cfg.lr))]
    _assert_runs_equal(runs[0], runs[1])
    _assert_runs_equal(runs[0], runs[2])


def test_new_arguments_are_validated_as_in_the_reference():
    data, net, init = _toy()
    jnet = jtopology.make_network(jtopology.TABLE_II_COORDS[:4],
                                  packet_len_bits=8192, n_clients=4)
    cases = [dict(codec="zip"), dict(codec="topk", compress_ratio=0.0),
             dict(codec="quant", compress_ratio=1.5),
             dict(sampling_policy="random")]
    for kw in cases:
        with pytest.raises(ValueError) as want:
            jsimulator.make_scenario(jnet, jsimulator.SimConfig(seg_len=256),
                                     **kw)
        with pytest.raises(ValueError) as got:
            simulator.make_scenario(net, _toy_cfg(), **kw)
        assert str(got.value) == str(want.value)
    for bad in ("lion", 3):
        with pytest.raises(ValueError) as want:
            jsimulator.build_sim(init, jsmall.apply_mlp_clf, data,
                                 seg_len=256, local_epochs=1, n_rounds=1,
                                 local_optimizer=bad)
        with pytest.raises(ValueError) as got:
            simulator.build_sim(init, smallnets.apply_mlp_clf, data,
                                seg_len=256, local_epochs=1, n_rounds=1,
                                local_optimizer=bad, device="cpu")
        assert str(got.value) == str(want.value)
    sim = simulator.build_sim(init, smallnets.apply_mlp_clf, data,
                              seg_len=256, local_epochs=1, n_rounds=2,
                              eval_every=2, device="cpu")
    closed = simulator.make_scenario(net, _toy_cfg(), sampling_policy="loss")
    state = {"params": {k: v[None].expand((4,) + tuple(v.shape))
                        for k, v in init(torch.Generator()).items()}}
    with pytest.raises(ValueError, match="closed-loop"):
        sim.round_step(state, closed)
    with pytest.raises(ValueError, match="at_round"):
        sim.round_step(state, simulator.make_scenario(
            net, _toy_cfg(), participation=np.ones((2, 4))))
    with pytest.raises(ValueError, match="one entry per round"):
        sim.advance_chunk(sim.init_scan(closed), closed, u=[None])
    m = sim.run_scenario(closed)
    assert m["selected"].shape == (2, 4) and m["acc"].shape == (1, 4)
    assert (m["selected"].sum(1) == 2).all()
