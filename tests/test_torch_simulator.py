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

from _torch_parity import round_uniforms  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.core import protocols as jprotocols  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402
from repro_torch.models import smallnets  # noqa: E402

SEED = 0


def _as_images(data, hw):
    """The same dataset with each sample reshaped to (H, W, 1) NHWC."""
    shape = (-1,) + hw + (1,)
    return dataclasses.replace(
        data, train_x=[x.reshape(shape) for x in data.train_x],
        test_x=data.test_x.reshape(shape))


@functools.lru_cache(maxsize=None)
def _bench(model: str):
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
    jsim = jsimulator.build_sim(jinit, apply_pair[0], jdata, agg_impl="jnp",
                                **statics)
    return jsim, jax.jit(jsim.round_step), jinit, tdata, jnet, apply_pair[1], \
        statics


def _port_network(jnet):
    tnet = topology.make_network(
        topology.TABLE_II_COORDS, edge_density=0.5, packet_len_bits=100_000,
        n_clients=10, tx_power_dbm=17.0)
    return dataclasses.replace(tnet, link_eps=torch.from_numpy(
        np.array(jnet.link_eps)))


def _replay(model, protocol, mode, agg_impl):
    jsim, step, jinit, tdata, jnet, tapply, statics = _bench(model)
    cfg = simulator.SimConfig(protocol=protocol, mode=mode, seed=SEED,
                              agg_impl=agg_impl, **statics)
    jcfg = jsimulator.SimConfig(protocol=protocol, mode=mode, seed=SEED,
                                **statics)
    with warnings.catch_warnings():   # 100,000-bit PER vs K-value segments
        warnings.simplefilter("ignore")
        jsc = jsimulator.make_scenario(jnet, jcfg).prepare()
        tsc = simulator.make_scenario(_port_network(jnet), cfg)

    key = jax.random.PRNGKey(SEED)
    params0 = jinit(key)
    tparams0 = interop.params_from_jax(jax.tree.map(np.asarray, params0))
    n = jsim.n_clients
    tsim = simulator.build_sim(
        lambda g: tparams0, tapply, tdata, seg_len=cfg.seg_len,
        local_epochs=cfg.local_epochs, n_rounds=cfg.n_rounds,
        agg_impl=agg_impl, device="cpu")
    assert tsim.n_segments == jsim.n_segments
    jstate = {"params": jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (n,) + x.shape), params0)}
    tstate = {"params": {k: v[None].expand((n,) + tuple(v.shape))
                         for k, v in tparams0.items()}}
    test_n = len(tdata.test_y)
    for _ in range(cfg.n_rounds):
        key, k_round = jax.random.split(key)
        jstate, jm = step(jstate, k_round, jsc)
        u = round_uniforms(protocol, k_round, n, jsim.n_segments)
        tstate, tm = tsim.round_step(tstate, tsc, u=u)
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
