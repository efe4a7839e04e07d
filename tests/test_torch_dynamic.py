"""PyTorch port vs the JAX reference: network generators, link schedules and
the dynamic `Scenario`.

Tolerances:
  * node positions, adjacency, Markov on/off patterns, sampling masks:
    exactly equal (both packages draw from ``np.random.default_rng(seed)``
    in the same order);
  * link success rates of generated networks and schedules: within 1e-6
    relative, with an absolute floor of 1e-12 for links that are all but
    dead (the float32 channel steps run through each package's own erfc;
    one float32 ulp of ``1 - Q`` becomes a relative gap of up to
    ``bits * 6e-8`` in ``(1 - Q) ** bits``, which shows only where the
    result is tiny: 2e-6 relative at 4e-13 absolute in one mobility case);
  * routing of a schedule, given the reference's ``link_eps``: rho within
    1e-6.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (thread count)
from repro.core import topology as jtopology  # noqa: E402
from repro.fl import scenarios as jscenarios  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402

EPS_RTOL = 1e-6
EPS_ATOL = 1e-12


def _same_network(a, b):
    np.testing.assert_array_equal(np.asarray(a.adjacency), b.adjacency.numpy())
    np.testing.assert_allclose(b.coords.numpy(), np.asarray(a.coords))
    np.testing.assert_allclose(b.link_eps.numpy(), np.asarray(a.link_eps),
                               rtol=EPS_RTOL, atol=EPS_ATOL)
    assert (b.n_clients, b.packet_len_bits, b.tx_power_dbm) == (
        a.n_clients, a.packet_len_bits, a.tx_power_dbm)


@pytest.mark.parametrize("n_relays", [0, 7, 14, 28])
def test_fig9_relay_networks_match(n_relays):
    kw = dict(edge_density=0.15, tx_power_dbm=17.0, packet_len_bits=32768)
    a = jtopology.paper_network_with_relays(n_relays, **kw)
    b = topology.paper_network_with_relays(n_relays, **kw)
    assert b.n_nodes == 10 + n_relays and b.n_clients == 10
    _same_network(a, b)


@pytest.mark.parametrize("kw", [dict(n_nodes=15, seed=3, n_clients=8),
                                dict(n_nodes=12, seed=0, edge_density=0.3)])
def test_random_geometric_networks_match(kw):
    _same_network(jtopology.random_geometric_network(**kw),
                  topology.random_geometric_network(**kw))


def test_make_network_takes_seed_and_ignores_it():
    nets = [topology.make_network(topology.TABLE_II_COORDS,
                                  packet_len_bits=32768, seed=s)
            for s in (0, 5)]
    for field in ("adjacency", "link_eps", "coords"):
        assert torch.equal(getattr(nets[0], field), getattr(nets[1], field))


def _nets(bits=32768):
    """(reference Table-II network, the port's with the reference's
    link_eps) — a schedule built on equal matrices must be equal."""
    jnet = jtopology.paper_network(packet_len_bits=bits)
    tnet = topology.paper_network(packet_len_bits=bits)
    return jnet, dataclasses.replace(tnet, link_eps=torch.from_numpy(
        np.array(jnet.link_eps)))


@pytest.mark.parametrize("kw", [dict(p_drop=0.3, seed=2),
                                dict(p_drop=0.6, p_recover=0.2, seed=7),
                                dict(p_drop=0.0)])
def test_markov_schedule_matches(kw):
    jnet, tnet = _nets()
    want = jtopology.markov_link_schedule(jnet, 6, **kw)
    got = topology.markov_link_schedule(tnet, 6, **kw)
    assert got.dtype == np.float32 and got.shape == (6, 10, 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got != 0, want != 0)
    # The port's own network: the same on/off pattern.
    own = topology.markov_link_schedule(topology.paper_network(
        packet_len_bits=32768), 6, **kw)
    np.testing.assert_array_equal(own != 0, want != 0)
    np.testing.assert_allclose(own, want, rtol=EPS_RTOL, atol=EPS_ATOL)
    with pytest.raises(ValueError, match="probabilities"):
        topology.markov_link_schedule(tnet, 2, p_drop=1.5)


@pytest.mark.parametrize("kw", [dict(step_m=300.0, seed=1),
                                dict(step_m=500.0, seed=2, range_m=2500.0),
                                dict(step_m=0.0),
                                dict(step_m=800.0, seed=4,
                                     area=(0.0, 0.0, 6000.0, 6000.0),
                                     packet_len_bits=25_000,
                                     tx_power_dbm=17.0)])
def test_mobility_schedule_matches(kw):
    jnet, tnet = _nets()
    want = jtopology.mobility_link_schedule(jnet, 5, **kw)
    got = topology.mobility_link_schedule(tnet, 5, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=EPS_RTOL, atol=EPS_ATOL)
    with pytest.raises(ValueError, match="step_m"):
        topology.mobility_link_schedule(tnet, 2, step_m=-1.0)


@pytest.mark.parametrize("kw", [dict(seed=5), dict(seed=1,
                                                   shadow_sigma_db=2.0),
                                dict(seed=3, packet_len_bits=25_000,
                                     tx_power_dbm=23.0)])
def test_fading_schedule_matches(kw):
    jnet, tnet = _nets()
    want = jtopology.fading_per_schedule(jnet, 4, **kw)
    got = topology.fading_per_schedule(tnet, 4, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=EPS_RTOL, atol=EPS_ATOL)


@pytest.mark.parametrize("args", [(5, 3, 1.0, 0), (10, 8, 0.5, 1),
                                  (10, 3, 0.5, 0), (7, 6, 0.3, 9)])
def test_sampling_schedule_matches(args):
    n, t, frac, seed = args
    want = jscenarios.sampling_schedule(n, t, frac, seed=seed)
    got = scenarios.sampling_schedule(n, t, frac, seed=seed)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="fraction"):
        scenarios.sampling_schedule(n, t, 0.0)


def test_schedule_scenario_prepare_and_at_round_match():
    jnet, tnet = _nets()
    sched = jtopology.markov_link_schedule(jnet, 3, p_drop=0.5, seed=4)
    part = jscenarios.sampling_schedule(10, 2, 0.5, seed=3)
    cfg = dict(seg_len=1024, seed=2)
    jsc = jsimulator.make_scenario(jnet, jsimulator.SimConfig(**cfg),
                                   link_schedule=sched,
                                   participation=part).prepare()
    tsc = simulator.make_scenario(tnet, simulator.SimConfig(**cfg),
                                  link_schedule=sched, participation=part)
    assert tsc.link_eps.shape == (3, 10, 10) and tsc.rho is None
    assert tsc.is_dynamic and not tsc.is_closed_loop
    tsc = tsc.prepare()
    assert tsc.prepare() is tsc                     # idempotent
    np.testing.assert_allclose(tsc.rho.numpy(), np.asarray(jsc.rho),
                               rtol=0, atol=1e-6)
    # Each entry routed alone gives the same matrix, bit for bit.
    for t in range(3):
        assert torch.equal(tsc.rho[t], simulator.route(tsc.link_eps[t]))
    for t in range(7):
        jt, tt = jsc.at_round(t), tsc.at_round(t)
        assert tt.link_eps.shape == (10, 10)
        np.testing.assert_array_equal(tt.link_eps.numpy(),
                                      np.asarray(jt.link_eps))
        np.testing.assert_allclose(tt.rho.numpy(), np.asarray(jt.rho),
                                   atol=1e-6)
        np.testing.assert_array_equal(tt.participation.numpy(),
                                      np.asarray(jt.participation))
        assert torch.equal(tt.rho, tsc.rho[t % 3])
        np.testing.assert_array_equal(tt.participation.numpy(), part[t % 2])


def test_static_scenario_flags_and_round_step_refuses_a_schedule():
    jnet, tnet = _nets()
    cfg = simulator.SimConfig(seg_len=1024)
    static = simulator.make_scenario(tnet, cfg)
    assert not static.is_dynamic and not static.is_closed_loop
    assert static.at_round(5) is static
    assert simulator.make_scenario(tnet, cfg, local_epochs=[1] * 10).is_dynamic
    closed = simulator.make_scenario(tnet, cfg, sampling_policy="loss")
    assert closed.is_closed_loop and not closed.is_dynamic
    for jsc, tsc in (
        (jsimulator.make_scenario(jnet, jsimulator.SimConfig()), static),
        (jsimulator.make_scenario(jnet, jsimulator.SimConfig(),
                                  link_schedule=np.ones((2, 10, 10))),
         simulator.make_scenario(tnet, cfg,
                                 link_schedule=np.ones((2, 10, 10)))),
    ):
        assert tsc.is_dynamic == jsc.is_dynamic
    from repro_torch.data import synthetic
    from repro_torch.models import smallnets
    data = synthetic.fed_image_classification(n_clients=10,
                                              samples_per_client=8)
    init = lambda g: smallnets.init_mlp_clf(g, d_in=32, d_hidden=4)  # noqa
    sim = simulator.build_sim(init, smallnets.apply_mlp_clf, data,
                              seg_len=64, local_epochs=1, n_rounds=1,
                              device="cpu")
    sched = simulator.make_scenario(tnet, cfg, link_schedule=np.asarray(
        jnp.ones((2, 10, 10))))
    state = {"params": {k: v[None].expand((10,) + tuple(v.shape))
                        for k, v in init(torch.Generator()).items()}}
    with pytest.raises(ValueError, match="at_round"):
        sim.round_step(state, sched)
    sim.round_step(state, sched.at_round(1))
