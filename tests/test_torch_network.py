"""PyTorch port vs the JAX reference: data, topology, routing, segments.

Tolerances:
  * synthetic data: equal arrays (same numpy code);
  * adjacency and next-hop matrices: exactly equal;
  * per-link packet success: float32 `exp(bits * log(1 - Q))` turns one
    ulp of `1 - Q` near 1 (about 6e-8) into a relative change of up to
    `bits * 6e-8` — the stated bound, at 25,000 and 32,768 bits;
  * routing, given the reference's `link_eps`: rho within 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (thread count)
from repro.core import errors as jerrors  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro_torch.core import errors, routing, topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402


@pytest.mark.parametrize("kwargs", [
    dict(n_clients=10, samples_per_client=80),
    dict(n_clients=10, d=784, samples_per_client=60, seed=3),
    dict(n_clients=7, n_classes=5, classes_per_client=2, test_size=101),
])
def test_fed_image_classification_equal_arrays(kwargs):
    a = jsynthetic.fed_image_classification(**kwargs)
    b = synthetic.fed_image_classification(**kwargs)
    assert a.n_clients == b.n_clients
    for xa, xb in zip(a.train_x + a.train_y, b.train_x + b.train_y):
        np.testing.assert_array_equal(xa, xb)
    np.testing.assert_array_equal(a.test_x, b.test_x)
    np.testing.assert_array_equal(a.test_y, b.test_y)
    np.testing.assert_array_equal(a.weights(), b.weights())


@pytest.mark.parametrize("bits", [25_000, 32_768])
@pytest.mark.parametrize("tx_power", [20.0, 17.0])
@pytest.mark.parametrize("density", [0.3, 0.5])
def test_table_ii_link_eps_within_ulp_scaled_tolerance(bits, tx_power,
                                                       density):
    a = jtopology.make_network(jtopology.TABLE_II_COORDS,
                               edge_density=density, packet_len_bits=bits,
                               tx_power_dbm=tx_power)
    b = topology.make_network(topology.TABLE_II_COORDS,
                              edge_density=density, packet_len_bits=bits,
                              tx_power_dbm=tx_power)
    np.testing.assert_array_equal(np.asarray(a.adjacency), b.adjacency.numpy())
    ea, eb = np.asarray(a.link_eps), b.link_eps.numpy()
    assert eb.dtype == np.float32
    np.testing.assert_allclose(eb, ea, rtol=bits * 6e-8, atol=0)
    assert (b.n_clients, b.packet_len_bits, b.tx_power_dbm) == (
        a.n_clients, a.packet_len_bits, a.tx_power_dbm)


def test_paper_network_and_channel_primitives():
    a = jtopology.paper_network(packet_len_bits=32_768)
    b = topology.paper_network(packet_len_bits=32_768)
    np.testing.assert_array_equal(np.asarray(a.adjacency), b.adjacency.numpy())
    np.testing.assert_allclose(b.coords.numpy(), np.asarray(a.coords))
    d = np.array([0.5, 10.0, 400.0, 2500.0, 7000.0], np.float32)
    for jf, tf in [(jtopology.pathloss_db, topology.pathloss_db),
                   (jtopology.link_snr, topology.link_snr)]:
        np.testing.assert_allclose(tf(torch.from_numpy(d)).numpy(),
                                   np.asarray(jf(jnp.asarray(d))), rtol=1e-6)
    x = np.linspace(0.0, 6.0, 13, dtype=np.float32)
    np.testing.assert_allclose(topology.qfunc(torch.from_numpy(x)).numpy(),
                               np.asarray(jtopology.qfunc(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-12)


def _random_symmetric_eps(seed, v=9, density=0.45):
    rng = np.random.default_rng(seed)
    q = rng.uniform(0.05, 1.0, size=(v, v))
    keep = rng.random((v, v)) < density
    eps = np.triu(np.where(keep, q, 0.0), k=1)
    return (eps + eps.T).astype(np.float32)


def _link_eps_cases():
    yield "table_ii_25k", np.array(jtopology.paper_network().link_eps)
    yield "table_ii_quickstart", np.array(jtopology.make_network(
        jtopology.TABLE_II_COORDS, packet_len_bits=100_000,
        tx_power_dbm=17.0).link_eps)
    for seed in range(3):
        yield f"random_{seed}", _random_symmetric_eps(seed)


@pytest.mark.parametrize("name,eps", list(_link_eps_cases()))
def test_routing_matches_reference_given_link_eps(name, eps):
    rho_j, nxt_j = jrouting.e2e_success(jnp.asarray(eps))
    rho_t, nxt_t = routing.e2e_success(torch.from_numpy(eps))
    np.testing.assert_array_equal(nxt_t.numpy(), np.asarray(nxt_j))
    np.testing.assert_allclose(rho_t.numpy(), np.asarray(rho_j), atol=1e-6,
                               rtol=0)
    cost_j = np.asarray(jrouting.link_cost(jnp.asarray(eps)))
    cost_t = routing.link_cost(torch.from_numpy(eps)).numpy()
    np.testing.assert_array_equal(np.isinf(cost_t), np.isinf(cost_j))
    v = eps.shape[0]
    assert routing.all_routes(nxt_t, v) == jrouting.all_routes(
        np.asarray(nxt_j), v)


def test_reconstruct_route_sentinels():
    nxt = torch.tensor([[0, 1, 1], [0, 1, 2], [1, 1, 2]], dtype=torch.int32)
    assert routing.reconstruct_route(nxt, 0, 2) == [0, 1, 2]
    assert routing.reconstruct_route(nxt, 1, 1) == [1]
    unreachable = nxt.clone()
    unreachable[1, 2] = 1
    assert routing.reconstruct_route(unreachable, 0, 2) == []
    cycle = nxt.clone()
    cycle[1, 2] = 0
    assert routing.reconstruct_route(cycle, 0, 2) == []


@pytest.mark.parametrize("m,seg_len", [(1000, 256), (1024, 256), (7, 3),
                                       (421_546, 1024)])
def test_segment_round_trip_and_counts(m, seg_len):
    rng = np.random.default_rng(m)
    mat = rng.normal(size=(3, m)).astype(np.float32)
    seg_j = np.asarray(jerrors.segment(jnp.asarray(mat), seg_len))
    seg_t = errors.segment(torch.from_numpy(mat), seg_len)
    np.testing.assert_array_equal(seg_t.numpy(), seg_j)
    np.testing.assert_array_equal(errors.unsegment(seg_t, m).numpy(), mat)
    assert errors.num_segments(m, seg_len) == jerrors.num_segments(m, seg_len)
    assert errors.packet_len_bits(seg_len) == jerrors.packet_len_bits(seg_len)
    assert errors.dtype_bits(torch.bfloat16) == jerrors.dtype_bits(jnp.bfloat16)
    assert errors.dtype_bits(torch.float32) == jerrors.dtype_bits(jnp.float32)


@pytest.mark.parametrize("dtype", ["bool", "uint8", "float32"])
def test_sample_success_given_reference_uniforms(dtype):
    eps = _random_symmetric_eps(5)
    rho_j, _ = jrouting.e2e_success(jnp.asarray(eps))
    key = jax.random.PRNGKey(11)
    n, l = 6, 17
    e_j = np.asarray(jerrors.sample_success(key, rho_j, l, n_clients=n,
                                            dtype=getattr(jnp, dtype)))
    u = torch.from_numpy(np.array(jax.random.uniform(key, (n, n, l))))
    rho_t, _ = routing.e2e_success(torch.from_numpy(eps))
    e_t = errors.sample_success(rho_t, l, n_clients=n, u=u,
                                dtype=getattr(torch, dtype))
    assert str(e_t.dtype).endswith(dtype)
    np.testing.assert_array_equal(e_t.numpy(), e_j)
    # Own model always present; the port's own draws keep that too.
    g = torch.Generator().manual_seed(0)
    own = errors.sample_success(rho_t, l, n_clients=n, generator=g)
    assert bool(own[torch.arange(n), torch.arange(n)].all())


def test_param_count_and_stack_layout():
    stacked = {"a": torch.arange(12.).reshape(2, 2, 3),
               "b.b": torch.ones(2, 4), "b.w": torch.zeros(2, 1, 1)}
    mat, spec = errors.stack_to_matrix(stacked)
    assert mat.shape == (2, 11)
    assert errors.param_count({k: v[0] for k, v in stacked.items()}) == 11
    back = errors.matrix_to_stack(mat, spec)
    assert list(back) == list(stacked)
    for k in stacked:
        torch.testing.assert_close(back[k], stacked[k], rtol=0, atol=0)
