"""PyTorch port vs the JAX reference: one exchange round, given the
reference's own uniforms.

Each reference protocol draws its randomness from a key; the port takes the
same uniforms as ``u`` (replayed by `_torch_parity.round_uniforms`), so the
sampled masks must be exactly equal and the aggregated segments equal to
1e-5 (float32 sums in another order).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import round_uniforms  # noqa: E402
from repro.core import protocols as jprot  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro_torch.core import protocols  # noqa: E402

N = 10
MODES = ("ra_normalized", "substitution")

# Jitted once per file: protocol / mode / aggregator ids are traced, so
# every case of a test reuses one compiled reference program.
J_RA = jax.jit(jprot.ra_round_seg)
J_AAYG = jax.jit(jprot.aayg_round_seg, static_argnames=("n_mixes",))
J_CFL = jax.jit(jprot.cfl_round_seg)
J_DISPATCH = jax.jit(jprot.dispatch_round_seg, static_argnames=("n_mixes",))


def _setup(seed, l=11, k=9):
    rng = np.random.default_rng(seed)
    net = jtopology.make_network(jtopology.TABLE_II_COORDS,
                                 packet_len_bits=100_000, tx_power_dbm=17.0)
    link_eps = np.array(net.link_eps)
    rho = np.array(jrouting.e2e_success(jnp.asarray(link_eps))[0])
    w = rng.normal(size=(N, l, k)).astype(np.float32)
    p = (rng.random(N) + 0.1).astype(np.float32)
    p /= p.sum()
    part = (rng.random(N) < 0.7).astype(np.float32)
    return w, p, link_eps, rho, part


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("participation", [False, True],
                         ids=["all", "sampled"])
@pytest.mark.parametrize("mode", MODES)
def test_ra_round_seg_matches_reference(mode, participation):
    w, p, _, rho, part = _setup(0)
    part = part if participation else None
    key = jax.random.PRNGKey(1)
    mid = protocols.MODE_IDS[mode]
    out_j, e_j = J_RA(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(rho), key,
        jnp.asarray(mid), None if part is None else jnp.asarray(part))
    u = round_uniforms("ra", key, N, w.shape[1])
    out_t, e_t = protocols.ra_round_seg(
        _t(w), _t(p), _t(rho), mid, None if part is None else _t(part), u=u)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_aayg_round_seg_matches_reference(mode, n_mixes=2):
    w, p, link_eps, _, part = _setup(1)
    key = jax.random.PRNGKey(2)
    mid = protocols.MODE_IDS[mode]
    for pt in (None, part):
        want = J_AAYG(
            jnp.asarray(w), jnp.asarray(p), jnp.asarray(link_eps), key,
            jnp.asarray(mid), n_mixes=n_mixes,
            participation=None if pt is None else jnp.asarray(pt))
        got = protocols.aayg_round_seg(
            _t(w), _t(p), _t(link_eps), mid, n_mixes=n_mixes,
            participation=None if pt is None else _t(pt),
            u=round_uniforms("aayg", key, N, w.shape[1], n_mixes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("aggregator", [6, 0])
@pytest.mark.parametrize("mode", MODES)
def test_cfl_round_seg_matches_reference(mode, aggregator):
    w, p, _, rho, part = _setup(2)
    key = jax.random.PRNGKey(3)
    mid = protocols.MODE_IDS[mode]
    part[aggregator] = 0.0   # the star center takes part regardless
    for pt in (None, part):
        want = J_CFL(
            jnp.asarray(w), jnp.asarray(p), jnp.asarray(rho), key,
            jnp.asarray(mid), jnp.asarray(aggregator),
            None if pt is None else jnp.asarray(pt))
        got = protocols.cfl_round_seg(
            _t(w), _t(p), _t(rho), mid, aggregator,
            None if pt is None else _t(pt),
            u=round_uniforms("cfl", key, N, w.shape[1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_ideal_round_seg_matches_reference():
    w, p, _, _, part = _setup(3)
    for pt in (None, part):
        want = jprot.ideal_round_seg(
            jnp.asarray(w), jnp.asarray(p),
            None if pt is None else jnp.asarray(pt))
        got = protocols.ideal_round_seg(_t(w), _t(p),
                                        None if pt is None else _t(pt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("protocol", sorted(protocols.PROTOCOL_IDS))
def test_dispatch_round_seg_every_protocol(protocol, mode):
    w, p, link_eps, rho, _ = _setup(4, l=6)
    key = jax.random.PRNGKey(4)
    pid, mid = protocols.PROTOCOL_IDS[protocol], protocols.MODE_IDS[mode]
    out_j, e_j, bias_j = J_DISPATCH(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(rho),
        jnp.asarray(link_eps), key, jnp.asarray(pid), jnp.asarray(mid),
        jnp.asarray(6), n_mixes=2)
    out_t, e_t, bias_t = protocols.dispatch_round_seg(
        _t(w), _t(p), _t(rho), _t(link_eps), pid, mid, 6, n_mixes=2,
        u=round_uniforms(protocol, key, N, w.shape[1], 2))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(float(bias_t), float(bias_j), rtol=1e-5,
                               equal_nan=True)
    _, _, no_bias = protocols.dispatch_round_seg(
        _t(w), _t(p), _t(rho), _t(link_eps), pid, mid, 6, n_mixes=2,
        u=round_uniforms(protocol, key, N, w.shape[1], 2), track_bias=False)
    if protocol != "ideal_cfl":
        assert torch.isnan(no_bias)


def test_uniform_shapes_are_checked_and_own_draws_work():
    w, p, link_eps, rho, _ = _setup(5, l=4)
    with pytest.raises(ValueError, match="uniforms must have shape"):
        protocols.ra_round_seg(_t(w), _t(p), _t(rho), 0,
                               u=torch.rand(N, N, 5))
    g = torch.Generator().manual_seed(0)
    out, e = protocols.ra_round_seg(_t(w), _t(p), _t(rho), 0, generator=g)
    assert out.shape == w.shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="unknown protocol id"):
        protocols.dispatch_round_seg(_t(w), _t(p), _t(rho), _t(link_eps),
                                     9, 0, 6)


# The codec threading (tx_mask / w_raw) with the aggregation on the kernel
# path: the reference's Pallas kernel in interpret mode against the port's
# K1 plain version.  Static agg_impl, so one compiled program for every
# protocol and mode.
J_DISPATCH_PALLAS = jax.jit(
    lambda *a, **kw: jprot.dispatch_round_seg(*a, agg_impl="pallas", **kw),
    static_argnames=("n_mixes",))


@pytest.mark.parametrize("sampled", [False, True], ids=["all", "sampled"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("protocol", sorted(protocols.PROTOCOL_IDS))
def test_dispatch_round_seg_with_codec_masks(protocol, mode, sampled):
    w, p, link_eps, rho, part = _setup(6, l=6)
    rng = np.random.default_rng(7)
    tx = rng.random((N, w.shape[1])) < 0.6
    w_raw = w + rng.normal(size=w.shape).astype(np.float32)
    part = part if sampled else None
    key = jax.random.PRNGKey(5)
    pid, mid = protocols.PROTOCOL_IDS[protocol], protocols.MODE_IDS[mode]
    out_j, e_j, bias_j = J_DISPATCH_PALLAS(
        jnp.asarray(w), jnp.asarray(p), jnp.asarray(rho),
        jnp.asarray(link_eps), key, jnp.asarray(pid), jnp.asarray(mid),
        jnp.asarray(6), n_mixes=2,
        participation=None if part is None else jnp.asarray(part),
        tx_mask=jnp.asarray(tx), w_raw=jnp.asarray(w_raw))
    out_t, e_t, bias_t = protocols.dispatch_round_seg(
        _t(w), _t(p), _t(rho), _t(link_eps), pid, mid, 6, n_mixes=2,
        participation=None if part is None else _t(part),
        tx_mask=_t(tx), w_raw=_t(w_raw), agg_impl="kernel",
        u=round_uniforms(protocol, key, N, w.shape[1], 2))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5)
    np.testing.assert_allclose(float(bias_t), float(bias_j), rtol=1e-5,
                               equal_nan=True)
    if protocol in ("ideal_cfl", "none"):   # nothing on the air
        base = protocols.dispatch_round_seg(
            _t(w_raw), _t(p), _t(rho), _t(link_eps), pid, mid, 6,
            participation=None if part is None else _t(part))[0]
        assert torch.equal(out_t, base)
