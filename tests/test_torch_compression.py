"""PyTorch port vs the JAX reference: the exchange codec, the Fig. 8 bias
statistic, the convergence bound and the overhead accounting.

Inputs are made with numpy from a seed; the quantizer's uniforms are the
reference's own draw from its key (the port takes them as ``u``).  Masks,
counts and ranks must be exactly equal; float32 values within 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import aggregation as jagg  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import convergence as jconv  # noqa: E402
from repro.core import overhead as joverhead  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro_torch.core import aggregation, compression, convergence  # noqa: E402
from repro_torch.core import overhead, routing  # noqa: E402

N, S, K = 6, 9, 16
J_ENCODE = jax.jit(jcomp.encode, static_argnames=("n_real", "dtype_bits"))


def _t(x):
    return torch.from_numpy(np.array(x))


def _rows(seed, *, s=S, n_real=None):
    """(N, s, K) float32 rows; zero rows past ``n_real`` (shard padding),
    one all-zero real segment and one tie of equal-norm segments."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(N, s, K)).astype(np.float32)
    w *= rng.uniform(0.1, 3.0, size=(N, s, 1)).astype(np.float32)
    w[0, 2] = 0.0
    w[1, 4] = w[1, 1]
    if n_real is not None:
        w[:, n_real:] = 0.0
    return w


def test_keep_count_and_quant_bits_follow_the_float32_nudge():
    # The documented case: 0.3 of 50 keeps 15 (a raw ceil keeps 16).
    assert int(compression.keep_count(0.3, 50)) == 15
    ratios = np.arange(1, 1001, dtype=np.float64) / 1000.0
    want_k = np.asarray(jcomp.keep_count(jnp.asarray(ratios, jnp.float32),
                                         412))
    got_k = compression.keep_count(torch.tensor(ratios, dtype=torch.float32),
                                   412).numpy()
    np.testing.assert_array_equal(got_k, want_k)
    for bits in (16, 32):
        want_b = np.asarray(jcomp.quant_bits(
            jnp.asarray(ratios, jnp.float32), bits))
        got_b = compression.quant_bits(
            torch.tensor(ratios, dtype=torch.float32), bits).numpy()
        np.testing.assert_array_equal(got_b, want_b)
    for r in (0.3, 0.25, 1.0, 1e-4):
        assert int(compression.keep_count(r, 50)) == int(
            jcomp.keep_count(r, 50))


@pytest.mark.parametrize("ratio", ["scalar", "per_client"])
@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("codec", sorted(compression.CODEC_IDS))
def test_encode_matches_reference(codec, padded, ratio):
    n_real = 6 if padded else None
    w = _rows(1, n_real=n_real)
    r = (np.float32(0.3) if ratio == "scalar"
         else np.linspace(0.05, 1.0, N).astype(np.float32))
    cid = compression.CODEC_IDS[codec]
    key = jax.random.PRNGKey(7)
    nr = S if n_real is None else n_real
    w_j, tx_j = J_ENCODE(jnp.asarray(cid), jnp.asarray(w), jnp.asarray(r),
                         key, n_real=nr, dtype_bits=32)
    u = _t(jax.random.uniform(key, (N, nr, K)))
    w_t, tx_t = compression.encode(cid, _t(w), _t(r), u=u, n_real=nr)
    assert tx_t.dtype == torch.bool and tuple(tx_t.shape) == (N, S)
    np.testing.assert_array_equal(tx_t.numpy(), np.asarray(tx_j))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-5,
                               rtol=0)
    if codec == "none":
        assert torch.equal(w_t, _t(w))
    if padded:   # padding stays zero, and top-k never keeps it
        assert bool((w_t[:, nr:] == 0).all())
        if codec == "topk":
            assert not tx_t[:, nr:].any()


def test_topk_ties_break_toward_the_lower_index():
    w = np.zeros((2, 5, 4), np.float32)
    w[0, [1, 3]] = 1.0              # a tie between segments 1 and 3
    w[1] = 2.0                      # every segment ties
    got = compression.topk_transmit_mask(_t(w), 0.2).numpy()
    want = np.asarray(jcomp.topk_transmit_mask(jnp.asarray(w), 0.2))
    np.testing.assert_array_equal(got, want)
    assert got[0].tolist() == [False, True, False, False, False]
    assert got[1].tolist() == [True, False, False, False, False]


@pytest.mark.parametrize("ratio", [1 / 32, 0.25, 0.5, 1.0])
def test_stochastic_quantize_matches_reference_at_every_width(ratio):
    w = _rows(2)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jcomp.stochastic_quantize(jnp.asarray(w), ratio, key))
    u = _t(jax.random.uniform(key, (N, S, K)))
    got = compression.stochastic_quantize(_t(w), ratio, u=u).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[0, 2] == 0).all()
    with pytest.raises(ValueError, match="quantizer uniforms"):
        compression.stochastic_quantize(_t(w), ratio, u=u[:, :-1])
    # Its own draws: every value within one step of the input, plus the
    # float32 rounding of the rescale (two ulps of the segment's scale).
    g = torch.Generator().manual_seed(0)
    own = compression.stochastic_quantize(_t(w), ratio, generator=g)
    bits = int(compression.quant_bits(ratio))
    scale = np.abs(w).max(axis=2, keepdims=True)
    step = scale / (2.0 ** bits - 1) + 2 * np.spacing(scale)
    assert (np.abs(own.numpy() - w) <= step).all()


def test_bits_fraction_and_host_factor_match_reference():
    for codec, cid in compression.CODEC_IDS.items():
        for r in (0.05, 0.3, 0.5, 1.0):
            got = float(compression.bits_fraction(cid, r, 412))
            want = float(jcomp.bits_fraction(jnp.asarray(cid), r, 412))
            assert got == want
            assert compression.host_factor(codec, r, n_segments=412) == \
                jcomp.host_factor(codec, r, n_segments=412)
    for bad, match in ((("zip", 0.5), "unknown codec"),
                       (("quant", 0.0), "compress_ratio")):
        with pytest.raises(ValueError, match=match):
            compression.host_factor(*bad)
    with pytest.raises(ValueError, match="n_segments"):
        compression.host_factor("topk", 0.5)


@pytest.mark.parametrize("density", [0.3, 0.8])
def test_bias_matrix_and_sq_norm_match_reference(density):
    rng = np.random.default_rng(4)
    p = (rng.random(N) + 0.1).astype(np.float32)
    p /= p.sum()
    e = rng.random((N, N, 7)) < density
    e |= np.eye(N, dtype=bool)[:, :, None]
    lam = aggregation.bias_matrix(_t(p), _t(e))
    assert tuple(lam.shape) == (7, N, N)
    np.testing.assert_allclose(
        lam.numpy(), np.asarray(jagg.bias_matrix(jnp.asarray(p),
                                                 jnp.asarray(e))),
        atol=1e-6)
    sq = aggregation.bias_sq_norm(_t(p), _t(e))
    np.testing.assert_allclose(
        sq.numpy(), np.asarray(jagg.bias_sq_norm(jnp.asarray(p),
                                                 jnp.asarray(e))),
        atol=1e-6)
    np.testing.assert_allclose(
        sq.numpy(), aggregation.bias_sq_norm_fused(_t(p), _t(e)).numpy(),
        atol=1e-6)


def _table2():
    net = jtopology.make_network(jtopology.TABLE_II_COORDS,
                                 packet_len_bits=100_000, tx_power_dbm=17.0)
    rho, nxt = jrouting.e2e_success(net.link_eps)
    p = np.random.default_rng(5).random(10).astype(np.float32) + 0.1
    return net, np.array(rho), np.array(nxt), p / p.sum()


def test_convergence_bounds_match_reference():
    _net, rho, _nxt, p = _table2()
    c = convergence.Smoothness(L=1.0, mu=0.5, eta=0.1, I=5)
    jc = jconv.Smoothness(L=1.0, mu=0.5, eta=0.1, I=5)
    assert convergence.zetas(c) == jconv.zetas(jc)
    for fn in ("routing_objective", "lambda_bound"):
        got = float(getattr(convergence, fn)(_t(p), _t(rho)))
        want = float(getattr(jconv, fn)(jnp.asarray(p), jnp.asarray(rho)))
        np.testing.assert_allclose(got, want, rtol=1e-5)
    got = float(convergence.theorem1_gap(c, _t(p), _t(rho), 2.0, 0.5, 3.0))
    want = float(jconv.theorem1_gap(jc, jnp.asarray(p), jnp.asarray(rho),
                                    2.0, 0.5, 3.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got = float(convergence.theorem2_gap(c, _t(p), _t(rho), 0.5, 3.0))
    want = float(jconv.theorem2_gap(jc, jnp.asarray(p), jnp.asarray(rho),
                                    0.5, 3.0))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(AssertionError, match="eta < 1/"):
        convergence.Smoothness(L=10.0, mu=0.1, eta=0.1, I=5)


def test_overhead_matches_reference():
    net, _rho, nxt, p = _table2()
    adj = np.asarray(net.adjacency)
    for got, want in (
        (overhead.ra_overhead(nxt, 10, 3.2), joverhead.ra_overhead(
            nxt, 10, 3.2)),
        (overhead.ra_overhead(nxt, 10, 3.2, sources=[2, 0, 5]),
         joverhead.ra_overhead(nxt, 10, 3.2, sources=[2, 0, 5])),
        (overhead.aayg_overhead(adj, 10, 3.2, 3),
         joverhead.aayg_overhead(adj, 10, 3.2, 3)),
        (overhead.cfl_overhead(nxt, 10, 3.2, 6),
         joverhead.cfl_overhead(nxt, 10, 3.2, 6)),
    ):
        assert (got.n_slots, got.n_transmissions) == (
            want.n_slots, want.n_transmissions)
        assert got.traffic_mbits == pytest.approx(want.traffic_mbits)
        f = compression.host_factor("topk", 0.3, n_segments=412)
        c_got, c_want = got.compressed(f), want.compressed(f)
        assert c_got.n_slots == c_want.n_slots
        assert c_got.traffic_mbits == pytest.approx(c_want.traffic_mbits)
    with pytest.raises(ValueError, match="compression factor"):
        overhead.Overhead(1, 1, 1.0).compressed(0.0)
    assert routing.all_routes(nxt, 10) == jrouting.all_routes(nxt, 10)
