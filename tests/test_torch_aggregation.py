"""PyTorch port vs the JAX reference: K1 (`ra_aggregate`) and aggregation.

K1's plain version (`repro_torch.kernels.ops.ra_aggregate` on CPU tensors)
is held against the reference's Pallas kernel run in interpret mode, over
both modes, with and without a transmit mask, rank 3 and rank 4, shared and
per-batch p / e / tx, bool / uint8 / float32 masks, float32 and bfloat16
segments and prime L.  Tolerances: 1e-5 absolute for float32 (the bound
tests/test_agg_substrate.py uses for the reference's own substrates), one
bfloat16 ulp for bfloat16 (the two round float32 sums that may differ in
the last float32 bits).  The CUDA kernel itself is held to the same plain
version by tests/test_torch_cuda.py and chip_smoke.py, on the card.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import bf16_ulps  # noqa: E402
from repro.core import aggregation as jagg  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import aggregation  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ra_aggregate as ra  # noqa: E402

MODES = ("ra_normalized", "substitution")


def _case(seed, *, b=None, n=5, l=13, k=24, shared_p=False, shared_e=False,
          shared_tx=False, e_dtype="bool", w_dtype="float32", with_tx=False):
    """numpy inputs for one call; rank 4 when ``b`` is given."""
    rng = np.random.default_rng(seed)
    lead = () if b is None else (b,)
    w = rng.normal(size=lead + (n, l, k)).astype(np.float32)
    p = rng.random((n,) if (b is None or shared_p) else (b, n)) + 0.1
    p = (p / p.sum(-1, keepdims=True)).astype(np.float32)
    e = rng.random((n, n, l) if (b is None or shared_e) else (b, n, n, l))
    e = (e < 0.6).astype(e_dtype)
    tx = None
    if with_tx:
        tx = rng.random((n, l) if (b is None or shared_tx) else (b, n, l))
        tx = (tx < 0.5).astype(e_dtype)
    return w, p, e, tx, w_dtype


VARIANTS = {
    "rank3_bool_f32_primeL": dict(l=13),
    "rank4_perbatch_uint8_f32": dict(b=3, l=7, e_dtype="uint8"),
    "rank4_shared_f32mask": dict(b=2, l=11, shared_p=True, shared_e=True,
                                 shared_tx=True, e_dtype="float32"),
    "rank3_bool_bf16": dict(l=11, w_dtype="bfloat16"),
    "rank4_sharedmask_bool_bf16_primeL": dict(b=2, l=13, shared_e=True,
                                              w_dtype="bfloat16"),
}


def _jax_call(w, p, e, tx, w_dtype, mode):
    wj = jnp.asarray(w).astype(getattr(jnp, w_dtype))
    out = jops.ra_aggregate(wj, jnp.asarray(p), jnp.asarray(e),
                            tx=None if tx is None else jnp.asarray(tx),
                            mode=mode, interpret=True)
    return np.asarray(out.astype(jnp.float32))


def _torch_call(w, p, e, tx, w_dtype, mode, **kw):
    wt = torch.from_numpy(w).to(getattr(torch, w_dtype))
    out = ops.ra_aggregate(wt, torch.from_numpy(p), torch.from_numpy(e),
                           tx=None if tx is None else torch.from_numpy(tx),
                           mode=mode, device="cpu", **kw)
    assert out.dtype == wt.dtype and out.shape == wt.shape
    return out.to(torch.float32).numpy()


@pytest.mark.parametrize("with_tx", [False, True], ids=["no_tx", "tx"])
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_k1_plain_matches_pallas_interpret(variant, mode, with_tx):
    seed = sorted(VARIANTS).index(variant) * 4 + MODES.index(mode) * 2 + with_tx
    w, p, e, tx, w_dtype = _case(seed, with_tx=with_tx, **VARIANTS[variant])
    want = _jax_call(w, p, e, tx, w_dtype, mode)
    got = _torch_call(w, p, e, tx, w_dtype, mode)
    if w_dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    else:
        assert bf16_ulps(got, want) <= 1.0


@pytest.mark.parametrize("bad", [
    dict(w=(3, 4, 5), p=(4,), e=(3, 3, 4)),
    dict(w=(3, 4, 5), p=(3,), e=(3, 3, 5)),
    dict(w=(3, 4, 5), p=(3,), e=(3, 3, 4), tx=(3, 5)),
    dict(w=(2, 3, 4, 5), p=(2, 4), e=(3, 3, 4)),
    dict(w=(2, 3, 4, 5), p=(3,), e=(2, 3, 3, 5)),
    dict(w=(2, 3, 4, 5), p=(3,), e=(3, 3, 4), tx=(2, 3, 5)),
])
def test_k1_shape_errors_match_reference(bad):
    shapes = {k: v for k, v in bad.items()}
    mk_j = {k: jnp.zeros(v, jnp.float32) for k, v in shapes.items()}
    mk_t = {k: torch.zeros(v) for k, v in shapes.items()}
    with pytest.raises(ValueError) as ej:
        jops.ra_aggregate(mk_j["w"], mk_j["p"], mk_j["e"], tx=mk_j.get("tx"),
                          interpret=True)
    with pytest.raises(ValueError) as et:
        ops.ra_aggregate(mk_t["w"], mk_t["p"], mk_t["e"], tx=mk_t.get("tx"),
                         device="cpu")
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError, match="mode must be one of"):
        ops.ra_aggregate(mk_t["w"], mk_t["p"], mk_t["e"], mode="mean",
                         device="cpu")


def test_k1_broadcast_batch_keeps_shared_inputs_unbatched():
    w = torch.zeros(3, 4, 5, 6)
    w4, p2, e4, tx3 = ra.broadcast_batch(
        w, torch.ones(4), torch.ones(4, 4, 5, dtype=torch.bool),
        torch.ones(4, 5, dtype=torch.uint8), mode="substitution")
    assert w4.data_ptr() == w.data_ptr()
    assert (p2.stride(0), e4.stride(0), tx3.stride(0)) == (0, 0, 0)
    assert ra._batch_stride(e4, "e") == 0
    per = torch.ones(3, 4, 4, 5, dtype=torch.bool)
    assert ra._batch_stride(per, "e") == 80
    with pytest.raises(ValueError, match="contiguous"):
        ra._batch_stride(per.transpose(2, 3), "e")


def test_k1_device_rule(monkeypatch):
    w, p, e, _, _ = _case(0)
    args = (torch.from_numpy(w), torch.from_numpy(p), torch.from_numpy(e))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ops.ra_aggregate(*args)
    before = ops.LAUNCHES["ra_aggregate"]
    out = ops.ra_aggregate(*args, device="cpu")
    assert ops.LAUNCHES["ra_aggregate"] == before   # the plain version
    torch.testing.assert_close(out, ref.ra_aggregate_ref(*args))
    with pytest.raises(ValueError, match="is on meta"):
        ops.ra_aggregate(args[0].to("meta"), *args[1:], device="cpu")
    # The launch path takes CUDA tensors only: it raises before any build.
    with pytest.raises(ValueError, match="CUDA"):
        ra.launch(None, args[0][None], args[1][None], args[2][None], None,
                  mode="ra_normalized")


# ---------------------------------------------------------------------------
# core/aggregation.py against the reference's jnp functions.
# ---------------------------------------------------------------------------
def _agg_inputs(seed, n=6, l=9, k=7, density=0.6):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, l, k)).astype(np.float32)
    p = rng.random(n).astype(np.float32) + 0.05
    p /= p.sum()
    e = (rng.random((n, n, l)) < density) | np.eye(n, dtype=bool)[:, :, None]
    part = (rng.random(n) < 0.6).astype(np.float32)
    tx = rng.random((n, l)) < 0.5
    return w, p, e, part, tx


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("fn", ["ra_normalized", "substitution", "ideal",
                                "aggregation_coefficients"])
def test_aggregators_match_reference(fn):
    w, p, e, part, _ = _agg_inputs(1)
    ef = e.astype(np.float32)
    if fn == "aggregation_coefficients":
        want = jagg.aggregation_coefficients(*_j(p, e))
        got = aggregation.aggregation_coefficients(*_t(p, e))
    else:
        want = getattr(jagg, fn)(*_j(w, p, ef))
        got = getattr(aggregation, fn)(*_t(w, p, ef))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if fn == "ideal":
        want = jagg.ideal(*_j(w, p), participation=jnp.asarray(part))
        got = aggregation.ideal(*_t(w, p), participation=_t(part)[0])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("as_float", [False, True], ids=["bool", "float32"])
def test_masks_match_reference_exactly(as_float):
    w, p, e, part, tx = _agg_inputs(2, density=0.4)
    e_in = e.astype(np.float32) if as_float else e
    tx_in = tx.astype(np.float32) if as_float else tx
    pairs = [
        (jagg.mask_senders(*_j(e_in, part)),
         aggregation.mask_senders(*_t(e_in, part))),
        (jagg.apply_transmit_mask(*_j(e_in, tx_in)),
         aggregation.apply_transmit_mask(*_t(e_in, tx_in))),
        (jagg.keep_nonparticipants(*_j(part, w * 2, w)),
         aggregation.keep_nonparticipants(*_t(part, w * 2, w))),
    ]
    for want, got in pairs:
        assert got.dtype == getattr(torch, str(np.asarray(want).dtype))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("density", [0.0, 0.3, 0.9])
def test_bias_sq_norm_fused_matches_reference(density):
    _, p, e, _, _ = _agg_inputs(3, n=8, l=21, density=density)
    want = np.asarray(jagg.bias_sq_norm_fused(*_j(p, e)))
    got = aggregation.bias_sq_norm_fused(*_t(p, e)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("impl", ["torch", "kernel", "auto"])
@pytest.mark.parametrize("mode", MODES)
def test_apply_mode_substrates_match_reference(impl, mode):
    w, p, e, _, tx = _agg_inputs(4)
    mid = aggregation.MODE_IDS[mode]
    for t in (None, tx):
        want = jagg.apply_mode(jnp.asarray(mid, jnp.int32), *_j(w, p, e),
                               tx=None if t is None else jnp.asarray(t),
                               impl="jnp")
        got = aggregation.apply_mode(mid, *_t(w, p, e),
                                     tx=None if t is None else _t(t)[0],
                                     impl=impl)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    with pytest.raises(ValueError, match="agg_impl"):
        aggregation.apply_mode(mid, *_t(w, p, e), impl="pallas")


@pytest.mark.parametrize("name", ["ra_normalized", "substitution", "ideal"])
def test_aggregators_table_matches_reference(name):
    """`AGGREGATORS` has the reference's names, each the same rule; with an
    error-free mask every mechanism is the ideal aggregate."""
    assert sorted(aggregation.AGGREGATORS) == sorted(jagg.AGGREGATORS)
    w, p, e, _part, _ = _agg_inputs(5)
    ef = e.astype(np.float32)
    got = aggregation.AGGREGATORS[name](*_t(w, p, ef))
    want = jagg.AGGREGATORS[name](*_j(w, p, ef))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    ones = np.ones_like(ef)
    np.testing.assert_allclose(
        aggregation.AGGREGATORS[name](*_t(w, p, ones)).numpy(),
        aggregation.ideal(*_t(w, p)).numpy(), atol=1e-5)


@pytest.mark.parametrize("value,impl", [(None, "auto"), ("auto", "auto"),
                                        ("jnp", "torch"),
                                        ("pallas", "kernel"),
                                        ("torch", "torch"),
                                        ("kernel", "kernel")])
def test_default_impl_reads_repro_agg_impl(monkeypatch, value, impl):
    """``REPRO_AGG_IMPL`` (the reference's names mapped onto the port's)
    sets what ``impl=None`` means; ``auto`` resolves by device."""
    if value is None:
        monkeypatch.delenv("REPRO_AGG_IMPL", raising=False)
    else:
        monkeypatch.setenv("REPRO_AGG_IMPL", value)
    assert aggregation.default_impl() == impl
    assert aggregation.resolve_impl(None) == impl
    assert aggregation.resolve_impl("torch") == "torch"   # explicit wins
    concrete = {"auto": "torch"}.get(impl, impl)
    assert aggregation.resolve_impl(None, torch.device("cpu")) == concrete
    if impl == "auto":
        assert aggregation.resolve_impl(None, "cuda") == "kernel"
    # impl=None takes the variable's substrate: the kernel's plain twin
    # under "pallas", einsum otherwise (same values, 1e-5).
    w, p, e, _, _ = _agg_inputs(6)
    calls = []
    real = ops.ra_aggregate
    monkeypatch.setattr(ops, "ra_aggregate",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = aggregation.apply_mode(0, *_t(w, p, e), impl=None)
    assert bool(calls) == (impl == "kernel")
    want = jagg.apply_mode(jnp.asarray(0, jnp.int32), *_j(w, p, e),
                           impl="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_unknown_repro_agg_impl_raises(monkeypatch):
    monkeypatch.setenv("REPRO_AGG_IMPL", "cuda")
    with pytest.raises(ValueError, match="REPRO_AGG_IMPL='cuda'"):
        aggregation.default_impl()
    with pytest.raises(ValueError, match="REPRO_AGG_IMPL"):
        aggregation.resolve_impl(None)
    with pytest.raises(ValueError, match="agg_impl must be one of"):
        aggregation.resolve_impl("jnp")     # arguments take the port's names
