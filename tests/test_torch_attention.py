"""PyTorch port vs the JAX reference: the attention layers.

`apply_rope`, `_qkv` (with QKV bias), `_sdpa`, `attention` and
`decode_attention` of `repro_torch.models.layers` against
`repro.models.layers`, with the reference's weights (through `interop`) and
inputs drawn with numpy.  Tolerances: 1e-5 (absolute and relative) in
float32, where the two packages sum in other orders; in bfloat16 one
bfloat16 ulp plus 1e-5, since both round the same float32 math at the same
points and sums in another order may round apart by one ulp.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import bf16_ulps  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (d_model, heads, kv heads, head dim, bias, rope theta)
CFGS = {"gqa_bias": (64, 4, 2, 16, True, 1e6),
        "mha": (64, 2, 2, 32, False, 1e4),
        "mqa_bias": (96, 3, 1, 32, True, 5e5)}


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


def _close(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        assert bf16_ulps(got, want, atol=1e-5) <= 1.0


def _cfgs(name, **kw):
    d, h, kv, dh, bias, theta = CFGS[name]
    args = dict(d_model=d, n_heads=h, n_kv_heads=kv, head_dim=dh,
                qkv_bias=bias, rope_theta=theta, **kw)
    return jL.AttnCfg(**args), layers.AttnCfg(**args)


def _params(jcfg, jdt, seed=0):
    """Reference init, with the zero biases replaced by draws so that the
    bias path is exercised."""
    jp = jL.init_attention(jax.random.PRNGKey(seed), jcfg, jdt)
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        if name in jp:
            jp[name] = jnp.asarray(
                rng.normal(size=jp[name].shape).astype(np.float32) * 0.5
            ).astype(jdt)
    return jp, interop.params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_matches_reference(theta, dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 40, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 4096, size=(2, 40))
    got = layers.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(pos),
                            theta)
    assert got.dtype == tdt
    _close(got, jL.apply_rope(jnp.asarray(x).astype(jdt),
                              jnp.asarray(pos, jnp.int32), theta), dtype)
    np.testing.assert_array_equal(
        layers.rope_freqs(32, theta).numpy(), np.asarray(jL.rope_freqs(32, theta)))


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_qkv_with_bias_matches_reference(name, dtype):
    jdt, tdt = DT[dtype]
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, jdt)
    x = np.random.default_rng(1).normal(size=(2, 24, cfg.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(24), (2, 24))
    want = jL._qkv(jp, jcfg, jnp.asarray(x).astype(jdt),
                   jnp.asarray(pos, jnp.int32))
    got = layers._qkv(tp, cfg, torch.from_numpy(x).to(tdt),
                      torch.from_numpy(pos.copy()))
    for g, w in zip(got, want):
        assert g.dtype == tdt
        _close(g, w, dtype)


def test_init_attention_leaves_match_reference():
    for name in CFGS:
        jcfg, cfg = _cfgs(name)
        want = interop.params_from_jax(jax.tree.map(
            np.asarray, jL.init_attention(jax.random.PRNGKey(0), jcfg)))
        got = layers.init_attention(torch.Generator().manual_seed(0), cfg)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape and got[k].dtype == torch.float32
        for k in ("bq", "bk", "bv"):
            if k in got:
                assert not got[k].any()


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("kind", ["causal", "window", "none"])
def test_sdpa_matches_reference(kind, dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(2)
    b, s, t, h, kv, dh = 2, 12, 20, 4, 2, 16
    q = rng.normal(size=(b, s, h, dh)).astype(np.float32)
    k = rng.normal(size=(b, t, kv, dh)).astype(np.float32)
    v = rng.normal(size=(b, t, kv, dh)).astype(np.float32)
    if kind == "none":
        mask = None
    else:
        i, j = np.arange(s)[:, None] + (t - s), np.arange(t)[None]
        m = i >= j
        if kind == "window":
            m &= i - j < 5
        mask = np.broadcast_to(m, (b, s, t))
    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    targs = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    want = jL._sdpa(*jargs, None if mask is None else jnp.asarray(mask),
                    scale=dh ** -0.5)
    got = layers._sdpa(*targs, None if mask is None
                       else torch.from_numpy(mask.copy()), scale=dh ** -0.5)
    assert got.dtype == tdt
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_attention_matches_reference(name, dtype):
    jdt, tdt = DT[dtype]
    for causal, window in ((True, None), (False, None), (True, 7)):
        jcfg, cfg = _cfgs(name, causal=causal, sliding_window=window)
        jp, tp = _params(jcfg, jdt, seed=3)
        x = np.random.default_rng(3).normal(
            size=(2, 33, cfg.d_model)).astype(np.float32)
        want = jL.attention(jp, jcfg, jnp.asarray(x).astype(jdt))
        got = layers.attention(tp, cfg, torch.from_numpy(x).to(tdt),
                               impl="torch")
        _close(got, want, dtype)
        if window is None:     # "auto" on the CPU is the plain path
            assert torch.equal(layers.attention(
                tp, cfg, torch.from_numpy(x).to(tdt)), got)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_attention_kernel_impl_reaches_the_plain_k2(name, monkeypatch):
    """impl="kernel" on CPU tensors goes through `ops.flash_attention` to
    K2's plain version, which agrees with the reference's `_sdpa` path in
    float32 (both compute the logits and softmax in float32)."""
    calls = []
    plain = ref.flash_attention_ref

    def counted(*args, **kw):
        calls.append((kw["causal"], kw["window"]))
        return plain(*args, **kw)

    monkeypatch.setattr(ref, "flash_attention_ref", counted)
    for causal, window in ((True, None), (False, None), (True, 4),
                           (False, 9)):
        jcfg, cfg = _cfgs(name, causal=causal, sliding_window=window)
        jp, tp = _params(jcfg, jnp.float32, seed=4)
        x = np.random.default_rng(4).normal(
            size=(2, 48, cfg.d_model)).astype(np.float32)
        got = layers.attention(tp, cfg, torch.from_numpy(x), impl="kernel")
        _close(got, jL.attention(jp, jcfg, jnp.asarray(x)), "float32")
    # The window reaches K2's entry point (and so the kernel on the card).
    assert calls == [(True, None), (False, None), (True, 4), (False, 9)]
    with pytest.raises(ValueError, match="impl must be one of"):
        layers.attention(tp, cfg, torch.from_numpy(x), impl="pallas")


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("name", sorted(CFGS))
def test_decode_attention_matches_reference(name, dtype):
    jdt, tdt = DT[dtype]
    jcfg, cfg = _cfgs(name)
    jp, tp = _params(jcfg, jdt, seed=5)
    rng = np.random.default_rng(5)
    b, t = 3, 16
    kc = rng.normal(size=(b, t, cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    vc = rng.normal(size=kc.shape).astype(np.float32)
    jcache = {"k": jnp.asarray(kc).astype(jdt), "v": jnp.asarray(vc).astype(jdt)}
    for pos in (0, 9, t - 1):
        x = rng.normal(size=(b, 1, cfg.d_model)).astype(np.float32)
        # The port writes in place: give it its own copy of the cache.
        cache = {"k": torch.from_numpy(kc).to(tdt, copy=True),
                 "v": torch.from_numpy(vc).to(tdt, copy=True)}
        want, jnew = jL.decode_attention(jp, jcfg, jnp.asarray(x).astype(jdt),
                                         jcache, jnp.int32(pos))
        got, new = layers.decode_attention(tp, cfg, torch.from_numpy(x).to(tdt),
                                           cache, pos)
        assert new["k"] is cache["k"] and new["v"] is cache["v"]
        _close(got, want, dtype)
        for name_ in ("k", "v"):
            _close(new[name_], jnew[name_], dtype)
    with pytest.raises(IndexError, match="outside the cache"):
        layers.decode_attention(tp, cfg, torch.zeros(b, 1, cfg.d_model), cache, t)
    empty = layers.init_kv_cache(b, t, cfg, tdt)
    assert tuple(empty["k"].shape) == (b, t, cfg.n_kv_heads, cfg.head_dim)
    assert empty["v"].dtype == tdt and not empty["v"].any()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
