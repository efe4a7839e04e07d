"""PyTorch port vs the JAX reference: the sliding window and the training
attentions.

  * K2's plain version with a window against the reference's masked
    `_sdpa`; a window of S or more gives what no window gives, bit for bit;
  * `_sdpa_chunked` (a chunk that does not divide S, with and without a
    window), `attention(attn_mask=)` and `attention(impl="chunked" /
    "flash")` against the reference's;
  * `models.flash`: values and gradients against `jax.grad` of the
    reference's `custom_vjp`, with a window;
  * `train_step` under ``attn_impl`` chunked and flash;
  * the windowed `forward` / `prefill` / `serve_step`, the wrapped decode
    cache past its wrap (RoPE at ``abs_pos``, ``full_cache``), one step at
    long_500k's last position, and `launch.serve` with ``window``.

Weights come from the reference's init through `interop`; inputs are drawn
with numpy.  Tolerances: 1e-5 in float32 (absolute and relative; sums in
another order), greedy ids equal.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
from repro.configs import base as jbase  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import flash, layers, registry, transformer  # noqa: E402,E501

TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.array(x.detach().float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


def _tree(jtree):
    return interop.params_from_jax(jax.tree.map(np.asarray, jtree))


def _qkv(seed, b, s, h, kv, d):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, n, d)).astype(np.float32)
            for n in (h, kv, kv)]


def _ref_mask(s, causal, window):
    idx = np.arange(s)
    mask = np.ones((s, s), bool)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    return mask


# ---------------------------------------------------------------------------
# K2's plain version with a window
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("window", [1, 5, 33, 100])
@pytest.mark.parametrize("shape", [(2, 70, 4, 2, 32), (1, 40, 2, 2, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_plain_window_matches_reference_masked_sdpa(shape, window, causal):
    b, s, h, kv, d = shape
    arrays = _qkv(window + s, *shape)
    scale = d ** -0.5
    mask = np.broadcast_to(_ref_mask(s, causal, window)[None], (b, s, s))
    want = jL._sdpa(*(jnp.asarray(a) for a in arrays), jnp.asarray(mask),
                    scale=scale)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = ops.flash_attention(q, k, v, scale=scale, causal=causal,
                              window=window, device="cpu")
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=0)
    assert torch.equal(got, ref.flash_attention_ref(
        q, k, v, scale=scale, causal=causal, window=window))
    if window >= s:     # a window of S or more masks nothing
        assert torch.equal(got, ref.flash_attention_ref(
            q, k, v, scale=scale, causal=causal))


# ---------------------------------------------------------------------------
# _sdpa_chunked, attention(attn_mask=), the chunked and flash impls
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window", [None, 9])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("chunk", [16, 7, 100])
def test_sdpa_chunked_matches_reference(chunk, causal, window):
    """S = 42: chunk 16 lowers to 14 (the largest divisor), 7 divides it,
    100 caps at S."""
    arrays = _qkv(chunk, 2, 42, 6, 2, 16)
    kw = dict(scale=0.3, causal=causal, window=window, chunk=chunk)
    want = jL._sdpa_chunked(*(jnp.asarray(a) for a in arrays), **kw)
    got = layers._sdpa_chunked(*(torch.from_numpy(a) for a in arrays), **kw)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    assert flash.chunk_size(42, chunk) == {16: 14, 7: 7, 100: 42}[chunk]


def _attn(seed, window=None, causal=True):
    kw = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
              qkv_bias=True, rope_theta=1e4, causal=causal,
              sliding_window=window)
    jcfg, cfg = jL.AttnCfg(**kw), layers.AttnCfg(**kw)
    jp = jL.init_attention(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    for name in ("bq", "bk", "bv"):
        jp[name] = jnp.asarray(rng.normal(size=jp[name].shape).astype(
            np.float32) * 0.5)
    x = rng.normal(size=(2, 30, 64)).astype(np.float32)
    return jcfg, cfg, jp, _tree(jp), x


@pytest.mark.parametrize("impl", ["naive", "chunked", "flash", "auto"])
def test_attention_with_attn_mask_matches_reference(impl):
    """A given mask is composed with the causal / window mask and always
    takes the masked `_sdpa`, whatever the impl."""
    jcfg, cfg, jp, tp, x = _attn(1, window=11)
    attn_mask = np.random.default_rng(2).random((2, 30, 30)) < 0.7
    attn_mask[:, np.arange(30), np.arange(30)] = True   # every row sees itself
    want = jL.attention(jp, jcfg, jnp.asarray(x),
                        attn_mask=jnp.asarray(attn_mask),
                        impl=impl if impl != "auto" else "naive")
    got = layers.attention(tp, cfg, torch.from_numpy(x),
                           attn_mask=torch.from_numpy(attn_mask), impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("impl", ["naive", "chunked", "flash"])
@pytest.mark.parametrize("window", [None, 6])
def test_attention_impls_match_reference(window, impl, causal):
    jcfg, cfg, jp, tp, x = _attn(3, window=window, causal=causal)
    want = jL.attention(jp, jcfg, jnp.asarray(x), impl=impl, chunk=8)
    got = layers.attention(tp, cfg, torch.from_numpy(x), impl=impl, chunk=8)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# models/flash: values and gradients against the reference's custom_vjp
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("causal,window,chunk", [(True, None, 16),
                                                 (True, 10, 12),
                                                 (False, 7, 16),
                                                 (False, None, 48)])
def test_flash_values_and_gradients_match_reference(causal, window, chunk):
    arrays = _qkv(11, 2, 48, 4, 2, 16)
    dout = np.random.default_rng(12).normal(size=(2, 48, 4, 16)).astype(
        np.float32)
    scale = 0.25

    def jloss(q, k, v):
        out = jflash.flash_attention(q, k, v, scale, causal, window, chunk)
        return jnp.sum(out * jnp.asarray(dout)), out

    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        *(jnp.asarray(a) for a in arrays))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    out = flash.flash_attention(q, k, v, scale, causal, window, chunk)
    grads = torch.autograd.grad((out * torch.from_numpy(dout)).sum(),
                                (q, k, v))
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=2e-5)
    # The same gradient as autograd through the block scan, which saves
    # every block's probabilities instead of recomputing them.
    again = torch.autograd.grad(
        (flash.block_scan(q, k, v, scale, causal, window, chunk)[0]
         * torch.from_numpy(dout)).sum(), (q, k, v))
    for a, b in zip(grads, again):
        np.testing.assert_allclose(_np(a), _np(b), atol=2e-5, rtol=2e-5)


def test_flash_runs_under_torch_func_grad():
    """The simulator differentiates with `torch.func`: the function's
    generated vmap rule and setup_context form let it."""
    arrays = [torch.from_numpy(a) for a in _qkv(13, 1, 24, 2, 2, 8)]

    def loss(q):
        return flash.flash_attention(q, *arrays[1:], 0.3, True, 5, 8).sum()

    got = torch.func.grad(loss)(arrays[0])
    q = arrays[0].clone().requires_grad_()
    want, = torch.autograd.grad(loss(q), q)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)
    batched = torch.func.vmap(torch.func.grad(loss))(
        torch.stack([arrays[0], 2 * arrays[0]]))
    np.testing.assert_allclose(_np(batched[0]), _np(want), atol=1e-6)


# ---------------------------------------------------------------------------
# Training under attn_impl chunked and flash
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _smoke(arch, **kw):
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get(arch)), **kw)
    cfg = dataclasses.replace(base.smoke_variant(base.get(arch)), **kw)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, _tree(jparams)


@pytest.mark.parametrize("attn_impl", ["chunked", "flash"])
def test_train_step_under_chunked_and_flash_matches_reference(attn_impl):
    """Loss and gradient within 1e-5 of the reference's, one SGD step
    within 1e-4, on the float32 smoke llama3 with 24-token chunks of a
    40-token sequence (chunk 24 lowers to 20) and a window of 13."""
    jcfg, cfg, jparams, tparams = _smoke("llama3-8b", attn_impl=attn_impl,
                                         attn_chunk=24)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab,
                                               size=(2, 40)).astype(np.int32)
    jb = jregistry.build(jcfg, optimizer="sgd", lr=0.5)
    (jtotal, _), jgrad = jax.value_and_grad(
        lambda p: jb.loss_fn(p, {"tokens": jnp.asarray(tokens)}, window=13),
        has_aux=True)(jparams)
    b = registry.build(cfg, optimizer="sgd", lr=0.5)
    params = {k: v.clone().requires_grad_() for k, v in tparams.items()}
    total, _ = b.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                         window=13, device="cpu")
    grads = torch.autograd.grad(total, list(params.values()))
    np.testing.assert_allclose(float(total.detach()), float(jtotal), **TOL)
    for (name, want), got in zip(_tree(jgrad).items(), grads):
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    jstate, _ = jb.train_step({"params": jparams,
                               "opt": jb.optimizer.init(jparams)},
                              {"tokens": jnp.asarray(tokens)}, window=13)
    state = {"params": {k: v.clone() for k, v in tparams.items()}}
    state["opt"] = b.optimizer.init(state["params"])
    state, m = b.train_step(state, {"tokens": torch.from_numpy(tokens)},
                            window=13, device="cpu")
    np.testing.assert_allclose(float(m["loss"]), float(jtotal), **TOL)
    for name, want in _tree(jstate["params"]).items():
        np.testing.assert_allclose(_np(state["params"][name]), _np(want),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# The windowed model, and the wrapped decode cache
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-7b"])
def test_windowed_forward_prefill_and_decode_match_reference(arch):
    jcfg, cfg, jparams, tparams = _smoke(arch)
    w, s, gen = 10, 36, 5
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, s))
    jtok = jnp.asarray(tokens, jnp.int32)
    want, _ = jT.forward(jparams, jcfg, jtok, window=w)
    for impl in ("torch", "kernel", "chunked", "flash"):
        with torch.no_grad():
            got, _ = transformer.forward(tparams, cfg,
                                         torch.from_numpy(tokens),
                                         impl=impl, window=w)
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
    jlogits, jcache = jT.prefill(jparams, jcfg, jtok, window=w)
    for impl in ("torch", "kernel"):
        logits, cache = transformer.prefill(tparams, cfg,
                                            torch.from_numpy(tokens),
                                            window=w, impl=impl)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
    cache = serve.grow_cache(cache, s + gen)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, gen), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    for i in range(gen):
        tok = np.argmax(_np(logits).reshape(2, -1), -1)[:, None]
        assert np.array_equal(tok, np.argmax(_np(jlogits).reshape(2, -1),
                                             -1)[:, None])
        jlogits, jcache = jT.serve_step(jparams, jcfg, jcache,
                                        jnp.asarray(tok, jnp.int32),
                                        jnp.int32(s + i), window=w)
        logits, cache = transformer.serve_step(tparams, cfg, cache,
                                               torch.from_numpy(tok), s + i,
                                               window=w)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)


def test_chunked_prefill_runs_the_reference_chunked_attention():
    """Under attn_impl="chunked" the reference's prefill runs
    `_sdpa_chunked`; so do the port's "torch" and CPU "auto" prefills."""
    jcfg, cfg, jparams, tparams = _smoke("llama3-8b", attn_impl="chunked",
                                         attn_chunk=8)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 30))
    jlogits, jcache = jT.prefill(jparams, jcfg,
                                 jnp.asarray(tokens, jnp.int32), window=7)
    calls = []
    chunked = layers._sdpa_chunked

    def counted(*args, **kw):
        calls.append(kw["chunk"])
        return chunked(*args, **kw)

    layers._sdpa_chunked = counted
    try:
        for impl in ("auto", "torch"):
            logits, cache = transformer.prefill(
                tparams, cfg, torch.from_numpy(tokens), window=7, impl=impl)
            np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
            np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]),
                                       **TOL)
    finally:
        layers._sdpa_chunked = chunked
    assert calls == [8] * (2 * cfg.n_layers)


def test_wrapped_cache_past_the_wrap_matches_reference():
    """A W = 8 slot cache wrapped three times over 2W + 8 steps from an
    empty cache, against the reference's `serve_step` on the same tokens
    (pos = abs % W, abs_pos = abs, full_cache from abs = W on) and against
    the port's unwrapped windowed decode; the write at pos % W stays in
    place."""
    jcfg, cfg, jparams, tparams = _smoke("starcoder2-3b")
    w, n, b = 8, 24, 2
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, size=(b, n))
    jb, tb = jregistry.build(jcfg), registry.build(cfg)
    jcache = jb.init_cache(b, w, window=w)
    cache = tb.init_cache(b, 64, window=w, device="cpu")
    flat = tb.init_cache(b, n, device="cpu")
    assert tuple(cache["k"].shape) == tuple(jcache["k"].shape) == \
        (cfg.n_layers, b, w, cfg.n_kv_heads, cfg.hd)
    k_tensor = cache["k"]
    jstep = jax.jit(lambda p, c, t, pos, a, full: jb.serve_step(
        p, c, t, pos, window=w, abs_pos=a, full_cache=full),
        static_argnums=5)
    for i in range(n):
        tok = tokens[:, i:i + 1]
        want, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32),
                             jnp.int32(i % w), jnp.int32(i), i >= w)
        got, cache = tb.serve_step(tparams, cache, torch.from_numpy(tok),
                                   i % w, window=w, abs_pos=i,
                                   full_cache=i >= w, device="cpu")
        np.testing.assert_allclose(_np(got), _np(want), **TOL,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(_np(cache["k"]), _np(jcache["k"]), **TOL)
        # The unwrapped windowed decode: a cache of n slots, the window mask.
        unwrapped, flat = tb.serve_step(tparams, flat, torch.from_numpy(tok),
                                        i, window=w, device="cpu")
        np.testing.assert_allclose(_np(unwrapped), _np(got), **TOL)
    assert cache["k"] is k_tensor


def _reference_step_eager(jparams, jcfg, cache, tok, pos, w, abs_pos):
    """The reference's dense `serve_step` body (`transformer.py:576-588`)
    layer by layer in eager JAX, full cache: compiled (its layer scan),
    XLA on the CPU takes sin and cos of RoPE's angles near 5e5 rad to
    about 3e-2, where eager ops are within 2e-7 of float64."""
    x = jL.embed(jparams["embed"], tok).astype(jcfg.dtype)
    acfg = jcfg.attn_cfg(window=w)
    keys = []
    for i in range(jcfg.n_layers):
        lp = jax.tree.map(lambda a, i=i: a[i], jparams["layers"])
        a, new = jL.decode_attention(
            lp["attn"], acfg, jL.rmsnorm(lp["ln1"], x),
            {"k": cache["k"][i], "v": cache["v"][i]}, pos, rope_pos=abs_pos,
            full_cache=True)
        x = x + a
        x = x + jL.mlp(lp["mlp"], jL.rmsnorm(lp["ln2"], x), jcfg.act)
        keys.append(new["k"])
    x = jL.rmsnorm(jparams["final_norm"], x)
    return jL.unembed(jparams["embed"], x), jnp.stack(keys)


def test_wrapped_step_at_long_500k_holds_float32_rope():
    """One step at long_500k's last position (abs_pos = 524,287) against a
    full wrapped cache, held to the reference's layers run eagerly (see
    `_reference_step_eager`); RoPE there within 1e-6 of float64."""
    jcfg, cfg, jparams, tparams = _smoke("llama3-8b")
    w = 16
    abs_pos = base.INPUT_SHAPES["long_500k"].seq_len - 1
    shape = (cfg.n_layers, 1, w, cfg.n_kv_heads, cfg.hd)
    rng = np.random.default_rng(5)
    kc, vc = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    tok = rng.integers(0, cfg.vocab, size=(1, 1))
    want, want_k = _reference_step_eager(
        jparams, jcfg, {"k": jnp.asarray(kc), "v": jnp.asarray(vc)},
        jnp.asarray(tok, jnp.int32), jnp.int32(abs_pos % w), w,
        jnp.int32(abs_pos))
    cache = {"k": torch.from_numpy(kc.copy()), "v": torch.from_numpy(vc.copy())}
    got, _ = transformer.serve_step(tparams, cfg, cache, torch.from_numpy(tok),
                                    abs_pos % w, window=w, abs_pos=abs_pos,
                                    full_cache=True)
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    np.testing.assert_allclose(_np(cache["k"]), _np(want_k), **TOL)
    # RoPE alone at that position, every frequency of a 256-wide head,
    # against float64 (the frequencies are bit-equal to the reference's).
    x = rng.normal(size=(1, 1, 2, 256)).astype(np.float32)
    for theta in (1e4, 5e5):
        freqs = layers.rope_freqs(256, theta)
        assert np.array_equal(freqs.numpy(), np.asarray(jL.rope_freqs(256,
                                                                      theta)))
        ang = (np.float32(abs_pos) * freqs.numpy()).astype(np.float64)
        x1, x2 = x[..., :128].astype(np.float64), x[..., 128:]
        exact = np.concatenate([x1 * np.cos(ang) - x2 * np.sin(ang),
                                x1 * np.sin(ang) + x2 * np.cos(ang)], -1)
        got = layers.apply_rope(torch.from_numpy(x),
                                torch.full((1, 1), abs_pos), theta)
        np.testing.assert_allclose(_np(got), exact, atol=1e-6, rtol=0)


def test_decode_attention_rope_pos_and_full_cache_match_reference():
    jcfg, cfg, jp, tp, _ = _attn(7, window=6)
    rng = np.random.default_rng(7)
    kc, vc = (rng.normal(size=(2, 6, 2, 16)).astype(np.float32)
              for _ in range(2))
    for pos, rope_pos, full in ((3, None, False), (3, 9, True),
                                (0, 524_286, True), (5, 5, False)):
        x = rng.normal(size=(2, 1, 64)).astype(np.float32)
        want, jnew = jL.decode_attention(
            jp, jcfg, jnp.asarray(x), {"k": jnp.asarray(kc),
                                       "v": jnp.asarray(vc)}, jnp.int32(pos),
            rope_pos=None if rope_pos is None else jnp.int32(rope_pos),
            full_cache=full)
        cache = {"k": torch.from_numpy(kc.copy()),
                 "v": torch.from_numpy(vc.copy())}
        got, new = layers.decode_attention(tp, cfg, torch.from_numpy(x),
                                           cache, pos, rope_pos=rope_pos,
                                           full_cache=full)
        assert new["k"] is cache["k"]
        np.testing.assert_allclose(_np(got), _np(want), **TOL)
        np.testing.assert_allclose(_np(new["k"]), _np(jnew["k"]), **TOL)


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma-7b"])
def test_serve_with_window_matches_reference_loop(arch):
    """`serve(window=)` against the reference's `main` loop with
    ``--window``: a windowed prefill, caches grown to prompt + gen, decode
    under the window mask; the same ids."""
    jcfg, cfg, jparams, tparams = _smoke(arch)
    w, gen = 9, 8
    tokens = np.random.default_rng(10).integers(0, cfg.vocab, size=(2, 20))
    jb = jregistry.build(jcfg)
    logits, cache = jb.prefill_step(jparams,
                                    {"tokens": jnp.asarray(tokens, jnp.int32)},
                                    window=w)
    cache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, gen), (0, 0), (0, 0)])
             for k, v in cache.items()}
    tok = jserve.first_token(logits)
    want = [tok]
    for i in range(gen - 1):
        logits, cache = jb.serve_step(jparams, cache, tok, jnp.int32(20 + i),
                                      window=w)
        tok = jserve.first_token(logits)
        want.append(tok)
    res = serve.serve(cfg, batch=2, prompt_len=20, gen=gen, window=w,
                      device="cpu", params=tparams,
                      tokens=torch.from_numpy(tokens))
    assert np.array_equal(res.tokens.numpy(),
                          np.asarray(jnp.concatenate(want, axis=1)))
