"""PyTorch port vs the JAX reference: layers, configs, interop and the smoke
rwkv6 and qwen2.5 models (prefill + decode).

Weights come from the reference's init and cross through
`repro_torch.interop`; token ids are drawn with numpy.  Tolerances:

  * layers in float32: 1e-5 (sums in another order); in bfloat16 the norms,
    the embedding and the unembedding within one bfloat16 ulp (both round
    the same float32 math once), the MLP within 3e-2 of its largest
    magnitude (two bfloat16 products whose sums may round apart);
  * the model in float32: logits and states within 1e-4, greedy ids equal;
    in bfloat16: logits within 3e-2 of the largest |logit| (every layer
    rounds activations to bfloat16, and the packages round in other
    places); the states' largest bfloat16-ulp distance is reported.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import bf16_ulps  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.models import layers as jL  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import layers, registry, transformer  # noqa: E402

DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
RWKV_LEAVES = [
    "embed.table", "final_norm.scale", "layers.ln1.scale", "layers.ln2.scale",
    "layers.mix.bonus_u", "layers.mix.decay_bias", "layers.mix.w_decay",
    "layers.mix.w_g", "layers.mix.w_k", "layers.mix.w_out", "layers.mix.w_r",
    "layers.mix.w_v", "layers.mlp.w_down", "layers.mlp.w_up",
]


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


def _tree(jtree):
    return interop.params_from_jax(jax.tree.map(np.asarray, jtree))


def _close(got, want, dtype, *, ulps=None, rel=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    elif ulps is not None:
        assert bf16_ulps(got, want, atol=1e-6) <= ulps
    else:
        assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DT))
def test_norms_match_reference(dtype):
    jdt, tdt = DT[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32) * 3
    scale = (1 + 0.1 * rng.normal(size=48)).astype(np.float32)
    bias = (0.1 * rng.normal(size=48)).astype(np.float32)
    jx, tx = jnp.asarray(x).astype(jdt), torch.from_numpy(x).to(tdt)
    jp = {"scale": jnp.asarray(scale).astype(jdt),
          "bias": jnp.asarray(bias).astype(jdt)}
    tp = _tree(jp)
    _close(layers.rmsnorm(tp, tx), jL.rmsnorm(jp, jx), dtype, ulps=1.0)
    _close(layers.layernorm(tp, tx), jL.layernorm(jp, jx), dtype, ulps=1.0)
    for init, jinit in ((layers.init_rmsnorm, jL.init_rmsnorm),
                        (layers.init_layernorm, jL.init_layernorm)):
        got, want = init(48, tdt), _tree(jinit(48, jdt))
        assert list(got) == list(want)
        for k in got:
            assert torch.equal(got[k], want[k])


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("act", layers.ACTS)
def test_mlp_matches_reference(act, dtype):
    jdt, tdt = DT[dtype]
    jp = jL.init_mlp(jax.random.PRNGKey(1), 64, 96, act, jdt)
    tp = _tree(jp)
    x = np.random.default_rng(1).normal(size=(2, 7, 64)).astype(np.float32)
    got = layers.mlp(tp, torch.from_numpy(x).to(tdt), act)
    assert got.dtype == tdt
    _close(got, jL.mlp(jp, jnp.asarray(x).astype(jdt), act), dtype, rel=3e-2)
    drawn = layers.init_mlp(torch.Generator().manual_seed(0), 64, 96, act, tdt)
    assert list(drawn) == list(tp)
    assert all(drawn[k].shape == tp[k].shape and drawn[k].dtype == tdt
               for k in tp)


@pytest.mark.parametrize("dtype", sorted(DT))
def test_embed_and_unembed_match_reference(dtype):
    jdt, tdt = DT[dtype]
    jp = jL.init_embedding(jax.random.PRNGKey(2), 97, 32, jdt)
    tp = _tree(jp)
    tokens = np.random.default_rng(2).integers(0, 97, size=(3, 6))
    got = layers.embed(tp, torch.from_numpy(tokens))
    want = jL.embed(jp, jnp.asarray(tokens))
    assert torch.equal(got.float(), torch.from_numpy(_np(want)))
    h = np.random.default_rng(3).normal(size=(3, 6, 32)).astype(np.float32)
    got = layers.unembed(tp, torch.from_numpy(h).to(tdt))
    assert got.dtype == torch.float32
    # Both take the bfloat16 values to float32 exactly and multiply there.
    np.testing.assert_allclose(
        _np(got), _np(jL.unembed(jp, jnp.asarray(h).astype(jdt))),
        atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# Configs and interop
# ---------------------------------------------------------------------------
def _same_cfg(cfg, jcfg):
    for f in dataclasses.fields(jcfg):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if f.name == "dtype":
            want = DT[jnp.dtype(want).name][1]
        assert got == want, f.name
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]


def test_configs_match_reference_field_for_field():
    for arch in ("rwkv6-1.6b", "rwkv6_1_6b", "qwen2.5-3b", "qwen2_5_3b",
                 "llama3-8b", "starcoder2-3b", "gemma-7b"):
        _same_cfg(base.get(arch), jbase.get(arch))
        _same_cfg(base.smoke_variant(base.get(arch)),
                  jbase.smoke_variant(jbase.get(arch)))
    smoke = base.smoke_variant(base.get("rwkv6-1.6b"))
    rc = smoke.rwkv_cfg()
    assert (smoke.n_layers, smoke.d_model, rc.n_heads, rc.head_dim,
            smoke.vocab) == (2, 256, 4, 64, 512)
    assert base.ALIASES == jbase.ALIASES and base.ARCH_IDS == jbase.ARCH_IDS
    # Every architecture of the reference has its config, the modal ones
    # included, and all_configs gives them key for key.
    for arch in ("whisper-base", "llama-3.2-vision-90b"):
        _same_cfg(base.get(arch), jbase.get(arch))
    every, jevery = base.all_configs(), jbase.all_configs()
    assert list(every) == list(jevery) == base.ARCH_IDS
    for arch in every:
        _same_cfg(every[arch], jevery[arch])
    with pytest.raises(ValueError, match="unknown architecture"):
        base.get("gpt-2")
    # Every family of the reference builds; another is refused.
    for family in ("enc_dec", "vlm"):
        assert registry.build(dataclasses.replace(
            smoke, family=family)).cfg.family == family
    with pytest.raises(ValueError, match="unknown model family"):
        registry.build(dataclasses.replace(smoke, family="gnn"))


def test_bfloat16_tree_crosses_and_round_trips():
    """A bfloat16 reference tree crosses into the port with every value
    and the leaf order kept, and comes back bit for bit."""
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get("rwkv6-1.6b")),
                               dtype=jnp.bfloat16)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    flat = _tree(jparams)
    assert list(flat) == RWKV_LEAVES
    jleaves = jax.tree.leaves(jparams)
    for (name, t), leaf in zip(flat.items(), jleaves):
        assert t.dtype == torch.bfloat16, name
        assert tuple(t.shape) == leaf.shape, name
        assert torch.equal(t.float(), torch.from_numpy(_np(leaf))), name
    back = jax.tree.map(lambda a, like: jnp.asarray(a).astype(like.dtype),
                        interop.tree_from_params(flat), jparams)
    for a, b in zip(jax.tree.leaves(back), jleaves):
        assert a.dtype == b.dtype and bool(jnp.array_equal(a, b))
    # The port's own init has the same leaves, shapes and dtypes.
    cfg = dataclasses.replace(base.smoke_variant(base.get("rwkv6-1.6b")),
                              dtype=torch.bfloat16)
    own = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    assert list(own) == RWKV_LEAVES
    assert all(own[k].shape == flat[k].shape and own[k].dtype == torch.bfloat16
               for k in flat)


# ---------------------------------------------------------------------------
# The smoke rwkv6: prefill, then decode
# ---------------------------------------------------------------------------
def _smoke(dtype):
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get("rwkv6-1.6b")),
                               dtype=jdt)
    cfg = dataclasses.replace(base.smoke_variant(base.get("rwkv6-1.6b")),
                              dtype=tdt)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, _tree(jparams)


@pytest.mark.parametrize("dtype", sorted(DT))
@pytest.mark.parametrize("prompt_len", [128, 96])
def test_smoke_rwkv6_prefill_and_decode_match_reference(prompt_len, dtype,
                                                        record_property):
    jcfg, cfg, jparams, tparams = _smoke(dtype)
    bundle = registry.build(cfg)
    tokens = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, size=(2, prompt_len))
    jlogits, jcache = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    logits, cache = bundle.prefill_step(
        tparams, {"tokens": torch.from_numpy(tokens)}, device="cpu")
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 512)
    assert cache["rwkv_state"].dtype == cfg.dtype
    assert tuple(cache["rwkv_state"].shape) == (2, 2, 4, 64, 64)

    jstep = jax.jit(lambda p, c, t, pos: jT.serve_step(p, jcfg, c, t, pos))
    pairs = [(logits, jlogits, cache["rwkv_state"], jcache["rwkv_state"])]
    for i in range(8):
        jtok = jnp.argmax(pairs[-1][1].reshape(2, -1), axis=-1)[:, None]
        tok = pairs[-1][0].reshape(2, -1).argmax(-1)[:, None]
        if dtype == "float32":
            assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        else:   # keep both on the reference's ids, to compare like with like
            tok = torch.from_numpy(np.asarray(jtok, np.int64))
        jlogits, jcache = jstep(jparams, jcache, jtok.astype(jnp.int32),
                                jnp.int32(prompt_len + i))
        logits, cache = bundle.serve_step(tparams, cache, tok,
                                          prompt_len + i, device="cpu")
        assert tuple(logits.shape) == (2, 1, 512)
        pairs.append((logits, jlogits, cache["rwkv_state"],
                      jcache["rwkv_state"]))

    worst_ulps = 0.0
    for got, want, st, jst in pairs:
        got, want = _np(got), _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
            np.testing.assert_allclose(_np(st), _np(jst), atol=1e-4, rtol=1e-4)
        else:
            assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()
            worst_ulps = max(worst_ulps, bf16_ulps(_np(st), _np(jst)))
    if dtype == "bfloat16":
        record_property("state_bf16_ulps", worst_ulps)
        print(f"largest bfloat16-ulp distance of the states: {worst_ulps:.1f}")
        assert np.isfinite(worst_ulps)


def test_smoke_rwkv6_forward_matches_reference():
    jcfg, cfg, jparams, tparams = _smoke("float32")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 40))
    want, _ = jT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    for impl in ("auto", "torch", "kernel"):
        with torch.no_grad():
            got, aux = transformer.forward(tparams, cfg,
                                           torch.from_numpy(tokens), impl=impl)
        assert float(aux) == 0.0
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_bundle_device_rule(monkeypatch):
    cfg = base.smoke_variant(base.get("rwkv6-1.6b"))
    bundle = registry.build(cfg)
    cpu_params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    assert list(cpu_params) == RWKV_LEAVES
    assert registry.needs_modal(cfg) is False
    cache = bundle.init_cache(2, 16, device="cpu")
    assert tuple(cache["rwkv_state"].shape) == (2, 2, 4, 64, 64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tokens = torch.zeros((2, 4), dtype=torch.int64)
    for call in (lambda: bundle.init(torch.Generator()),
                 lambda: bundle.prefill_step(cpu_params, {"tokens": tokens}),
                 lambda: bundle.serve_step(cpu_params, cache, tokens[:, :1], 4),
                 lambda: bundle.init_cache(2, 16)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


# ---------------------------------------------------------------------------
# The smoke qwen2.5 (dense family): prefill, then decode
# ---------------------------------------------------------------------------
QWEN_LEAVES = [
    "embed.table", "final_norm.scale", "layers.attn.bk", "layers.attn.bq",
    "layers.attn.bv", "layers.attn.wk", "layers.attn.wo", "layers.attn.wq",
    "layers.attn.wv", "layers.ln1.scale", "layers.ln2.scale",
    "layers.mlp.w_down", "layers.mlp.w_gate", "layers.mlp.w_up",
]


def test_qwen_config_and_dense_tree():
    cfg = base.get("qwen2.5-3b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.hd, cfg.d_ff, cfg.vocab, cfg.qkv_bias,
            cfg.rope_theta, cfg.dtype) == (
        "dense", 36, 2048, 16, 2, 128, 11008, 151936, True, 1e6,
        torch.bfloat16)
    smoke = base.smoke_variant(cfg)
    assert (smoke.n_layers, smoke.d_model, smoke.n_heads, smoke.n_kv_heads,
            smoke.hd, smoke.vocab) == (2, 256, 4, 1, 64, 512)
    ac = cfg.attn_cfg()
    jac = jbase.get("qwen2.5-3b").attn_cfg()
    assert dataclasses.asdict(ac) == dataclasses.asdict(jac)
    # The reference's dense tree crosses leaf for leaf, bfloat16 included.
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get("qwen2.5-3b")),
                               dtype=jnp.bfloat16)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    flat = _tree(jparams)
    assert list(flat) == QWEN_LEAVES
    for (name, t), leaf in zip(flat.items(), jax.tree.leaves(jparams)):
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == leaf.shape
        assert torch.equal(t.float(), torch.from_numpy(_np(leaf))), name
    own = transformer.init_params(torch.Generator().manual_seed(0),
                                  dataclasses.replace(smoke,
                                                      dtype=torch.bfloat16))
    assert list(own) == QWEN_LEAVES
    assert all(own[k].shape == flat[k].shape and own[k].dtype == torch.bfloat16
               for k in flat)
    # Parameter count at full width (the reference's init, counted on
    # shapes only).
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jbase.get("qwen2.5-3b")),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == \
        3_085_938_688


def _smoke_qwen(dtype):
    jdt, tdt = DT[dtype]
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get("qwen2.5-3b")),
                               dtype=jdt)
    cfg = dataclasses.replace(base.smoke_variant(base.get("qwen2.5-3b")),
                              dtype=tdt)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    # Biases drawn, not zero, so that the QKV bias path is exercised.
    rng = np.random.default_rng(7)
    attn = jparams["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        attn[name] = jnp.asarray(rng.normal(size=attn[name].shape).astype(
            np.float32) * 0.3).astype(jdt)
    return jcfg, cfg, jparams, _tree(jparams)


def _grow(cache, total):
    pad = [(0, 0)] * cache.ndim
    pad[-3] = (0, total - cache.shape[-3])
    return jnp.pad(cache, pad)


@pytest.mark.parametrize("prompt_len", [64, 96])
def test_smoke_qwen_prefill_and_decode_match_reference(prompt_len):
    """float32: prefill logits and K/V caches, then 8 decode steps against
    caches grown to prompt_len + 8, as the reference's serve grows them."""
    jcfg, cfg, jparams, tparams = _smoke_qwen("float32")
    bundle = registry.build(cfg)
    tokens = np.random.default_rng(prompt_len).integers(
        0, cfg.vocab, size=(2, prompt_len))
    jlogits, jcache = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    logits, cache = bundle.prefill_step(
        tparams, {"tokens": torch.from_numpy(tokens)}, device="cpu")
    assert logits.dtype == torch.float32 and tuple(logits.shape) == (2, 512)
    assert list(cache) == ["k", "v"]
    assert tuple(cache["k"].shape) == (2, 2, prompt_len, 1, 64)
    np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4, rtol=1e-4)
    for name in ("k", "v"):
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                   atol=1e-4, rtol=1e-4)

    total = prompt_len + 8
    jcache = {k: _grow(v, total) for k, v in jcache.items()}
    cache = serve.grow_cache(cache, total)
    assert tuple(cache["v"].shape) == (2, 2, total, 1, 64)
    jstep = jax.jit(lambda p, c, t, pos: jT.serve_step(p, jcfg, c, t, pos))
    for i in range(8):
        jtok = jnp.argmax(jlogits.reshape(2, -1), axis=-1)[:, None]
        tok = logits.reshape(2, -1).argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        jlogits, jcache = jstep(jparams, jcache, jtok.astype(jnp.int32),
                                jnp.int32(prompt_len + i))
        logits, new = bundle.serve_step(tparams, cache, tok, prompt_len + i,
                                        device="cpu")
        assert new["k"] is cache["k"]     # written in place
        assert tuple(logits.shape) == (2, 1, 512)
        np.testing.assert_allclose(_np(logits), _np(jlogits), atol=1e-4,
                                   rtol=1e-4)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       atol=1e-4, rtol=1e-4)


def test_smoke_qwen_bf16_prefill_matches_reference():
    """bfloat16: logits within 3e-2 of the largest |logit| (every layer
    rounds activations to bfloat16, and the packages' sums may round
    apart)."""
    jcfg, cfg, jparams, tparams = _smoke_qwen("bfloat16")
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 96))
    jlogits, jcache = jT.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    for impl in ("auto", "torch", "kernel"):
        logits, cache = registry.build(cfg).prefill_step(
            tparams, {"tokens": torch.from_numpy(tokens)}, impl=impl,
            device="cpu")
        assert cache["k"].dtype == torch.bfloat16
        got, want = _np(logits), _np(jlogits)
        assert np.abs(got - want).max() <= 3e-2 * np.abs(want).max()


def test_smoke_qwen_forward_matches_reference():
    jcfg, cfg, jparams, tparams = _smoke_qwen("float32")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 40))
    want, _ = jT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    for impl in ("auto", "torch", "kernel"):
        with torch.no_grad():
            got, aux = transformer.forward(tparams, cfg,
                                           torch.from_numpy(tokens), impl=impl)
        assert float(aux) == 0.0
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


def test_dense_window_raises_and_cache_shapes():
    cfg = base.smoke_variant(base.get("qwen2.5-3b"))
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    assert list(params) == QWEN_LEAVES
    tokens = torch.zeros((2, 8), dtype=torch.int64)
    cache = bundle.init_cache(2, 16, device="cpu")
    assert tuple(cache["k"].shape) == (2, 2, 16, 1, 64)
    assert cache["v"].dtype == torch.float32 and not cache["v"].any()
    # A window bounds the cache (it wraps) and takes every dense entry point.
    for window, slots in ((4, 4), (16, 16), (40, 16)):
        wc = bundle.init_cache(2, 16, window=window, device="cpu")
        assert tuple(wc["k"].shape) == (2, 2, slots, 1, 64)
    logits, _ = bundle.prefill_step(params, {"tokens": tokens}, window=4,
                                    device="cpu")
    assert tuple(logits.shape) == (2, cfg.vocab)
    step, _ = bundle.serve_step(params, cache, tokens[:, :1], 8, window=4,
                                device="cpu")
    assert tuple(step.shape) == (2, 1, cfg.vocab)
    assert transformer.forward(params, cfg, tokens, window=4)[0].shape[:2] \
        == (2, 8)
    # The modal families' caches wrap their self-attention K/V under a
    # window too; their cross K/V keep the modal input's length.
    modal = {"enc_dec": dict(n_enc_layers=2, enc_seq=12),
             "vlm": dict(n_layers=4, cross_attn_every=2, n_modal_tokens=12)}
    for family, kw in modal.items():
        mc = transformer.init_cache(
            dataclasses.replace(cfg, family=family, **kw), 2, 16, window=4)
        lead = (2,) if family == "enc_dec" else (2, 1)
        assert tuple(mc["k"].shape) == (*lead, 2, 4, 1, 64)
        assert tuple(mc["xv"].shape) == (2, 2, 12, 1, 64)
        assert list(mc) == ["k", "v", "xk", "xv"]


# ---------------------------------------------------------------------------
# The simulator's model zoo (registry.sim_model)
# ---------------------------------------------------------------------------
def test_sim_model_ids_equal_the_reference():
    from repro.models import registry as jregistry

    assert registry.SIM_MODEL_IDS == jregistry.SIM_MODEL_IDS
    assert registry.sim_models() == jregistry.sim_models()
    assert base.MODAL_ARCHS == tuple(
        a for a in jbase.ARCH_IDS if jregistry.needs_modal(jbase.get(a)))


def _sim_input(name, rng):
    if name == "cnn":
        return rng.normal(size=(2, 28, 28, 1)).astype(np.float32)
    if name == "resnet":
        return rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    if name == "mlp":
        return rng.normal(size=(2, 32)).astype(np.float32)
    return rng.integers(0, 90, size=(2, 12)).astype(np.int32)


@pytest.mark.parametrize("name", ["cnn", "resnet", "charrnn", "mlp",
                                  "transformer_nwp", "nwp:qwen2_5_3b",
                                  "nwp:rwkv6_1_6b"])
def test_sim_model_forward_matches_reference(name):
    from repro.models import registry as jregistry

    jm, tm = jregistry.sim_model(name), registry.sim_model(name)
    assert (tm.name, tm.model_id) == (jm.name, jm.model_id)
    assert (tm.cfg is None) == (jm.cfg is None)
    jp = jax.jit(jm.init_fn)(jax.random.PRNGKey(0))
    tp = _tree(jp)
    assert list(tp) == list(tm.init_fn(torch.Generator().manual_seed(0)))
    x = _sim_input(name, np.random.default_rng(1))
    want = jax.jit(jm.apply_fn)(jp, jnp.asarray(x))
    got = tm.apply_fn(tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got.detach()), _np(want), atol=1e-5,
                               rtol=1e-5)


def test_sim_model_unported_families_raise():
    for name in registry.sim_models():
        arch = name.split(":", 1)[1] if name.startswith("nwp:") else None
        if arch is None:
            continue
        registry.sim_model(name)      # every decoder-only family is ported
    for arch in base.MODAL_ARCHS:      # as the reference refuses them
        with pytest.raises(ValueError, match="needs side inputs"):
            registry.nwp_cfg(arch)
    with pytest.raises(ValueError, match="unknown sim model"):
        registry.sim_model("nope")
