"""PyTorch port vs the JAX reference: the rest of the dense model zoo.

llama3-8b, starcoder2-3b and gemma-7b: their configs and `INPUT_SHAPES`
field for field, parameter counts at full width, each smoke variant's
`forward`, `prefill` and `serve_step` (gemma's sqrt(d_model) embedding
scale in `forward` only, as in the reference), a model at head dim 256
(gemma's, which `smoke_variant` caps at 64), K2's plain version at D = 256
against the Pallas kernel in interpret mode, and `sim_model("nwp:<arch>")`.
Weights come from the reference's init through `interop`; tokens and
inputs are drawn with numpy.  Tolerances: 1e-5 in float32 (absolute and
relative; sums in another order), greedy ids equal; K2 as
`tests/test_torch_flash.py` holds it (2e-5 float32, 3e-2 bfloat16).
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
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402

ARCHS = ["llama3-8b", "starcoder2-3b", "gemma-7b"]
# Parameters at full width (the reference's init, counted on shapes), head
# dim, activation, QKV bias.
FULL = {"llama3-8b": (7_504_924_672, 128, "swiglu", False),
        "starcoder2-3b": (3_029_630_976, 128, "gelu", True),
        "gemma-7b": (8_537_680_896, 256, "geglu", False)}
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    x.astype(jnp.float32), dtype=np.float32)


def _tree(jtree):
    return interop.params_from_jax(jax.tree.map(np.asarray, jtree))


def _same_cfg(cfg, jcfg):
    for f in dataclasses.fields(jcfg):
        got, want = getattr(cfg, f.name), getattr(jcfg, f.name)
        if f.name == "dtype":
            want = {"float32": torch.float32,
                    "bfloat16": torch.bfloat16}[jnp.dtype(want).name]
        assert got == want, f.name
    assert [f.name for f in dataclasses.fields(cfg)] == \
        [f.name for f in dataclasses.fields(jcfg)]


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    cfg, jcfg = base.get(arch), jbase.get(arch)
    _same_cfg(cfg, jcfg)
    _same_cfg(base.smoke_variant(cfg), jbase.smoke_variant(jcfg))
    assert dataclasses.asdict(cfg.attn_cfg(window=512)) == \
        dataclasses.asdict(jcfg.attn_cfg(window=512))
    n, hd, act, bias = FULL[arch]
    assert (cfg.family, cfg.hd, cfg.act, cfg.qkv_bias, cfg.dtype) == (
        "dense", hd, act, bias, torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == n
    # The port's own init gives the reference's tree at the smoke size.
    smoke = base.smoke_variant(cfg)
    jsmoke = jbase.smoke_variant(jcfg)
    own = transformer.init_params(torch.Generator().manual_seed(0), smoke)
    jtree = _tree(jT.init_params(jax.random.PRNGKey(0), jsmoke))
    assert list(own) == list(jtree)
    assert all(own[k].shape == jtree[k].shape for k in own)


def test_input_shapes_and_long_context_window_match_reference():
    assert list(base.INPUT_SHAPES) == list(jbase.INPUT_SHAPES)
    for name, shape in base.INPUT_SHAPES.items():
        assert dataclasses.asdict(shape) == \
            dataclasses.asdict(jbase.INPUT_SHAPES[name])
    assert [f.name for f in dataclasses.fields(base.InputShape)] == \
        [f.name for f in dataclasses.fields(jbase.InputShape)]
    assert base.LONG_CONTEXT_WINDOW == jbase.LONG_CONTEXT_WINDOW == 8192
    assert base.INPUT_SHAPES["long_500k"].seq_len - 1 == 524_287


@functools.lru_cache(maxsize=None)
def _smoke(arch):
    """The float32 smoke variant in both packages and the reference's
    weights, with QKV biases drawn (not zero) where the config has them."""
    jcfg = jbase.smoke_variant(jbase.get(arch))
    cfg = base.smoke_variant(base.get(arch))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    if jcfg.qkv_bias:
        rng = np.random.default_rng(7)
        attn = jparams["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = jnp.asarray(rng.normal(
                size=attn[name].shape).astype(np.float32) * 0.3)
    return jcfg, cfg, jparams, _tree(jparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_reference(arch):
    jcfg, cfg, jparams, tparams = _smoke(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 40))
    want, _ = jax.jit(lambda p, t: jT.forward(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    for impl in ("auto", "torch", "kernel"):
        with torch.no_grad():
            got, aux = transformer.forward(tparams, cfg,
                                           torch.from_numpy(tokens),
                                           impl=impl)
        assert float(aux) == 0.0
        np.testing.assert_allclose(_np(got), _np(want), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_and_decode_match_reference(arch):
    """Prefill logits and K/V caches, then 6 decode steps against caches
    grown to prompt + 6, as the reference's serve grows them."""
    jcfg, cfg, jparams, tparams = _smoke(arch)
    bundle = registry.build(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 48))
    jlogits, jcache = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    for impl in ("torch", "kernel"):
        logits, cache = bundle.prefill_step(
            tparams, {"tokens": torch.from_numpy(tokens)}, impl=impl,
            device="cpu")
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **TOL)
    total = tokens.shape[1] + 6
    cache = serve.grow_cache(cache, total)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, total - v.shape[2]),
                             (0, 0), (0, 0)]) for k, v in jcache.items()}
    jstep = jax.jit(lambda p, c, t, pos: jT.serve_step(p, jcfg, c, t, pos))
    for i in range(6):
        jtok = jnp.argmax(jlogits.reshape(2, -1), axis=-1)[:, None]
        tok = logits.reshape(2, -1).argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        pos = tokens.shape[1] + i
        jlogits, jcache = jstep(jparams, jcache, jtok.astype(jnp.int32),
                                jnp.int32(pos))
        logits, _ = bundle.serve_step(tparams, cache, tok, pos, device="cpu")
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **TOL)


def test_gemma_scales_embeddings_in_forward_only():
    """The reference multiplies gemma's embeddings by sqrt(d_model) in
    `forward` and not in `prefill`: the two last-position logits differ in
    both packages, and each package agrees with the other on each."""
    jcfg, cfg, jparams, tparams = _smoke("gemma-7b")
    tokens = np.random.default_rng(9).integers(0, cfg.vocab, size=(2, 24))
    jfwd, _ = jT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    jpre, _ = jT.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    with torch.no_grad():
        fwd, _ = transformer.forward(tparams, cfg, torch.from_numpy(tokens))
    pre, _ = transformer.prefill(tparams, cfg, torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(fwd), _np(jfwd), **TOL)
    np.testing.assert_allclose(_np(pre), _np(jpre), **TOL)
    gap = float(np.abs(_np(fwd)[:, -1] - _np(pre)).max())
    assert gap > 1e-2 and float(np.abs(_np(jfwd)[:, -1] - _np(jpre)).max()) \
        > 1e-2
    # Without the scale the forward's last logits are the prefill's.
    plain = dataclasses.replace(cfg, name="llama-like")
    with torch.no_grad():
        unscaled, _ = transformer.forward(tparams, plain,
                                          torch.from_numpy(tokens))
    np.testing.assert_allclose(_np(unscaled)[:, -1], _np(pre), **TOL)


def _d256_cfgs():
    """A dense model at gemma's head dim: 2 layers, 2 heads of 256."""
    kw = dict(name="gemma-d256", n_layers=2, d_model=128, n_heads=2,
              n_kv_heads=2, head_dim=256, d_ff=256, vocab=300, act="geglu",
              rope_theta=10_000.0)
    return (jT.ModelCfg(family="dense", dtype=jnp.float32, **kw),
            transformer.ModelCfg(family="dense", dtype=torch.float32, **kw))


def test_head_dim_256_prefill_and_decode_match_reference():
    jcfg, cfg = _d256_cfgs()
    jparams = jT.init_params(jax.random.PRNGKey(3), jcfg)
    tparams = _tree(jparams)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab, size=(2, 70))
    jlogits, jcache = jT.prefill(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    assert jcache["k"].shape[-1] == 256
    before = ops.LAUNCHES["flash_attention"]
    for impl in ("kernel", "torch"):
        logits, cache = transformer.prefill(tparams, cfg,
                                            torch.from_numpy(tokens),
                                            impl=impl)
        np.testing.assert_allclose(_np(logits), _np(jlogits), **TOL)
        np.testing.assert_allclose(_np(cache["v"]), _np(jcache["v"]), **TOL)
    assert ops.LAUNCHES["flash_attention"] == before   # the CPU counts none
    with torch.no_grad():
        got, _ = transformer.forward(tparams, cfg, torch.from_numpy(tokens),
                                     impl="kernel")
    want, _ = jT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(_np(got), _np(want), **TOL)
    cache = serve.grow_cache(cache, 71)
    jcache = {k: jnp.pad(v, [(0, 0), (0, 0), (0, 1), (0, 0), (0, 0)])
              for k, v in jcache.items()}
    tok = np.argmax(_np(logits), -1)[:, None]
    jstep, _ = jT.serve_step(jparams, jcfg, jcache,
                             jnp.asarray(tok, jnp.int32), jnp.int32(70))
    step, _ = transformer.serve_step(tparams, cfg, cache,
                                     torch.from_numpy(tok), 70)
    np.testing.assert_allclose(_np(step), _np(jstep), **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(1, 64, 2, 2, 256), (2, 96, 4, 1, 256)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k2_plain_at_head_dim_256_matches_pallas(shape, dtype, causal):
    jdt, tdt, tol = {"float32": (jnp.float32, torch.float32, 2e-5),
                     "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    b, s, h, kv, d = shape
    rng = np.random.default_rng(sum(shape))
    arrays = [rng.normal(size=(b, s, n, d)).astype(np.float32)
              for n in (h, kv, kv)]
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in arrays)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in arrays)
    scale = d ** -0.5
    want_pallas = jops.flash_attention(jq, jk, jv, scale=scale, causal=causal,
                                       block_q=32, block_k=32, interpret=True)
    want_ref = jref.flash_attention_ref(jq, jk, jv, scale=scale,
                                        causal=causal)
    got = ops.flash_attention(q, k, v, scale=scale, causal=causal,
                              device="cpu")
    assert got.dtype == tdt and tuple(got.shape) == (b, s, h, d)
    assert fa.body(tdt, d) == ("wgmma" if tdt == torch.bfloat16 else "simt")
    for want in (want_pallas, want_ref):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=0)
    assert torch.equal(got, ref.flash_attention_ref(q, k, v, scale=scale,
                                                    causal=causal))


@pytest.mark.parametrize("arch", ["llama3_8b", "starcoder2_3b", "gemma_7b"])
def test_sim_model_nwp_forward_matches_reference(arch):
    name = f"nwp:{arch}"
    jm, tm = jregistry.sim_model(name), registry.sim_model(name)
    assert (tm.name, tm.model_id) == (jm.name, jm.model_id)
    _same_cfg(tm.cfg, jm.cfg)
    jp = jax.jit(jm.init_fn)(jax.random.PRNGKey(0))
    tp = _tree(jp)
    assert list(tp) == list(tm.init_fn(torch.Generator().manual_seed(0)))
    x = np.random.default_rng(1).integers(0, 90, size=(2, 12)).astype(np.int32)
    want = jax.jit(jm.apply_fn)(jp, jnp.asarray(x))
    got = tm.apply_fn(tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got.detach()), _np(want), **TOL)
    assert registry.SIM_MODEL_IDS == jregistry.SIM_MODEL_IDS
