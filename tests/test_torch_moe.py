"""PyTorch port vs the JAX reference: the MoE family.

`models/moe.py` (the layer's output, its load-balance loss and the exact
set of (token, k) selections it keeps, at capacity factors 1.25, 0.5 and
8.0; ties of a zero router; group sizes where the token count is not a
multiple of 1024; the layer under `torch.func.vmap` and its gradient), the
granite-moe-1b-a400m and dbrx-132b configs field for field, their smoke
variants' `forward`, `prefill` and `serve_step`, decode against the
forward at capacity factor 8, bfloat16 caches, one `train_step`'s loss and
aux, and the aux under `remat` (the `nwp:` sim models are in
tests/test_torch_hybrid.py).  Weights come from the reference's
init through `interop`; inputs are drawn with numpy.  Tolerances: 1e-5 in
float32 (absolute and relative; sums in another order), 1e-4 for whole
models; kept sets and greedy ids exactly equal.
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
from repro.models import moe as jmoe  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import moe, registry, transformer  # noqa: E402

ARCHS = ["granite-moe-1b-a400m", "dbrx-132b"]
# Parameters at full width (the reference's init, counted on shapes).
FULL = {"granite-moe-1b-a400m": 1_334_628_352,
        "dbrx-132b": 130_979_960_832}
TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)


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


def _cfgs(**kw):
    base_kw = dict(d_model=32, d_ff=48, n_experts=8, top_k=2)
    base_kw.update(kw)
    return jmoe.MoECfg(**base_kw), moe.MoECfg(**base_kw)


def _params(jcfg, seed=0):
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, _tree(jp)


def _ref_kept(jp, jcfg, x):
    """The reference's kept (group, token, k) -> expert map: the lines of
    its `moe_layer` that route (top-k, queue positions, the drop)."""
    b, s, d = x.shape
    t = b * s
    g = jmoe._group_size(t, jcfg)
    ng = t // g
    cap = jmoe._capacity(g, jcfg)
    xt = x.reshape(ng, g, d)
    probs = jax.nn.softmax((xt @ jp["router"]).astype(jnp.float32), -1)
    _, idx = jax.lax.top_k(probs, jcfg.top_k)
    sel = jax.nn.one_hot(idx, jcfg.n_experts, dtype=jnp.float32)
    sel_flat = sel.reshape(ng, g * jcfg.top_k, jcfg.n_experts)
    pos = jnp.sum((jnp.cumsum(sel_flat, 1) - sel_flat) * sel_flat,
                  -1).reshape(ng, g, jcfg.top_k)
    return np.asarray(idx), np.asarray(pos < cap)


@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
def test_moe_layer_matches_reference(cf):
    """y and aux within 1e-5, and the same selections kept, over several
    groups (group size 16 of 3 x 32 tokens)."""
    jcfg, cfg = _cfgs(capacity_factor=cf, group_size=16)
    jp, tp = _params(jcfg)
    x = np.random.default_rng(1).normal(size=(3, 32, 32)).astype(np.float32)
    jy, jaux = jmoe.moe_layer(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_layer(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    jidx, jkeep = _ref_kept(jp, jcfg, jnp.asarray(x))
    g = moe._group_size(96, cfg)
    cap = moe._capacity(g, cfg)
    r = moe.route(tp, cfg, torch.from_numpy(x).reshape(96 // g, g, 32), cap)
    np.testing.assert_array_equal(r.idx.numpy(), jidx)
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    kept = int(jkeep.sum())
    if cf == 8.0:
        assert kept == jkeep.size
    else:
        assert 0 < kept < jkeep.size
    # Every kept selection has its own slot; empty slots are zero rows.
    xe = moe.dispatch(torch.from_numpy(x).reshape(96 // g, g, 32), r, cap)
    assert tuple(xe.shape) == (8, (96 // g) * cap, 32)
    assert int((xe.abs().sum(-1) > 0).sum()) == kept


def test_zero_router_ties_break_to_the_lower_expert():
    """A zero router makes all E experts tie: the reference takes experts
    0 ... k-1 for every token, and so must the port; with capacity factor
    1 (a group of 16, 8 experts, top 2: 4 slots each) experts 0 and 1
    fill and every later token is dropped."""
    jcfg, cfg = _cfgs(capacity_factor=1.0, group_size=16)
    jp, tp = _params(jcfg)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    tp = dict(tp, router=torch.zeros_like(tp["router"]))
    x = np.random.default_rng(2).normal(size=(2, 16, 32)).astype(np.float32)
    jidx, jkeep = _ref_kept(jp, jcfg, jnp.asarray(x))
    assert (jidx == np.arange(2)).all()
    r = moe.route(tp, cfg, torch.from_numpy(x).reshape(2, 16, 32), 4)
    assert torch.equal(r.idx, torch.arange(2).expand(2, 16, 2))
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)
    assert int(r.keep.sum()) == 2 * 2 * 4
    jy, jaux = jmoe.moe_layer(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_layer(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    # bfloat16 logits tie often; the stable sort keeps index order.
    probs = torch.tensor([[[0.25, 0.5, 0.25, 0.5, 0.0]]])
    assert moe.top_k(probs, 3).tolist() == [[[1, 3, 0]]]


def test_group_size_and_capacity_match_reference():
    for cf in (0.5, 1.0, 1.25, 8.0):
        for e, k in ((32, 8), (16, 4), (4, 2), (8, 1)):
            jcfg = jmoe.MoECfg(d_model=8, d_ff=8, n_experts=e, top_k=k,
                               capacity_factor=cf)
            cfg = moe.MoECfg(d_model=8, d_ff=8, n_experts=e, top_k=k,
                             capacity_factor=cf)
            for t in (1, 7, 8, 97, 1024, 1030, 1400, 2048, 16384, 16386):
                g = moe._group_size(t, cfg)
                assert g == jmoe._group_size(t, jcfg), (t, cf, e, k)
                assert moe._capacity(g, cfg) == jmoe._capacity(g, jcfg)
    granite = transformer.ModelCfg(**{
        f.name: getattr(base.get("granite-moe-1b-a400m"), f.name)
        for f in dataclasses.fields(transformer.ModelCfg)}).moe_cfg()
    # A decode step of 8 tokens: 8 * 8 / 32 * 1.25 = 2.5 -> 3 slots.
    assert moe._capacity(moe._group_size(8, granite), granite) == 3
    # The full prefill: 8 x 2048 tokens in 16 groups of 1024, 320 slots.
    assert moe._group_size(8 * 2048, granite) == 1024
    assert moe._capacity(1024, granite) == 320


@pytest.mark.parametrize("tokens", [1400, 1030])
def test_moe_layer_group_not_dividing_1024(tokens):
    """T = 1400 routes in 2 groups of 700, T = 1030 in 2 of 515 (capacity
    factor 1, so that some selections drop)."""
    jcfg, cfg = _cfgs(d_model=16, d_ff=16, capacity_factor=1.0)
    jp, tp = _params(jcfg, seed=3)
    assert moe._group_size(tokens, cfg) == tokens // 2
    x = np.random.default_rng(4).normal(size=(2, tokens // 2, 16)).astype(
        np.float32)
    jy, jaux = jmoe.moe_layer(jp, jcfg, jnp.asarray(x))
    y, aux = moe.moe_layer(tp, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(y), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    jidx, jkeep = _ref_kept(jp, jcfg, jnp.asarray(x))
    assert not jkeep.all()
    r = moe.route(tp, cfg, torch.from_numpy(x).reshape(2, tokens // 2, 16),
                  moe._capacity(tokens // 2, cfg))
    np.testing.assert_array_equal(r.keep.numpy(), jkeep)


def test_moe_layer_under_vmap_and_its_gradient():
    """`torch.func.vmap` over clients gives each client's own layer, and
    `vmap(grad)` each client's gradient against the reference's
    `vmap(grad)`."""
    jcfg, cfg = _cfgs(capacity_factor=1.25, group_size=8)
    jps = [jmoe.init_moe(jax.random.PRNGKey(i), jcfg) for i in range(3)]
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jps)
    tstack = _tree(jstack)
    x = np.random.default_rng(5).normal(size=(3, 2, 12, 32)).astype(
        np.float32)

    def tloss(p, xi):
        y, aux = moe.moe_layer(p, cfg, xi)
        return (y ** 2).mean() + 0.01 * aux

    def jloss(p, xi):
        y, aux = jmoe.moe_layer(p, jcfg, xi)
        return (y ** 2).mean() + 0.01 * aux

    ys = torch.func.vmap(lambda p, xi: moe.moe_layer(p, cfg, xi)[0])(
        tstack, torch.from_numpy(x))
    for i in range(3):
        own = moe.moe_layer({k: v[i] for k, v in tstack.items()}, cfg,
                            torch.from_numpy(x[i]))[0]
        torch.testing.assert_close(ys[i], own, atol=1e-6, rtol=1e-6)
    grads = torch.func.vmap(torch.func.grad(tloss))(tstack,
                                                    torch.from_numpy(x))
    jgrads = jax.vmap(jax.grad(jloss))(jstack, jnp.asarray(x))
    jflat = _tree(jgrads)
    assert list(grads) == list(jflat)
    for name in grads:
        np.testing.assert_allclose(_np(grads[name]), _np(jflat[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# Configs and the smoke models
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_field_for_field(arch):
    cfg, jcfg = base.get(arch), jbase.get(arch)
    _same_cfg(cfg, jcfg)
    _same_cfg(base.smoke_variant(cfg), jbase.smoke_variant(jcfg))
    assert dataclasses.asdict(cfg.moe_cfg()) == \
        dataclasses.asdict(jcfg.moe_cfg())
    assert (cfg.family, cfg.dtype) == ("moe", torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == \
        FULL[arch]
    smoke = base.smoke_variant(cfg)
    own = transformer.init_params(torch.Generator().manual_seed(0), smoke)
    jtree = _tree(jT.init_params(jax.random.PRNGKey(0),
                                 jbase.smoke_variant(jcfg)))
    assert list(own) == list(jtree)
    assert all(own[k].shape == jtree[k].shape for k in own)
    assert {k for k in own if k.startswith("layers.moe.")} == {
        "layers.moe.router", "layers.moe.w_down", "layers.moe.w_gate",
        "layers.moe.w_up"}


def test_moe_leaves_cross_in_float32_and_bfloat16():
    """The moe leaves cross with `interop.params_from_jax` in float32 and
    bfloat16, every value and the leaf order kept, and come back."""
    jcfg = jbase.smoke_variant(jbase.get("granite-moe-1b-a400m"))
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        jp = jT.init_params(jax.random.PRNGKey(1),
                            dataclasses.replace(jcfg, dtype=dt))
        tp = _tree(jp)
        leaves = jax.tree.leaves(jp)
        assert len(tp) == len(leaves)
        for (name, t), leaf in zip(tp.items(), leaves):
            assert t.dtype == tdt, name
            np.testing.assert_array_equal(_np(t), _np(leaf), err_msg=name)
        back = interop.tree_from_params(tp)
        for a, b in zip(jax.tree.leaves(back), leaves):
            np.testing.assert_array_equal(np.asarray(a, np.float32),
                                          _np(b))


@functools.lru_cache(maxsize=None)
def _smoke(arch, **kw):
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get(arch)), **kw)
    cfg = dataclasses.replace(base.smoke_variant(base.get(arch)), **kw)
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, _tree(jparams)


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_forward_matches_reference(arch):
    """Logits and the summed aux loss, 2 x 40 tokens (one group of 80)."""
    jcfg, cfg, jparams, tparams = _smoke(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 40))
    want, jaux = jax.jit(lambda p, t: jT.forward(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    for impl in ("auto", "torch", "kernel"):
        with torch.no_grad():
            got, aux = transformer.forward(tparams, cfg,
                                           torch.from_numpy(tokens),
                                           impl=impl)
        np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
        assert float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_and_decode_match_reference(arch):
    """Prefill logits and K/V caches, then 6 decode steps (each routing the
    step's 2 tokens as one group) against caches grown to prompt + 6."""
    jcfg, cfg, jparams, tparams = _smoke(arch)
    bundle = registry.build(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 48))
    jlogits, jcache = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    for impl in ("torch", "kernel"):
        logits, cache = bundle.prefill_step(
            tparams, {"tokens": torch.from_numpy(tokens)}, impl=impl,
            device="cpu")
        np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL_TOL)
        assert list(cache) == ["k", "v"]
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **MODEL_TOL)
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
        np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL_TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_at_capacity_factor_8(arch):
    """At capacity factor 8 nothing is dropped, so decoding a prompt token
    by token from an empty cache gives the forward's logits at every
    position (the reference's own check, tests/test_models.py); at 1.25 a
    decode step routes its B tokens as one group and drops otherwise."""
    jcfg, cfg, jparams, tparams = _smoke(arch, capacity_factor=8.0)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 10))
    with torch.no_grad():
        want, _ = transformer.forward(tparams, cfg, torch.from_numpy(tokens))
    cache = transformer.init_cache(cfg, 2, 10, device="cpu")
    for i in range(10):
        logits, cache = transformer.serve_step(
            tparams, cfg, cache, torch.from_numpy(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(want[:, i]),
                                   **MODEL_TOL)
    jwant, _ = jT.forward(jparams, jcfg, jnp.asarray(tokens, jnp.int32))
    np.testing.assert_allclose(_np(want), _np(jwant), **MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_dtype_discipline(arch):
    """bfloat16 caches keep their dtype through a prefill and a decode
    step, and the logits are finite (the reference's check)."""
    cfg = dataclasses.replace(base.smoke_variant(base.get(arch)),
                              dtype=torch.bfloat16)
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, aux = transformer.forward(params, cfg, tokens)
    assert bool(torch.isfinite(logits).all()) and aux.dtype == torch.float32
    cache = bundle.init_cache(2, 8, device="cpu")
    dtypes = {k: v.dtype for k, v in cache.items()}
    lg, new = bundle.serve_step(params, cache, tokens[:, :1], 0,
                                device="cpu")
    assert bool(torch.isfinite(lg).all())
    assert {k: v.dtype for k, v in new.items()} == dtypes == {
        "k": torch.bfloat16, "v": torch.bfloat16}
    _, pre = bundle.prefill_step(params, {"tokens": tokens}, device="cpu")
    assert {k: v.dtype for k, v in pre.items()} == dtypes


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_loss_and_aux_match_reference(arch):
    """One AdamW `train_step` from the reference's weights: its loss and
    aux metrics within 1e-5, then the next loss (after the update) within
    1e-4."""
    jcfg, cfg, jparams, tparams = _smoke(arch)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab, size=(2, 24))
    jbundle = jregistry.build(jcfg, lr=1e-3)
    jstate = {"params": jparams, "opt": jbundle.optimizer.init(jparams)}
    jbatch = {"tokens": jnp.asarray(tokens, jnp.int32)}
    jstep = jax.jit(jbundle.train_step)
    jstate, jm = jstep(jstate, jbatch)
    _, jm2 = jstep(jstate, jbatch)
    bundle = registry.build(cfg, lr=1e-3)
    params = {k: v.clone() for k, v in tparams.items()}
    state = {"params": params, "opt": bundle.optimizer.init(params)}
    batch = {"tokens": torch.from_numpy(tokens)}
    state, m = bundle.train_step(state, batch, device="cpu")
    for key in ("loss", "aux"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL)
    assert float(m["aux"]) > 0
    _, m2 = bundle.train_step(state, batch, device="cpu")
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               atol=1e-4, rtol=1e-4)
    total, parts = bundle.loss_fn(tparams, batch, device="cpu")
    np.testing.assert_allclose(float(total),
                               float(parts["loss"] + 0.01 * parts["aux"]),
                               rtol=1e-6)


def test_remat_keeps_the_aux_loss_and_its_gradients():
    """With ``remat`` each layer is checkpointed and returns (x, aux): the
    loss, the summed aux and every gradient equal the unchecked run's (the
    reference's `_scan_layers` sums the aux under `jax.checkpoint` too)."""
    _, cfg, _, tparams = _smoke("dbrx-132b")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, size=(2, 16)))
    out = {}
    for remat in (False, True):
        bundle = registry.build(dataclasses.replace(cfg, remat=remat))
        leaves = {k: v.clone().requires_grad_() for k, v in tparams.items()}
        total, parts = bundle.loss_fn(leaves, {"tokens": tokens},
                                      device="cpu")
        grads = torch.autograd.grad(total, list(leaves.values()))
        out[remat] = (float(parts["loss"]), float(parts["aux"]), grads)
    assert out[True][:2] == out[False][:2] and out[True][1] > 0
    for a, b in zip(out[True][2], out[False][2]):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)
    grad_router = out[True][2][list(tparams).index("layers.moe.router")]
    assert float(grad_router.abs().sum()) > 0
