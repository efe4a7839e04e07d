"""PyTorch port vs the JAX reference: the hybrid family.

The Mamba half of `models/ssm.py` (`ssm_seq` with and without its final
state at sequence lengths below, at and off a multiple of the scan's
chunk, `ssm_step`, the exact softplus above 20, decays that underflow,
the scan under `torch.func.vmap` and its gradient), the hymba-1.5b config
field for field, its smoke variant's `forward`, `prefill` and
`serve_step`, decode against the forward, bfloat16 caches (the
reference's "hymba regression"), one `train_step`'s loss, and the three
`nwp:` sim models of this slice (granite-moe, dbrx, hymba) forward, under
`vmap(grad)` and through `GridRunner` on the CPU.  Weights come from the
reference's init through `interop`; inputs are drawn with numpy.
Tolerances: 1e-5 in float32 (absolute and relative; the reference's
associative scan sums in another order), 1e-4 for whole models; greedy
ids exactly equal.
"""
import dataclasses
import functools
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
from repro.configs import base as jbase  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jT  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import scenarios, simulator  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry, ssm, transformer  # noqa: E402

ARCH = "hymba-1.5b"
FULL_PARAMS = 1_341_648_032
TOL = dict(atol=1e-5, rtol=1e-5)
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
SIM_ARCHS = ["granite_moe_1b_a400m", "dbrx_132b", "hymba_1_5b"]


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


def _ssm(d=24, n=8, seed=0, **overrides):
    jcfg = jssm.SSMCfg(d_model=d, d_state=n)
    cfg = ssm.SSMCfg(d_model=d, d_state=n)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, **{k: jnp.asarray(v) for k, v in overrides.items()})
    return jcfg, cfg, jp, _tree(jp)


# ---------------------------------------------------------------------------
# The selective SSM
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 5, 64, 100, 200])
def test_ssm_seq_matches_reference(s):
    """Output and final state at one position and over several chunks of
    L = sqrt(S / 2) positions, padded (S = 5, 64, 100) and not (S = 200);
    the port's own init gives the reference's leaves."""
    jcfg, cfg, jp, tp = _ssm(seed=s)
    x = np.random.default_rng(s).normal(size=(2, s, 24)).astype(np.float32)
    jout, jstate = jssm.ssm_seq(jp, jcfg, jnp.asarray(x), return_state=True)
    out, state = ssm.ssm_seq(tp, cfg, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(_np(out), _np(jout), **TOL)
    np.testing.assert_allclose(_np(state), _np(jstate), **TOL)
    assert tuple(state.shape) == (2, cfg.d_inner, 8)
    assert state.dtype == torch.float32
    own = ssm.init_ssm(torch.Generator().manual_seed(0), cfg)
    assert list(own) == list(tp)
    assert all(own[k].shape == tp[k].shape for k in own)
    np.testing.assert_allclose(_np(own["log_a"]), _np(jp["log_a"]), **TOL)


def test_ssm_step_matches_reference_and_the_sequence():
    """Token by token from a zero state, `ssm_step` gives the reference's
    steps and the sequence form's outputs and final state."""
    jcfg, cfg, jp, tp = _ssm(seed=3)
    x = np.random.default_rng(3).normal(size=(2, 9, 24)).astype(np.float32)
    jstate = jssm.init_ssm_state(2, jcfg)
    state = ssm.init_ssm_state(2, cfg)
    outs = []
    for t in range(9):
        xt = x[:, t:t + 1]
        jo, jstate = jssm.ssm_step(jp, jcfg, jnp.asarray(xt), jstate)
        o, state = ssm.ssm_step(tp, cfg, torch.from_numpy(xt), state)
        np.testing.assert_allclose(_np(o), _np(jo), **TOL)
        np.testing.assert_allclose(_np(state), _np(jstate), **TOL)
        outs.append(o)
    seq, final = ssm.ssm_seq(tp, cfg, torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(seq), **TOL)
    np.testing.assert_allclose(_np(state), _np(final), **TOL)


def test_ssm_softplus_and_underflowing_decays():
    """A dt bias of 30 (above `F.softplus`'s threshold of 20: the exact
    log(1 + e^z) is kept) and one of 3000 (every decay exp(-dt a)
    underflows to 0, as the reference's products do)."""
    z = torch.tensor([-30.0, -1.0, 0.0, 19.0, 21.0, 30.0])
    np.testing.assert_array_equal(
        ssm._softplus(z).numpy(),
        np.asarray(jax.nn.softplus(jnp.asarray(z.numpy()))))
    for bias in (30.0, 3000.0):
        jcfg, cfg, jp, tp = _ssm(seed=4, dt_bias=np.full((1,), bias,
                                                         np.float32))
        x = np.random.default_rng(4).normal(size=(2, 70, 24)).astype(
            np.float32)
        jout, jstate = jssm.ssm_seq(jp, jcfg, jnp.asarray(x),
                                    return_state=True)
        out, state = ssm.ssm_seq(tp, cfg, torch.from_numpy(x),
                                 return_state=True)
        scale = max(float(np.abs(_np(jout)).max()), 1.0)
        np.testing.assert_allclose(_np(out) / scale, _np(jout) / scale,
                                   **TOL)
        sscale = max(float(np.abs(_np(jstate)).max()), 1.0)
        np.testing.assert_allclose(_np(state) / sscale, _np(jstate) / sscale,
                                   **TOL)


def test_ssm_seq_under_vmap_and_its_gradient():
    """`vmap(grad)` of a loss through `ssm_seq` over 3 clients against the
    reference's `vmap(grad)`."""
    jcfg = jssm.SSMCfg(d_model=16, d_state=4)
    cfg = ssm.SSMCfg(d_model=16, d_state=4)
    jps = [jssm.init_ssm(jax.random.PRNGKey(i), jcfg) for i in range(3)]
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jps)
    tstack = _tree(jstack)
    x = np.random.default_rng(6).normal(size=(3, 2, 20, 16)).astype(
        np.float32)

    def tloss(p, xi):
        return (ssm.ssm_seq(p, cfg, xi) ** 2).mean()

    def jloss(p, xi):
        return (jssm.ssm_seq(p, jcfg, xi) ** 2).mean()

    grads = torch.func.vmap(torch.func.grad(tloss))(tstack,
                                                    torch.from_numpy(x))
    jflat = _tree(jax.vmap(jax.grad(jloss))(jstack, jnp.asarray(x)))
    assert list(grads) == list(jflat)
    for name in grads:
        np.testing.assert_allclose(_np(grads[name]), _np(jflat[name]),
                                   atol=1e-5, rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# hymba-1.5b
# ---------------------------------------------------------------------------
def test_config_matches_reference_field_for_field():
    cfg, jcfg = base.get(ARCH), jbase.get(ARCH)
    _same_cfg(cfg, jcfg)
    _same_cfg(base.smoke_variant(cfg), jbase.smoke_variant(jcfg))
    assert dataclasses.asdict(cfg.ssm_cfg()) == \
        dataclasses.asdict(jcfg.ssm_cfg())
    assert cfg.ssm_cfg().d_inner == jcfg.ssm_cfg().d_inner == 1600
    assert (cfg.family, cfg.n_heads // cfg.n_kv_heads, cfg.dtype) == (
        "hybrid", 5, torch.bfloat16)
    shapes = jax.eval_shape(lambda k: jT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)) == \
        FULL_PARAMS
    smoke = base.smoke_variant(cfg)
    own = transformer.init_params(torch.Generator().manual_seed(0), smoke)
    jtree = _tree(jT.init_params(jax.random.PRNGKey(0),
                                 jbase.smoke_variant(jcfg)))
    assert list(own) == list(jtree)
    assert all(own[k].shape == jtree[k].shape for k in own)
    assert {k for k in own if k.startswith("layers.ssm.")} == {
        f"layers.ssm.{n}" for n in ("d_skip", "dt_bias", "log_a", "w_bc",
                                    "w_dt", "w_gate", "w_in", "w_out")}


def test_ssm_leaves_cross_in_float32_and_bfloat16():
    jcfg = jbase.smoke_variant(jbase.get(ARCH))
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
            np.testing.assert_array_equal(np.asarray(a, np.float32), _np(b))


@functools.lru_cache(maxsize=None)
def _smoke():
    jcfg = jbase.smoke_variant(jbase.get(ARCH))
    cfg = base.smoke_variant(base.get(ARCH))
    jparams = jT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, cfg, jparams, _tree(jparams)


def test_smoke_forward_matches_reference():
    jcfg, cfg, jparams, tparams = _smoke()
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 70))
    want, jaux = jax.jit(lambda p, t: jT.forward(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    for impl in ("auto", "torch", "kernel"):
        with torch.no_grad():
            got, aux = transformer.forward(tparams, cfg,
                                           torch.from_numpy(tokens),
                                           impl=impl)
        assert float(aux) == float(jaux) == 0.0
        np.testing.assert_allclose(_np(got), _np(want), **MODEL_TOL)


def test_smoke_prefill_and_decode_match_reference():
    """Prefill logits, K/V caches and SSM states, then 6 decode steps
    against caches grown to prompt + 6 (`grow_cache` pads k / v only)."""
    jcfg, cfg, jparams, tparams = _smoke()
    bundle = registry.build(cfg)
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=(2, 48))
    jlogits, jcache = jax.jit(lambda p, t: jT.prefill(p, jcfg, t))(
        jparams, jnp.asarray(tokens, jnp.int32))
    for impl in ("torch", "kernel"):
        logits, cache = bundle.prefill_step(
            tparams, {"tokens": torch.from_numpy(tokens)}, impl=impl,
            device="cpu")
        np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL_TOL)
        assert list(cache) == ["k", "v", "ssm_state"]
        for name in cache:
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **MODEL_TOL)
    total = tokens.shape[1] + 6
    grown = serve.grow_cache(cache, total)
    assert grown["ssm_state"] is cache["ssm_state"]
    assert grown["k"].shape[2] == total
    cache = grown
    jcache = dict(jcache, **{
        k: jnp.pad(jcache[k], [(0, 0), (0, 0), (0, total - jcache[k].shape[2]),
                               (0, 0), (0, 0)]) for k in ("k", "v")})
    jstep = jax.jit(lambda p, c, t, pos: jT.serve_step(p, jcfg, c, t, pos))
    for i in range(6):
        jtok = jnp.argmax(jlogits.reshape(2, -1), axis=-1)[:, None]
        tok = logits.reshape(2, -1).argmax(-1)[:, None]
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), f"step {i}"
        pos = tokens.shape[1] + i
        jlogits, jcache = jstep(jparams, jcache, jtok.astype(jnp.int32),
                                jnp.int32(pos))
        logits, cache = bundle.serve_step(tparams, cache, tok, pos,
                                          device="cpu")
        np.testing.assert_allclose(_np(logits), _np(jlogits), **MODEL_TOL)
        for name in cache:
            np.testing.assert_allclose(_np(cache[name]), _np(jcache[name]),
                                       **MODEL_TOL)


def test_decode_matches_forward():
    """Decoding a prompt token by token from an empty cache gives the
    forward's logits at every position."""
    _, cfg, _, tparams = _smoke()
    tokens = np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 10))
    with torch.no_grad():
        want, _ = transformer.forward(tparams, cfg, torch.from_numpy(tokens))
    cache = transformer.init_cache(cfg, 2, 10, device="cpu")
    assert tuple(cache["ssm_state"].shape) == (2, 2, 256, 16)
    for i in range(10):
        logits, cache = transformer.serve_step(
            tparams, cfg, cache, torch.from_numpy(tokens[:, i:i + 1]), i)
        np.testing.assert_allclose(_np(logits[:, 0]), _np(want[:, i]),
                                   **MODEL_TOL)


def test_bf16_dtype_discipline():
    """bfloat16 caches (K/V and SSM states) keep their dtype through a
    prefill and a decode step; logits finite; the SSM's output takes x's
    dtype and the step's state the state's (the reference's hymba
    regression)."""
    cfg = dataclasses.replace(base.smoke_variant(base.get(ARCH)),
                              dtype=torch.bfloat16)
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        logits, _ = transformer.forward(params, cfg, tokens)
    assert bool(torch.isfinite(logits).all())
    cache = bundle.init_cache(2, 8, device="cpu")
    dtypes = {k: v.dtype for k, v in cache.items()}
    assert dtypes == {"k": torch.bfloat16, "v": torch.bfloat16,
                      "ssm_state": torch.bfloat16}
    lg, new = bundle.serve_step(params, cache, tokens[:, :1], 0,
                                device="cpu")
    assert bool(torch.isfinite(lg).all())
    assert {k: v.dtype for k, v in new.items()} == dtypes
    _, pre = bundle.prefill_step(params, {"tokens": tokens}, device="cpu")
    assert {k: v.dtype for k, v in pre.items()} == dtypes
    sp = {k[len("layers.ssm."):]: v[0] for k, v in params.items()
          if k.startswith("layers.ssm.")}
    x = torch.randn(2, 5, cfg.d_model).to(torch.bfloat16)
    out, st = ssm.ssm_seq(sp, cfg.ssm_cfg(), x, return_state=True)
    assert out.dtype == torch.bfloat16 and st.dtype == torch.float32
    o, st2 = ssm.ssm_step(sp, cfg.ssm_cfg(), x[:, :1],
                          st.to(torch.bfloat16))
    assert o.dtype == torch.bfloat16 and st2.dtype == torch.bfloat16


def test_train_step_loss_matches_reference():
    """One AdamW `train_step` from the reference's weights: the loss within
    1e-5 (aux 0), then the next loss within 1e-4."""
    jcfg, cfg, jparams, tparams = _smoke()
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
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    assert float(m["aux"]) == float(jm["aux"]) == 0.0
    _, m2 = bundle.train_step(state, batch, device="cpu")
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# The slice's sim models (nwp:granite_moe_1b_a400m, nwp:dbrx_132b,
# nwp:hymba_1_5b)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", SIM_ARCHS)
def test_sim_model_forward_and_vmapped_gradient_match_reference(arch):
    """The forward, and the gradient of the next-token loss vmapped over 2
    clients' weights, against the reference's `jax.vmap(jax.grad)`."""
    name = f"nwp:{arch}"
    jm, tm = jregistry.sim_model(name), registry.sim_model(name)
    assert (tm.name, tm.model_id) == (jm.name, jm.model_id)
    _same_cfg(tm.cfg, jm.cfg)
    jps = [jax.jit(jm.init_fn)(jax.random.PRNGKey(i)) for i in range(2)]
    tp = _tree(jps[0])
    assert list(tp) == list(tm.init_fn(torch.Generator().manual_seed(0)))
    x = np.random.default_rng(1).integers(0, 90, size=(2, 12)).astype(np.int32)
    want = jax.jit(jm.apply_fn)(jps[0], jnp.asarray(x))
    got = tm.apply_fn(tp, torch.from_numpy(x))
    np.testing.assert_allclose(_np(got.detach()), _np(want), **MODEL_TOL)

    def jloss(p, t):
        lg = jm.apply_fn(p, t[:, :-1])
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(lg), t[:, 1:, None], -1))

    def tloss(p, t):
        lg = tm.apply_fn(p, t[:, :-1])
        return -torch.log_softmax(lg, -1).gather(
            -1, t[:, 1:, None].long()).mean()

    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jps)
    xs = np.stack([x, x[::-1]])
    jg = _tree(jax.vmap(jax.grad(jloss))(jstack, jnp.asarray(xs)))
    tg = torch.func.vmap(torch.func.grad(tloss))(_tree(jstack),
                                                 torch.from_numpy(xs))
    assert list(tg) == list(jg)
    for key in tg:
        np.testing.assert_allclose(_np(tg[key]), _np(jg[key]), atol=1e-5,
                                   rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("arch", SIM_ARCHS)
def test_sim_model_grid_runner_matches_run_sequential(arch):
    """`GridRunner.run` of an R&A / no-exchange grid (each round one
    `torch.func.vmap` over the group's scenarios and, inside, over the
    clients' gradients) against `run_sequential` (scenario by scenario) on
    the CPU, 2 rounds, 4 clients; finite."""
    from repro_torch.core import topology

    model = registry.sim_model(f"nwp:{arch}", vocab=90)
    data = synthetic.fed_char_stream(
        n_clients=4, vocab=90, seq_len=8, sequences_per_client=4,
        test_sequences=4, iid=False, seed=0)
    cfg = simulator.SimConfig(n_rounds=2, seg_len=256, local_epochs=1,
                              lr=0.5)
    net = topology.make_network(
        topology.TABLE_II_COORDS[:4], edge_density=0.7,
        packet_len_bits=25_000, n_clients=4, tx_power_dbm=17.0)
    grid = scenarios.ScenarioGrid.product(
        networks=[("net", net)],
        protocols=[("ra", "ra_normalized"), ("none", "ra_normalized")],
        seeds=range(2))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore",
                              simulator.PacketLengthMismatchWarning)
        runner = scenarios.GridRunner(model.init_fn, model.apply_fn, data,
                                      cfg, device="cpu")
        batched = runner.run(grid)
        seq = runner.run_sequential(grid)
    assert bool(np.isfinite(batched.loss).all()
                and np.isfinite(batched.acc).all())
    np.testing.assert_allclose(batched.loss, seq.loss, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(batched.acc, seq.acc, atol=1e-6)
