"""PyTorch port vs the JAX reference: the training path.

  * `registry` loss / train step on the float32 smoke qwen2.5 and rwkv6
    models (loss within 1e-5, parameters and AdamW moments after one step
    within 1e-4), the chunked loss, and per-layer remat (the same numbers);
  * the pytree round wrappers `ra_round` / `aayg_round` / `cfl_round` /
    `ideal_cfl_round` fed the reference's uniforms (masks equal, values
    within 1e-6);
  * one `build_sim` round of a tiny ResNet and CharRNN against the
    reference's `round_step` (parameters and losses within 1e-4, accuracy
    within one test sample), through `registry.sim_model`;
  * `launch.train.main` on the CPU, plain and ``--dfl``;
  * the kernels' refusal of autograd (`ops.refuse_autograd`), whose CPU
    tensors the plain path serves.
"""
import dataclasses
import functools
import sys
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the AdamW step's parity rule)
import repro_torch  # noqa: E402
from _torch_parity import round_uniforms  # noqa: E402
from repro.configs import base as jbase  # noqa: E402
from repro.core import protocols as jprot  # noqa: E402
from repro.core import routing as jrouting  # noqa: E402
from repro.core import topology as jtopology  # noqa: E402
from repro.data import synthetic as jsynthetic  # noqa: E402
from repro.fl import simulator as jsimulator  # noqa: E402
from repro.models import registry as jregistry  # noqa: E402
from repro.models import smallnets as jsmall  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.core import protocols, topology  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.fl import simulator  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402


def _tree(jtree):
    return interop.params_from_jax(jax.tree.map(np.asarray, jtree))


def _close(got: dict, want: dict, atol):
    assert list(got) == list(want)
    for name, leaf in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), leaf.numpy(),
                                   atol=atol, rtol=atol, err_msg=name)


@functools.lru_cache(maxsize=None)
def _smoke(arch: str, chunk: int = 0):
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get(arch)),
                               loss_vocab_chunk=chunk)
    cfg = dataclasses.replace(base.smoke_variant(base.get(arch)),
                              loss_vocab_chunk=chunk)
    jparams = jax.jit(lambda k: jregistry.build(jcfg).init(k))(
        jax.random.PRNGKey(0))
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 24)).astype(np.int32)
    return jcfg, cfg, jparams, tokens


@functools.lru_cache(maxsize=None)
def _reference_loss(arch: str, chunk: int = 0):
    """The reference's loss, metrics and gradient at its smoke weights."""
    jcfg, _, jparams, tokens = _smoke(arch, chunk)
    jb = jregistry.build(jcfg)
    (total, m), grad = jax.jit(jax.value_and_grad(
        lambda p: jb.loss_fn(p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True))(jparams)
    return float(total), {k: float(v) for k, v in m.items()}, _tree(grad)


@pytest.mark.parametrize("arch,chunk", [("qwen2.5-3b", 0), ("rwkv6-1.6b", 0),
                                        ("qwen2.5-3b", 100)],
                         ids=["qwen", "rwkv6", "qwen-chunked"])
def test_loss_fn_matches_reference(arch, chunk):
    _, cfg, jparams, tokens = _smoke(arch, chunk)
    want, jm, _ = _reference_loss(arch, chunk)
    got, m = registry.build(cfg).loss_fn(
        _tree(jparams), {"tokens": torch.from_numpy(tokens)}, device="cpu")
    np.testing.assert_allclose(float(got), want, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(m["loss"]), jm["loss"], atol=1e-5,
                               rtol=1e-5)
    assert float(m["aux"]) == jm["aux"] == 0.0


def _one_step(arch, optimizer, lr):
    """One train step of both packages from the same weights and tokens,
    and the reference's gradient at those weights."""
    jcfg, cfg, jparams, tokens = _smoke(arch)
    jb = jregistry.build(jcfg, optimizer=optimizer, lr=lr)
    b = registry.build(cfg, optimizer=optimizer, lr=lr)
    batch = {"tokens": jnp.asarray(tokens)}
    jstate = {"params": jparams, "opt": jb.optimizer.init(jparams)}
    jstate, jm = jax.jit(lambda s: jb.train_step(s, batch))(jstate)
    tp = _tree(jparams)
    state = {"params": tp, "opt": b.optimizer.init(tp)}
    state, m = b.train_step(state, {"tokens": torch.from_numpy(tokens)},
                            device="cpu")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               atol=1e-5, rtol=1e-5)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 1
    return state, jstate, _reference_loss(arch)[2]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b"])
def test_loss_gradient_and_sgd_step_match_reference(arch):
    """The gradient within 1e-5, and one plain SGD step (lr 0.5) within
    1e-4."""
    _, cfg, jparams, tokens = _smoke(arch)
    params = {k: v.requires_grad_() for k, v in _tree(jparams).items()}
    loss, _ = registry.build(cfg).loss_fn(
        params, {"tokens": torch.from_numpy(tokens)}, device="cpu")
    grads = dict(zip(params, torch.autograd.grad(loss,
                                                 list(params.values()))))
    state, jstate, jgrad = _one_step(arch, "sgd", 0.5)
    _close(grads, jgrad, 1e-5)
    _close(state["params"], _tree(jstate["params"]), 1e-4)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b"])
def test_adamw_train_step_matches_reference(arch):
    """One AdamW step (the bundle's default: lr 3e-4, eps 1e-8, float32
    moments): the moments within 1e-4 everywhere, the parameters within
    1e-4 wherever the gradient stands above float32 noise (|g| >= 1e-6).
    A first Adam step is g / (|g| + eps) * lr, so where |g| is near eps
    the two packages' last-bit gradient differences move a parameter by
    up to ~lr apart (the local AdamW's sensitivity, ROADMAP.md Queue 3);
    there the step is held to its bound, 2 lr (1 + wd |p|).  The rule is
    `chip_smoke._adamw_gap`'s, which holds the card to the CPU.  Run with
    -s to print how many parameters departed."""
    lr = 3e-4
    state, jstate, jgrad = _one_step(arch, "adamw", lr)
    assert all(v.dtype == torch.float32 for v in state["opt"]["m"].values())
    for name in ("m", "v"):
        _close(state["opt"][name], _tree(jstate["opt"][name]), 1e-4)
    worst, departed = chip_smoke._adamw_gap(
        state["params"], _tree(jstate["params"]), jgrad, lr)
    assert worst <= 1e-4
    print(f"\n{arch}: {departed} parameters apart by more than 1e-4 after "
          f"one AdamW step, each with |g| < 1e-6")


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
def test_adamw_three_steps_match_reference(arch, dtype, tol):
    """Three AdamW steps at lr 3e-4 on three batches, float32 and bf16
    parameters (the optimizer rounds each new parameter back to bf16 in
    both packages): every step's loss within ``tol``.  bf16: a third of
    one bf16 ulp at the loss's size (0.03125 in [4, 8)); read 4.9e-4
    (qwen2.5) and 2.1e-3 (rwkv6).  The multi-step behaviour of
    chip_smoke's full-width runs is AdamW's own, not the port's."""
    jcfg = dataclasses.replace(jbase.smoke_variant(jbase.get(arch)),
                               dtype=getattr(jnp, dtype))
    cfg = dataclasses.replace(base.smoke_variant(base.get(arch)),
                              dtype=getattr(torch, dtype))
    jb, b = jregistry.build(jcfg, lr=3e-4), registry.build(cfg, lr=3e-4)
    jparams = jax.jit(jb.init)(jax.random.PRNGKey(0))
    params = _tree(jparams)
    assert all(v.dtype == getattr(torch, dtype) for v in params.values())
    jstate = {"params": jparams, "opt": jb.optimizer.init(jparams)}
    state = {"params": params, "opt": b.optimizer.init(params)}
    jstep = jax.jit(jb.train_step)
    rng = np.random.default_rng(1)
    for _ in range(3):
        tokens = rng.integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        state, m = b.train_step(state, {"tokens": torch.from_numpy(tokens)},
                                device="cpu")
        assert abs(float(m["loss"]) - float(jm["loss"])) <= tol


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b"])
def test_remat_keeps_the_numbers(arch):
    """Per-layer `torch.utils.checkpoint` recomputes the same values: the
    loss and every gradient are bit for bit those without it."""
    _, cfg, jparams, tokens = _smoke(arch)
    out = []
    for remat in (False, True):
        b = registry.build(dataclasses.replace(cfg, remat=remat))
        params = {k: v.clone().requires_grad_()
                  for k, v in _tree(jparams).items()}
        loss, _ = b.loss_fn(params, {"tokens": torch.from_numpy(tokens)},
                            device="cpu")
        out.append((loss, torch.autograd.grad(loss, list(params.values()))))
    assert torch.equal(out[0][0], out[1][0])
    for a, c in zip(out[0][1], out[1][1]):
        assert torch.equal(a, c)


def test_train_impl_is_the_reference_training_forward():
    cfg = base.smoke_variant(base.get("qwen2.5-3b"))
    assert cfg.attn_impl == "naive"
    assert transformer.train_impl(cfg) == "torch"
    for name in ("chunked", "flash"):
        assert transformer.train_impl(
            dataclasses.replace(cfg, attn_impl=name)) == name
    with pytest.raises(ValueError, match="attn_impl must be one of"):
        transformer.train_impl(dataclasses.replace(cfg, attn_impl="pallas"))


# ---------------------------------------------------------------------------
# The kernels refuse autograd
# ---------------------------------------------------------------------------
def test_refuse_autograd_covers_autograd_and_torch_func():
    x = torch.randn(3)
    ops.refuse_autograd("k", (x,))                      # plain tensor
    y = x.clone().requires_grad_()
    with torch.no_grad():
        ops.refuse_autograd("k", (y,))                  # no graph recorded
    with pytest.raises(RuntimeError, match="Queue 2"):
        ops.refuse_autograd("k", (y,))

    def f(t):
        ops.refuse_autograd("k", (t,))
        return t.sum()

    for transform in (torch.func.grad(f), torch.func.vmap(torch.func.grad(f)),
                      torch.func.grad(lambda t: torch.func.vmap(f)(t).sum())):
        with pytest.raises(RuntimeError, match="no backward"):
            transform(torch.randn(2, 3))
    torch.func.vmap(f)(torch.randn(2, 3))               # vmap alone is fine


def test_functorch_probes():
    """The package's one reader of torch's private functorch API, which
    `refuse_autograd` and `forward`'s remat gate share: nothing outside a
    transform, a transform but no gradient under vmap, both under grad
    (also through vmap's batched wrapper)."""
    x = torch.randn(2, 3)
    assert not repro_torch.func_transform_active()
    assert not repro_torch.grad_tracking(x.requires_grad_())
    seen = []

    def f(t):
        seen.append((repro_torch.func_transform_active(),
                     repro_torch.grad_tracking(t)))
        return t.sum()

    torch.func.vmap(f)(x.detach())
    torch.func.grad(f)(x.detach())
    torch.func.vmap(torch.func.grad(f))(x.detach())
    assert seen == [(True, False), (True, True), (True, True)]


# ---------------------------------------------------------------------------
# The pytree round wrappers
# ---------------------------------------------------------------------------
N = 10


@functools.lru_cache(maxsize=None)
def _round_setup():
    net = jtopology.make_network(jtopology.TABLE_II_COORDS,
                                 packet_len_bits=100_000, tx_power_dbm=17.0)
    link_eps = np.array(net.link_eps)
    rho = np.array(jrouting.e2e_success(jnp.asarray(link_eps))[0])
    rng = np.random.default_rng(4)
    stacked = {"a.b": rng.normal(size=(N, 7)).astype(np.float32),
               "a.w": rng.normal(size=(N, 5, 6)).astype(np.float32),
               "z": rng.normal(size=(N, 3, 2, 2)).astype(np.float32)}
    p = (rng.random(N) + 0.1).astype(np.float32)
    return stacked, p / p.sum(), link_eps, rho


def _jstacked(stacked):
    return {"a": {"b": jnp.asarray(stacked["a.b"]),
                  "w": jnp.asarray(stacked["a.w"])},
            "z": jnp.asarray(stacked["z"])}


@pytest.mark.parametrize("protocol,mode", [
    (p, m) for p in ("ra", "aayg", "cfl")
    for m in ("ra_normalized", "substitution")] + [("ideal_cfl", None)])
def test_pytree_round_wrappers_match_reference(protocol, mode, seg_len=8):
    stacked, p, link_eps, rho = _round_setup()
    m_params = sum(v[0].size for v in stacked.values())
    n_seg = -(-m_params // seg_len)
    key = jax.random.PRNGKey(3)
    js, t = _jstacked(stacked), {k: torch.from_numpy(v)
                                 for k, v in stacked.items()}
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    if protocol == "ra":
        want, je = jprot.ra_round(js, jp, jnp.asarray(rho), key,
                                  seg_len=seg_len, mode=mode)
        got, e = protocols.ra_round(
            t, tp, torch.from_numpy(rho), seg_len=seg_len, mode=mode,
            u=round_uniforms("ra", key, N, n_seg))
        np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    elif protocol == "aayg":
        want = jprot.aayg_round(js, jp, jnp.asarray(link_eps), key,
                                seg_len=seg_len, mode=mode, n_mixes=2)
        got = protocols.aayg_round(
            t, tp, torch.from_numpy(link_eps), seg_len=seg_len, mode=mode,
            n_mixes=2, u=round_uniforms("aayg", key, N, n_seg, n_mixes=2))
    elif protocol == "cfl":
        want = jprot.cfl_round(js, jp, jnp.asarray(rho), key, seg_len=seg_len,
                               mode=mode, aggregator=6)
        got = protocols.cfl_round(
            t, tp, torch.from_numpy(rho), seg_len=seg_len, mode=mode,
            aggregator=6, u=round_uniforms("cfl", key, N, n_seg))
    else:
        want = jprot.ideal_cfl_round(js, jp, seg_len=seg_len)
        got = protocols.ideal_cfl_round(t, tp, seg_len=seg_len)
    _close(got, _tree(want), 1e-6)


# ---------------------------------------------------------------------------
# One simulator round of the paper's ResNet and CharRNN
# ---------------------------------------------------------------------------
def _image_data(pkg):
    data = pkg.fed_image_classification(n_clients=N, d=8 * 8 * 3,
                                        samples_per_client=6, test_size=40)
    shape = (-1, 8, 8, 3)
    return dataclasses.replace(
        data, train_x=[x.reshape(shape) for x in data.train_x],
        test_x=data.test_x.reshape(shape))


def _char_data(pkg):
    return pkg.fed_char_stream(n_clients=N, seq_len=6,
                               sequences_per_client=4, test_sequences=8,
                               iid=False)


@pytest.mark.parametrize("model,protocol", [("resnet", "ra"),
                                            ("charrnn", "aayg"),
                                            ("charrnn", "ra")])
def test_sim_model_round_matches_reference(model, protocol):
    if model == "resnet":
        kw = dict(depth=8, width=4)
        jdata, tdata = _image_data(jsynthetic), _image_data(synthetic)
    else:
        kw = dict(hidden=16)
        jdata, tdata = _char_data(jsynthetic), _char_data(synthetic)
    jm, tm = jregistry.sim_model(model), registry.sim_model(model)
    assert jm.model_id == tm.model_id
    jinit = functools.partial(jm.init_fn, **kw)
    statics = dict(seg_len=64, local_epochs=2, n_rounds=1)
    jsim = jsimulator.build_sim(jinit, jm.apply_fn, jdata, agg_impl="jnp",
                                **statics)
    jnet = jtopology.make_network(
        jtopology.TABLE_II_COORDS, edge_density=0.5, packet_len_bits=100_000,
        n_clients=N, tx_power_dbm=17.0)
    tnet = dataclasses.replace(
        topology.make_network(topology.TABLE_II_COORDS, edge_density=0.5,
                              packet_len_bits=100_000, n_clients=N,
                              tx_power_dbm=17.0),
        link_eps=torch.from_numpy(np.array(jnet.link_eps)))
    cfg = simulator.SimConfig(protocol=protocol, lr=0.1, **statics)
    jcfg = jsimulator.SimConfig(protocol=protocol, lr=0.1, **statics)
    with warnings.catch_warnings():   # 100,000-bit PER vs K-value segments
        warnings.simplefilter("ignore")
        jsc = jsimulator.make_scenario(jnet, jcfg).prepare()
        tsc = simulator.make_scenario(tnet, cfg)
    params0 = jax.jit(jinit)(jax.random.PRNGKey(0))
    tparams0 = _tree(params0)
    tsim = simulator.build_sim(lambda g: tparams0, tm.apply_fn, tdata,
                               device="cpu", **statics)
    assert tsim.n_segments == jsim.n_segments
    key = jax.random.PRNGKey(1)
    jstate = {"params": jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (N,) + x.shape), params0)}
    jstate, jmet = jax.jit(jsim.round_step)(jstate, key, jsc)
    tstate = {"params": {k: v[None].expand((N,) + tuple(v.shape))
                         for k, v in tparams0.items()}}
    tstate, tmet = tsim.round_step(
        tstate, tsc, u=round_uniforms(protocol, key, N, tsim.n_segments))
    _close(tstate["params"], _tree(jstate["params"]), 1e-4)
    np.testing.assert_allclose(tmet["loss"].numpy(), np.asarray(jmet["loss"]),
                               atol=1e-4, rtol=0)
    test_n = tdata.test_y.size       # tokens: accuracy averages over B * S
    gap = np.abs(tmet["acc"].numpy() - np.asarray(jmet["acc"]))
    assert gap.max() <= 1.0 / test_n + 1e-6


# ---------------------------------------------------------------------------
# launch.train
# ---------------------------------------------------------------------------
TINY = ["--device", "cpu", "--batch", "2", "--seq", "16"]


def test_train_main_plain_loop_learns_and_checkpoints(tmp_path):
    from repro_torch.checkpoint import checkpoint

    out = train.main(TINY + ["--steps", "6", "--lr", "1e-2",
                             "--checkpoint", str(tmp_path / "ck")])
    assert len(out["losses"]) == len(out["step_s"]) == 6
    assert np.all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert out["k1_launches"] == 0          # no exchange in the plain loop
    bundle = registry.build(out["cfg"])
    init = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    saved = checkpoint.restore(str(tmp_path / "ck"), init)
    assert checkpoint.latest_step(str(tmp_path / "ck")) == 6
    assert list(saved) == list(init)
    assert all(torch.isfinite(v).all() for v in saved.values())
    assert not torch.equal(saved["embed.table"], init["embed.table"])


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "rwkv6-1.6b"])
def test_train_main_dfl_exchanges_through_ra_round(arch, capsys):
    out = train.main(TINY + ["--arch", arch, "--dfl", "--clients", "3",
                             "--steps", "4", "--rounds-per-exchange", "2"])
    assert len(out["round_losses"]) == 2
    assert len(out["losses"]) == 3 * 4
    assert np.all(np.isfinite(out["round_losses"]))
    assert "round   1 mean client loss" in capsys.readouterr().out
