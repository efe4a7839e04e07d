"""PyTorch port vs the JAX reference: the vlm family.

The llama-3.2-vision-90b config field for field (the parameter counts of
the full config and of its 10-layer cut, and their leaves, without
allocating), the doubly-stacked self layers, and the smoke variant's and
the reference's tiny vlm config's `forward` (every impl, hidden states,
remat: self layers checkpointed, cross blocks not), `prefill` (k / v of
(groups, self layers, ...), xk, xv), `init_cache`, `serve_step` over
several steps, decode against the forward, a windowed prefill and decode,
`loss_fn` gradients (the cross layers' among them) and `train_step`,
`launch.train.main` plain and ``--dfl``; the bfloat16 forward's
`TypeError` on float32 patches (the reference's too); `grow_cache` on a
vlm cache.  Weights and tolerances as in tests/test_torch_modal.py.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_parity  # noqa: E402,F401  (caps torch's CPU threads)
import test_torch_modal as tm  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import registry, transformer  # noqa: E402

ARCH = "llama-3.2-vision-90b"
FULL_PARAMS = 86_616_121_364
CUT_LAYERS = 10                  # chip_smoke's depth cut: 2 groups of 4 + 1
CUT_PARAMS = 9_607_225_346


def test_config_matches_reference_field_for_field():
    cfg = base.get(ARCH)
    jcfg = tm.jbase.get(ARCH)
    tm.same_cfg(cfg, jcfg)
    tm.same_cfg(base.smoke_variant(cfg), tm.jbase.smoke_variant(jcfg))
    assert (cfg.family, cfg.n_heads // cfg.n_kv_heads, cfg.hd, cfg.remat,
            cfg.dtype) == ("vlm", 8, 128, True, torch.bfloat16)
    assert transformer.vlm_groups(cfg) == (20, 4)
    assert transformer.modal_len(cfg) == 1600


@pytest.mark.parametrize("which", ["full", "cut", "smoke", "tiny"])
def test_init_params_leaves_match_reference(which):
    """Names, order, shapes and dtypes of `init_params` against
    `jax.eval_shape` of the reference's (the full config and its 10-layer
    cut nothing allocated): self layers (groups, cross_attn_every - 1,
    ...), cross layers (groups, ...)."""
    if which == "tiny":
        jcfg, cfg = tm.tiny("vlm")
    elif which == "smoke":
        jcfg, cfg = tm.smoke(ARCH)
    else:
        jcfg, cfg = tm.jbase.get(ARCH), base.get(ARCH)
        if which == "cut":
            jcfg, cfg = (dataclasses.replace(c, n_layers=CUT_LAYERS)
                         for c in (jcfg, cfg))
    n = tm.shapes_match_reference(jcfg, cfg)
    if which in ("full", "cut"):
        assert n == {"full": FULL_PARAMS, "cut": CUT_PARAMS}[which]
    g, ns = transformer.vlm_groups(cfg)
    jshapes = {name: s for name, s, _ in tm.tree_shapes(jax.eval_shape(
        lambda k: tm.jT.init_params(k, jcfg), jax.random.PRNGKey(0)))}
    assert jshapes["layers.attn.wq"][:2] == (g, ns)
    assert jshapes["cross_layers.gate"] == (g, 1)
    assert list(dict.fromkeys(name.split(".")[0] for name in jshapes)) == [
        "cross_layers", "embed", "final_norm", "layers"]


def test_layer_params_and_units_walk_the_groups():
    """`units` runs each group's self layers, then its cross block, with
    views of the doubly-stacked leaves at (g, j) and the cross leaves at g."""
    _, cfg = tm.tiny("vlm")
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg)
    steps = transformer.units(params, cfg)
    assert [(kind, at) for kind, _, at in steps] == [
        ("layer", (0, 0)), ("cross", (0,)), ("layer", (1, 0)), ("cross", (1,))]
    for kind, lp, at in steps:
        stacked = "layers" if kind == "layer" else "cross_layers"
        for name, leaf in lp.items():
            assert torch.equal(leaf, transformer._at(
                params[f"{stacked}.{name}"], at))


@functools.lru_cache(maxsize=None)
def _models(which):
    jcfg, cfg = tm.tiny("vlm") if which == "tiny" else tm.smoke(ARCH)
    jp, tp = tm.weights(jcfg)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_forward_matches_reference(which):
    tm.check_forward(*_models(which))


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_prefill_and_decode_match_reference(which):
    tm.check_prefill_and_decode(*_models(which))


def test_windowed_prefill_and_decode_match_reference():
    tm.check_prefill_and_decode(*_models("tiny"), window=4)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_init_cache_matches_reference(which):
    jcfg, cfg, _, _ = _models(which)
    tm.check_init_cache(jcfg, cfg)
    full = dataclasses.replace(base.get(ARCH), n_layers=CUT_LAYERS)
    jfull = jax.eval_shape(lambda: tm.jT.init_cache(
        dataclasses.replace(tm.jbase.get(ARCH), n_layers=CUT_LAYERS), 8,
        2080))
    got = transformer.init_cache(full, 8, 2080, device="meta")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in jfull.items()}
    assert tuple(got["k"].shape) == (2, 4, 8, 2080, 8, 128)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_decode_matches_forward(which):
    _, cfg, _, tp = _models(which)
    tm.check_decode_matches_forward(cfg, tp)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_loss_and_train_step_match_reference(which):
    tm.check_loss_and_train_step(*_models(which), ("cross_layers.",
                                                   "layers."))


def test_gates_hide_the_patches_at_init():
    tm.check_gates(*tm.tiny("vlm"))


def test_launch_train_main_feeds_zero_patches():
    tm.check_train_main(ARCH, base.smoke_variant(base.get(ARCH)))


def test_bf16_forward_refuses_wider_patches_as_the_reference():
    """The reference's bfloat16 vlm `forward` does not cast float32 patch
    embeddings, and its layer scan raises a `TypeError` when the cross
    blocks turn its carry float32; the port raises a `TypeError` that says
    so (not torch's mixed-dtype product error).  Patches in the model's
    dtype, or float32 patches into a float32 model, run; the prefill and
    the loss cast as before."""
    jcfg, cfg = tm.tiny("vlm")
    jcfg, cfg = (dataclasses.replace(c, dtype=d) for c, d in
                 ((jcfg, jnp.bfloat16), (cfg, torch.bfloat16)))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 6))
    modal = tm.modal_input(cfg, 2, 1)
    jp = tm.jT.init_params(jax.random.PRNGKey(0), jcfg)
    with pytest.raises(TypeError):
        tm.jT.forward(jp, jcfg, jnp.asarray(tokens),
                      modal_embeds=jnp.asarray(modal))
    tp = tm.tree(jp)
    with pytest.raises(TypeError, match="does not cast them"):
        transformer.forward(tp, cfg, torch.from_numpy(tokens),
                            modal_embeds=torch.from_numpy(modal))
    want, _ = tm.jT.forward(jp, jcfg, jnp.asarray(tokens),
                            modal_embeds=jnp.asarray(modal, jnp.bfloat16))
    with torch.no_grad():
        got, _ = transformer.forward(
            tp, cfg, torch.from_numpy(tokens),
            modal_embeds=torch.from_numpy(modal).to(torch.bfloat16))
    scale = float(np.abs(tm.np32(want)).max())
    assert float(np.abs(tm.np32(got) - tm.np32(want)).max()) <= 3e-2 * scale
    _, cache = registry.build(cfg).prefill_step(
        tp, {"tokens": torch.from_numpy(tokens),
             "modal_embeds": torch.from_numpy(modal)}, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in cache.values())


def test_grow_cache_pads_vlm_self_kv_only():
    """On a vlm cache `grow_cache` pads the (groups, self layers, B, T, KV,
    Dh) self-attention K/V along T with zeros and leaves the cross K/V as
    they are (the same tensors)."""
    _, cfg, _, tp = _models("tiny")
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, size=(2, 5)))
    modal = torch.from_numpy(tm.modal_input(cfg, 2, 3))
    with torch.no_grad():
        _, cache = transformer.prefill(tp, cfg, tokens, modal_embeds=modal)
    grown = serve.grow_cache(cache, 9)
    assert tuple(grown["k"].shape) == (2, 1, 2, 9, 2, 16)
    for name in ("k", "v"):
        assert torch.equal(grown[name][..., :5, :, :], cache[name])
        assert not grown[name][..., 5:, :, :].any()
    assert grown["xk"] is cache["xk"] and grown["xv"] is cache["xv"]
