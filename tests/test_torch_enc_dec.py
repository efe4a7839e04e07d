"""PyTorch port vs the JAX reference: the enc_dec family.

The whisper-base config field for field (parameter count and leaves of the
full config without allocating), and the smoke variant's and the
reference's tiny enc_dec config's `forward` (every impl, hidden states,
remat), `prefill` (k, v, xk, xv), `init_cache`, `serve_step` over several
steps, decode against the forward, a windowed prefill and decode, `loss_fn`
gradients (the encoder's among them) and `train_step`, and
`launch.train.main` plain and ``--dfl``.  Weights are the reference's
init through `interop`, with every cross block's ``gate`` set from a
numpy seed first (tests/test_torch_modal.py holds the shared checks);
inputs are drawn with numpy.  Tolerances: 1e-5 in float32 for a layer,
1e-4 for whole prefills, caches, decodes and losses after a step; greedy
ids exactly equal.
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

ARCH = "whisper-base"
FULL_PARAMS = 70_627_846
DEC_LEAVES = ["attn", "gate", "ln1", "ln2", "lnx", "mlp", "xattn"]


def test_config_matches_reference_field_for_field():
    cfg = base.get(ARCH)
    jcfg = tm.jbase.get(ARCH)
    tm.same_cfg(cfg, jcfg)
    tm.same_cfg(base.smoke_variant(cfg), tm.jbase.smoke_variant(jcfg))
    assert (cfg.family, cfg.n_enc_layers, cfg.enc_seq, cfg.dtype) == (
        "enc_dec", 6, 1500, torch.bfloat16)
    assert transformer.modal_len(cfg) == 1500


@pytest.mark.parametrize("which", ["full", "smoke", "tiny"])
def test_init_params_leaves_match_reference(which):
    """Names, order, shapes and dtypes of `init_params` against
    `jax.eval_shape` of the reference's (the full config nothing
    allocated); a decoder layer's seven sub-trees (the cross block's ln2
    and mlp replace the dense block's)."""
    if which == "tiny":
        jcfg, cfg = tm.tiny("enc_dec")
    else:
        jcfg, cfg = tm.jbase.get(ARCH), base.get(ARCH)
        if which == "smoke":
            jcfg, cfg = tm.smoke(ARCH)
    n = tm.shapes_match_reference(jcfg, cfg)
    if which == "full":
        assert n == FULL_PARAMS
    jshapes = tm.tree_shapes(jax.eval_shape(
        lambda k: tm.jT.init_params(k, jcfg), jax.random.PRNGKey(0)))
    assert sorted({name.split(".")[1] for name, _, _ in jshapes
                   if name.startswith("layers.")}) == DEC_LEAVES
    tops = list(dict.fromkeys(name.split(".")[0] for name, _, _ in jshapes))
    assert tops == ["embed", "enc_layers", "enc_norm", "final_norm",
                    "layers"]


@functools.lru_cache(maxsize=None)
def _models(which):
    jcfg, cfg = tm.tiny("enc_dec") if which == "tiny" else tm.smoke(ARCH)
    jp, tp = tm.weights(jcfg)
    return jcfg, cfg, jp, tp


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_forward_matches_reference(which):
    tm.check_forward(*_models(which))


def test_forward_with_qkv_bias_matches_reference():
    """With QKV biases (drawn non-zero) the forward's cross-attention adds
    them and the prefill's cross cache does not, as the reference's."""
    jcfg, cfg = tm.tiny("enc_dec")
    jcfg, cfg = (dataclasses.replace(c, qkv_bias=True) for c in (jcfg, cfg))
    rng = np.random.default_rng(2)
    jp = tm.gated(tm.jT.init_params(jax.random.PRNGKey(1), jcfg), 3)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, v: (jnp.asarray(rng.normal(size=v.shape), v.dtype)
                         if path[-1].key in ("bq", "bk", "bv") else v), jp)
    tm.check_forward(jcfg, cfg, jp, tm.tree(jp))
    tm.check_prefill_and_decode(jcfg, cfg, jp, tm.tree(jp), steps=3)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_prefill_and_decode_match_reference(which):
    tm.check_prefill_and_decode(*_models(which))


def test_windowed_prefill_and_decode_match_reference():
    """A window of 4 on the decoder's self-attention (the encoder is never
    windowed); the decode steps' window mask against the grown cache."""
    tm.check_prefill_and_decode(*_models("tiny"), window=4)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_init_cache_matches_reference(which):
    jcfg, cfg, _, _ = _models(which)
    tm.check_init_cache(jcfg, cfg)
    jfull = jax.eval_shape(lambda: tm.jT.init_cache(tm.jbase.get(ARCH), 8,
                                                    448))
    full = transformer.init_cache(base.get(ARCH), 8, 448, device="meta")
    assert {k: tuple(v.shape) for k, v in full.items()} == {
        k: v.shape for k, v in jfull.items()}
    assert tuple(full["xk"].shape) == (6, 8, 1500, 8, 64)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_decode_matches_forward(which):
    _, cfg, _, tp = _models(which)
    tm.check_decode_matches_forward(cfg, tp)


@pytest.mark.parametrize("which", ["tiny", "smoke"])
def test_loss_and_train_step_match_reference(which):
    """The gradients of the encoder's leaves (enc_layers.*, enc_norm.*) and
    the decoder's cross blocks (layers.xattn.*, layers.gate) are non-zero
    and match the reference's."""
    tm.check_loss_and_train_step(
        *_models(which), ("enc_layers.", "enc_norm.", "layers.xattn.",
                          "layers.gate"))


def test_gates_hide_the_encoder_at_init():
    tm.check_gates(*tm.tiny("enc_dec"))


def test_launch_train_main_feeds_zero_frames():
    tm.check_train_main(ARCH, base.smoke_variant(base.get(ARCH)))


def test_bf16_prefill_casts_frames_and_keeps_cache_dtypes():
    """A bfloat16 model prefills float32 frames (cast, as the reference
    casts them for enc_dec in `forward` and `prefill`): every cache leaf
    bfloat16, and a decode step keeps them so; the forward takes the same
    float32 frames."""
    cfg = dataclasses.replace(base.smoke_variant(base.get(ARCH)),
                              dtype=torch.bfloat16)
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 8),
                           generator=torch.Generator().manual_seed(1))
    modal = torch.from_numpy(tm.modal_input(cfg, 2, 2))
    logits, cache = bundle.prefill_step(
        params, {"tokens": tokens, "modal_embeds": modal}, device="cpu")
    assert bool(torch.isfinite(logits).all())
    assert {k: v.dtype for k, v in cache.items()} == dict.fromkeys(
        ("k", "v", "xk", "xv"), torch.bfloat16)
    cache = serve.grow_cache(cache, 9)
    lg, new = bundle.serve_step(params, cache, tokens[:, :1], 8,
                                device="cpu")
    assert bool(torch.isfinite(lg).all())
    assert all(v.dtype == torch.bfloat16 for v in new.values())
    with torch.no_grad():
        out, _ = transformer.forward(params, cfg, tokens, modal_embeds=modal)
    assert bool(torch.isfinite(out).all())
