"""Transformer assembly, functional PyTorch: dense / MoE / SSM / hybrid /
enc-dec / VLM.

Port of the reference package's `models/transformer.py`: `ModelCfg`, init,
the full forward, `prefill` (builds the decode cache, returns last-token
logits) and `serve_step` (one token against the cache), with the sliding
window throughout (the window mask in the forward and prefill,
`init_cache(window=)`'s wrapped cache of at most ``window`` slots,
`serve_step`'s ``abs_pos`` / ``full_cache``).  Per layer:

  dense   : {ln1, attn, ln2, mlp}  (GQA + RoPE + optional QKV bias;
                                    qwen2.5, llama3, starcoder2, gemma)
  moe     : {ln1, attn, ln2, moe}                  (granite-moe, dbrx)
  ssm     : {ln1, rwkv6 time-mix, ln2, mlp}                        (rwkv6)
  hybrid  : {ln1, attn ∥ selective ssm (0.5 (a + s)), ln2, mlp}   (hymba)
  enc_dec : encoder {ln1, bidirectional attn, ln2, mlp} + enc_norm;
            decoder {ln1, causal attn, lnx, cross-attn, ln2, mlp} (whisper)
  vlm     : groups of (cross_attn_every - 1) self layers + 1 gated
            cross-attention layer to the modal embeddings
                                                    (llama-3.2-vision)

A cross block adds ``tanh(gate) * cross_attention`` with ``gate`` drawn as
zero, as the reference's does, so at init neither the cross-attention
nor, for enc_dec, the encoder reaches the logits (only the prefill's
cross K/V cache ``xk`` / ``xv`` sees them).  The modal inputs are
precomputed frame or patch embeddings (B, T, d_model); the front ends are
stubs in the reference too.

`forward` returns the sum of the layers' MoE load-balance losses (0 for
the other families).  As in the reference, gemma's embeddings are scaled by
sqrt(d_model) in `forward` only; `prefill` and `serve_step` embed without
it.

Parameters are a flat ``dict[str, Tensor]`` in the reference's leaf order
(sorted keys, dotted names: "embed.table", "final_norm.scale",
"layers.attn.bk", ..., "layers.mlp.w_up").  Layer leaves are stacked on a
leading ``(n_layers, ...)`` axis as the reference stacks them (the vlm's
self layers on two, (groups, cross_attn_every - 1, ...)), so
`interop.params_from_jax` maps one tree onto the other leaf for leaf; the
reference's `lax.scan` over layers is a Python loop over that axis here
(`units` lists the loop's steps).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from .. import func_transform_active
from . import layers as L
from . import moe as M
from . import ssm as S

Params = dict[str, torch.Tensor]
FAMILIES = ("dense", "moe", "ssm", "hybrid", "enc_dec", "vlm")


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                  # dense | moe | ssm | hybrid | enc_dec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    act: str = "swiglu"
    qkv_bias: bool = False
    rope_theta: float = 500_000.0
    norm: str = "rmsnorm"
    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_group_size: int = 1024
    # ssm / hybrid
    d_state: int = 16
    rwkv_heads: int = 0
    # vlm
    cross_attn_every: int = 0
    n_modal_tokens: int = 0
    # enc_dec
    n_enc_layers: int = 0
    enc_seq: int = 0
    # decode / long context
    sliding_window: int | None = None
    dtype: Any = torch.float32
    remat: bool = False
    # perf knobs of the reference (its XLA lowering); kept as data
    attn_impl: str = "naive"
    attn_chunk: int = 512
    loss_vocab_chunk: int = 0
    scan_unroll: bool = False
    source: str = ""             # citation for the config

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def attn_cfg(self, *, causal: bool = True,
                 window: int | None = None) -> L.AttnCfg:
        return L.AttnCfg(d_model=self.d_model, n_heads=self.n_heads,
                         n_kv_heads=self.n_kv_heads, head_dim=self.hd,
                         qkv_bias=self.qkv_bias, rope=True,
                         rope_theta=self.rope_theta, causal=causal,
                         sliding_window=window)

    def moe_cfg(self) -> M.MoECfg:
        return M.MoECfg(d_model=self.d_model, d_ff=self.d_ff,
                        n_experts=self.n_experts, top_k=self.top_k,
                        act=self.act, capacity_factor=self.capacity_factor,
                        group_size=self.moe_group_size)

    def ssm_cfg(self) -> S.SSMCfg:
        return S.SSMCfg(d_model=self.d_model, d_state=self.d_state)

    def rwkv_cfg(self) -> S.RWKV6Cfg:
        return S.RWKV6Cfg(d_model=self.d_model,
                          n_heads=self.rwkv_heads or self.n_heads or 16)


def check_family(cfg: ModelCfg) -> None:
    """Raise for a family the reference does not have."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}; one of "
                         f"{FAMILIES}")


def _norm_init(cfg: ModelCfg):
    return L.init_rmsnorm if cfg.norm == "rmsnorm" else L.init_layernorm


def _norm(cfg: ModelCfg):
    return L.rmsnorm if cfg.norm == "rmsnorm" else L.layernorm


def _sub(params: Params, prefix: str) -> Params:
    """The leaves under ``prefix.``, with the prefix taken off."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in params.items() if k.startswith(prefix + ".")}


def _prefixed(prefix: str, params: Params) -> Params:
    return {f"{prefix}.{k}": v for k, v in params.items()}


def vlm_groups(cfg: ModelCfg) -> tuple[int, int]:
    """The vlm's (groups, self layers a group): n_layers / cross_attn_every
    groups of cross_attn_every - 1 self layers and one cross layer."""
    return cfg.n_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1


def modal_len(cfg: ModelCfg) -> int:
    """The modal input's length T: enc_seq frames (enc_dec) or
    n_modal_tokens patches (vlm)."""
    return cfg.enc_seq if cfg.family == "enc_dec" else cfg.n_modal_tokens


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _init_block(gen: torch.Generator, cfg: ModelCfg) -> Params:
    """One decoder layer (unstacked)."""
    dev = gen.device
    # Draw order as the reference's split keys: the mixer, the MLP (or the
    # experts), then the hybrid's SSM.
    if cfg.family == "ssm":
        p = _prefixed("mix", S.init_rwkv6(gen, cfg.rwkv_cfg(), cfg.dtype))
    else:
        p = _prefixed("attn", L.init_attention(gen, cfg.attn_cfg(),
                                               cfg.dtype))
    if cfg.family == "moe":
        p.update(_prefixed("moe", M.init_moe(gen, cfg.moe_cfg(), cfg.dtype)))
    else:
        p.update(_prefixed("mlp", L.init_mlp(gen, cfg.d_model, cfg.d_ff,
                                             cfg.act, cfg.dtype)))
    if cfg.family == "hybrid":
        p.update(_prefixed("ssm", S.init_ssm(gen, cfg.ssm_cfg(), cfg.dtype)))
    p.update(_prefixed("ln1", _norm_init(cfg)(cfg.d_model, cfg.dtype, dev)))
    p.update(_prefixed("ln2", _norm_init(cfg)(cfg.d_model, cfg.dtype, dev)))
    return dict(sorted(p.items()))


def _init_cross_block(gen: torch.Generator, cfg: ModelCfg) -> Params:
    """One gated cross-attention block (unstacked): lnx, xattn, ln2, mlp and
    the gate, drawn as zero (tanh-gated, llama-vision)."""
    dev = gen.device
    p = _prefixed("xattn", L.init_attention(gen, cfg.attn_cfg(causal=False),
                                            cfg.dtype))
    p.update(_prefixed("mlp", L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                         cfg.dtype)))
    p.update(_prefixed("lnx", _norm_init(cfg)(cfg.d_model, cfg.dtype, dev)))
    p.update(_prefixed("ln2", _norm_init(cfg)(cfg.d_model, cfg.dtype, dev)))
    p["gate"] = torch.zeros((1,), dtype=cfg.dtype, device=dev)
    return dict(sorted(p.items()))


def _init_dec_block(gen: torch.Generator, cfg: ModelCfg) -> Params:
    """One enc_dec decoder layer (unstacked): the dense block's ln1 and
    causal attention, and a cross block, whose ln2 and mlp are the layer's
    (the reference updates the dense block with the cross block's leaves,
    so its own ln2 and mlp are dropped; they are not drawn here)."""
    p = _prefixed("attn", L.init_attention(gen, cfg.attn_cfg(), cfg.dtype))
    p.update(_prefixed("ln1", _norm_init(cfg)(cfg.d_model, cfg.dtype,
                                              gen.device)))
    p.update(_init_cross_block(gen, cfg))
    return dict(sorted(p.items()))


def _stack(blocks: list[Params]) -> Params:
    """Leaf-wise stack of unstacked blocks along a new leading axis, each
    block's copy freed as soon as its leaf is stacked."""
    out = {}
    for name in list(blocks[0]):
        out[name] = torch.stack([blk[name] for blk in blocks])
        for blk in blocks:
            del blk[name]
    return out


def init_params(gen: torch.Generator, cfg: ModelCfg) -> Params:
    """The full model, drawn with ``gen`` on ``gen.device`` (layer leaves
    stacked: (n_layers, ...); the vlm's self layers (groups,
    cross_attn_every - 1, ...) and its cross layers (groups, ...))."""
    check_family(cfg)
    embed = _prefixed("embed", L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                                cfg.dtype))
    final = _prefixed("final_norm", _norm_init(cfg)(cfg.d_model, cfg.dtype,
                                                    gen.device))
    if cfg.family == "vlm":
        g, ns = vlm_groups(cfg)
        layers = _stack([_stack([_init_block(gen, cfg) for _ in range(ns)])
                         for _ in range(g)])
        cross = _stack([_init_cross_block(gen, cfg) for _ in range(g)])
        return {**_prefixed("cross_layers", cross), **embed, **final,
                **_prefixed("layers", layers)}
    if cfg.family == "enc_dec":
        enc = _stack([_init_block(gen, cfg) for _ in range(cfg.n_enc_layers)])
        enc_norm = _norm_init(cfg)(cfg.d_model, cfg.dtype, gen.device)
        dec = _stack([_init_dec_block(gen, cfg) for _ in range(cfg.n_layers)])
        return {**embed, **_prefixed("enc_layers", enc),
                **_prefixed("enc_norm", enc_norm), **final,
                **_prefixed("layers", dec)}
    layers = _stack([_init_block(gen, cfg) for _ in range(cfg.n_layers)])
    return {**embed, **final, **_prefixed("layers", layers)}


def layer_params(params: Params, n_layers: int,
                 prefix: str | None = "layers") -> list[Params]:
    """Per-layer views of the stacked leaves under ``prefix`` (all of
    ``params`` with None).  `torch.unbind` makes them, so a gradient
    reaches each stacked leaf as one stack of the layers' gradients, not as
    one full-size scatter a layer.  A doubly-stacked leaf (the vlm's self
    layers) gives views still stacked on the second axis."""
    stacked = params if prefix is None else _sub(params, prefix)
    views = [v.unbind(0) for v in stacked.values()]
    return [dict(zip(stacked, vals)) for vals in zip(*views)][:n_layers]


def units(params: Params, cfg: ModelCfg) -> list[tuple[str, Params, tuple]]:
    """The layer loop's steps in order, as (kind, leaves, where the step's
    entries sit in the stacked decode cache):

      "layer"    a dense / moe / ssm / hybrid layer, or a vlm self layer
                 ((g, j) in the vlm's (groups, self layers) cache);
      "enc"      an enc_dec encoder layer (bidirectional; not cached);
      "enc_norm" the encoder's final norm;
      "dec"      an enc_dec decoder layer (self-attention, then a cross
                 block on the encoder's output);
      "cross"    a vlm cross block (on the modal embeddings)."""
    if cfg.family == "vlm":
        g, ns = vlm_groups(cfg)
        cross = layer_params(params, g, "cross_layers")
        out = []
        for gi, group in enumerate(layer_params(params, g)):
            out += [("layer", lp, (gi, j))
                    for j, lp in enumerate(layer_params(group, ns, None))]
            out.append(("cross", cross[gi], (gi,)))
        return out
    dec = [("layer", lp, (i,))
           for i, lp in enumerate(layer_params(params, cfg.n_layers))]
    if cfg.family != "enc_dec":
        return dec
    enc = [("enc", lp, ()) for lp in
           layer_params(params, cfg.n_enc_layers, "enc_layers")]
    return [*enc, ("enc_norm", _sub(params, "enc_norm"), ()),
            *(("dec", lp, at) for _, lp, at in dec)]


TRAIN_IMPLS = {"naive": "torch", "chunked": "chunked", "flash": "flash"}


def train_impl(cfg: ModelCfg) -> str:
    """The ``impl`` a training caller passes to `forward`: the reference's
    training forward for ``cfg.attn_impl``.  ``"naive"`` is the masked
    `layers._sdpa` ("torch"), ``"chunked"`` `layers._sdpa_chunked` and
    ``"flash"`` `flash.flash_attention` (its recomputing backward); the
    time-mix runs the plain chunked scan under each.  The reference's
    training path reaches no Pallas kernel, and K2 and K3 have no
    backward."""
    if cfg.attn_impl not in TRAIN_IMPLS:
        raise ValueError(f"{cfg.name}: attn_impl must be one of "
                         f"{tuple(TRAIN_IMPLS)}, got {cfg.attn_impl!r}")
    return TRAIN_IMPLS[cfg.attn_impl]


# ---------------------------------------------------------------------------
# Blocks (apply)
# ---------------------------------------------------------------------------
def _mixer(cfg: ModelCfg, lp: Params, h: torch.Tensor, impl: str,
           window: int | None, causal: bool = True):
    """The layer's sequence mixer on its normed input: the rwkv6 time-mix
    (ssm; the attention impls "naive" / "chunked" / "flash" run its plain
    scan), self-attention under ``window``, causal unless ``causal`` is
    False (dense, moe, and the modal families' self layers), or both
    attention and the selective SSM, mean-fused (hybrid), through
    `ssm.rwkv6_seq` / `layers.self_attention` with ``impl`` and
    `ssm.ssm_seq`.  Returns (out, what the decode cache keeps of the
    layer: the time-mix's final state, (k, v), or (k, v, the SSM's final
    state))."""
    if cfg.family == "ssm":
        if impl in ("naive", "chunked", "flash"):
            impl = "torch"
        return S.rwkv6_seq(_sub(lp, "mix"), cfg.rwkv_cfg(), h, impl=impl,
                           return_state=True)
    ap = _sub(lp, "attn")
    b, s, _ = h.shape
    positions = torch.arange(s, device=h.device).expand(b, s)
    q, k, v = L._qkv(ap, cfg.attn_cfg(), h, positions)
    out = L.self_attention(q, k, v, causal=causal, window=window, impl=impl,
                           chunk=cfg.attn_chunk)
    out = out.reshape(b, s, -1) @ ap["wo"]
    if cfg.family == "hybrid":
        s_, state = S.ssm_seq(_sub(lp, "ssm"), cfg.ssm_cfg(), h,
                              return_state=True)
        return 0.5 * (out + s_), (k, v, state)
    return out, (k, v)


def _block(cfg: ModelCfg, lp: Params, x: torch.Tensor, *, impl: str = "auto",
           window: int | None = None, causal: bool = True,
           skip_mlp: bool = False):
    """One layer: x + mixer(ln1 x), then + mlp(ln2 x) (or the experts').
    Returns (x, what the decode cache keeps of the layer, the MoE's aux
    loss or None).  ``skip_mlp``: the mixer sublayer only (an enc_dec
    decoder layer runs self-attention, cross-attention, then its MLP).
    The normed input is passed straight to `_mixer`, so it is freed before
    the MLP runs."""
    norm = _norm(cfg)
    mix, kept = _mixer(cfg, lp, norm(_sub(lp, "ln1"), x), impl, window,
                       causal)
    x = x + mix
    if skip_mlp:
        return x, kept, None
    h = norm(_sub(lp, "ln2"), x)
    if cfg.family == "moe":
        y, aux = M.moe_layer(_sub(lp, "moe"), cfg.moe_cfg(), h)
    else:
        y, aux = L.mlp(_sub(lp, "mlp"), h, cfg.act), None
    return x + y, kept, aux


def _cross_block(cfg: ModelCfg, lp: Params, x: torch.Tensor,
                 kv_src: torch.Tensor):
    """x + tanh(gate) cross_attention(lnx x, kv_src), then + mlp(ln2 x).
    Returns (x, (xk, xv)): kv_src's unbiased key and value projections,
    computed once for the attention and the decode cache."""
    norm = _norm(cfg)
    ap = _sub(lp, "xattn")
    acfg = cfg.attn_cfg(causal=False)
    kv = L.cross_kv(ap, acfg, kv_src)
    xa = L.cross_attention(ap, acfg, norm(_sub(lp, "lnx"), x), kv_src, kv=kv)
    x = x + torch.tanh(lp["gate"]) * xa
    return x + L.mlp(_sub(lp, "mlp"), norm(_sub(lp, "ln2"), x), cfg.act), kv


def apply_unit(cfg: ModelCfg, kind: str, lp: Params, x: torch.Tensor,
               src: torch.Tensor | None, *, impl: str = "auto",
               window: int | None = None):
    """One step of `units` on the decoder stream ``x`` and the side stream
    ``src`` (the encoder's activations, or the modal embeddings).  Returns
    (x, src, what the decode cache keeps of the step, the MoE's aux loss
    or None).  The encoder runs bidirectional attention without a window;
    the decoder's self-attention is causal under ``window``."""
    if kind == "layer":
        x, kept, aux = _block(cfg, lp, x, impl=impl, window=window)
        return x, src, kept if isinstance(kept, tuple) else (kept,), aux
    if kind == "enc":
        src, _, _ = _block(cfg, lp, src, impl=impl, causal=False)
        return x, src, (), None
    if kind == "enc_norm":
        return x, _norm(cfg)(lp, src), (), None
    if kind == "dec":
        x, kv, _ = _block(cfg, lp, x, impl=impl, window=window,
                          skip_mlp=True)
        x, xkv = _cross_block(cfg, lp, x, src)
        return x, src, (*kv, *xkv), None
    if kind == "cross":
        x, xkv = _cross_block(cfg, lp, x, src)
        return x, src, xkv, None
    raise ValueError(f"unknown unit kind {kind!r}")


def cache_names(cfg: ModelCfg, kind: str) -> tuple[str, ...]:
    """The decode cache's names for what `apply_unit` keeps of a step of
    ``kind``, in the order it keeps them."""
    if kind == "layer":
        return {"ssm": ("rwkv_state",),
                "hybrid": ("k", "v", "ssm_state")}.get(cfg.family, ("k", "v"))
    return {"dec": ("k", "v", "xk", "xv"), "cross": ("xk", "xv")}.get(kind, ())


def _modal(cfg: ModelCfg, modal_embeds: torch.Tensor | None, *,
           cast: bool) -> torch.Tensor | None:
    """The side stream a modal family starts from (None for the others):
    ``modal_embeds`` cast to ``cfg.dtype``, or with ``cast=False`` (the
    vlm's forward, which the reference does not cast) as given, where
    mixing it into the layers would change the activations' dtype."""
    if cfg.family not in ("enc_dec", "vlm"):
        return None
    if modal_embeds is None:
        raise ValueError(f"{cfg.name}: the {cfg.family} family needs "
                         f"modal_embeds (B, {modal_len(cfg)}, {cfg.d_model})")
    if cast or modal_embeds.dtype == cfg.dtype:
        return modal_embeds.to(cfg.dtype)
    if torch.promote_types(modal_embeds.dtype, cfg.dtype) != cfg.dtype:
        raise TypeError(
            f"{cfg.name}: modal_embeds are {modal_embeds.dtype}, the model "
            f"runs in {cfg.dtype}; the vlm forward does not cast them (as the "
            f"reference's, whose layer scan then raises a TypeError: the "
            f"cross blocks would turn its {cfg.dtype} activations "
            f"{torch.promote_types(modal_embeds.dtype, cfg.dtype)})")
    # A narrower input promotes in the products, as the reference's does.
    return modal_embeds.to(cfg.dtype)


def _remat_unit(cfg: ModelCfg, kind: str, impl: str, window: int | None,
                names: list, x: torch.Tensor, src: torch.Tensor | None,
                *leaves: torch.Tensor):
    """`apply_unit`'s changed stream and aux with the step's leaves as
    positional tensors, the form `torch.utils.checkpoint` records."""
    x, src, _, aux = apply_unit(cfg, kind, dict(zip(names, leaves)), x, src,
                                impl=impl, window=window)
    return (src,) if kind == "enc" else (x, aux)


def forward(params: Params, cfg: ModelCfg, tokens: torch.Tensor, *,
            modal_embeds: torch.Tensor | None = None, impl: str = "auto",
            window: int | None = None, return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) float32, aux loss float32).

    The aux loss is the sum over layers of the MoE's load-balance loss (0
    for the other families).  ``modal_embeds``: (B, T, D) frame or patch
    embeddings, needed by the enc_dec and vlm families (enc_dec casts them
    to ``cfg.dtype``; the vlm, as the reference's, does not: there a wider
    dtype raises `TypeError`).  ``return_hidden`` gives the final normed
    hidden states (B, S, D) instead of logits.  ``impl`` selects the
    time-mix scan or the attention (see `layers.self_attention`); training
    callers pass `train_impl` (on the card "auto" reaches K2 / K3, which
    refuse autograd).  ``window`` masks keys ``window`` or more positions
    back in the decoder (never in the encoder).  Gemma's embeddings are
    scaled by sqrt(d_model), in ``cfg.dtype`` (the reference multiplies by
    a numpy float64 scalar, which promotes bfloat16 activations to float32
    for the rest of its forward; ROADMAP Queue 3).  With ``cfg.remat`` and
    grad mode on, each layer is checkpointed (recomputed in the backward),
    as the reference wraps its layer scans in `jax.checkpoint` (the vlm's
    cross blocks are not); the values are the same.  Under a `torch.func`
    transform (the simulator's vmapped gradient) layers are not
    checkpointed: it takes no saved-tensor hooks."""
    check_family(cfg)
    src = _modal(cfg, modal_embeds, cast=cfg.family == "enc_dec")
    x = L.embed(_sub(params, "embed"), tokens).to(cfg.dtype)
    if cfg.family == "dense" and cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    remat = (cfg.remat and torch.is_grad_enabled()
             and not func_transform_active())
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, lp, _ in units(params, cfg):
        aux = None
        if remat and kind in ("layer", "enc", "dec"):
            out = checkpoint(_remat_unit, cfg, kind, impl, window, list(lp),
                             x, src, *lp.values(), use_reentrant=False)
            if kind == "enc":
                (src,) = out
            else:
                x, aux = out
        else:
            x, src, _, aux = apply_unit(cfg, kind, lp, x, src, impl=impl,
                                        window=window)
        if aux is not None:
            total = total + aux
    x = _norm(cfg)(_sub(params, "final_norm"), x)
    if return_hidden:
        return x, total
    return L.unembed(_sub(params, "embed"), x), total


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelCfg, tokens: torch.Tensor, *,
            modal_embeds: torch.Tensor | None = None,
            window: int | None = None, impl: str = "auto"):
    """tokens: (B, S) -> (last-token logits (B, V) float32, cache ready for
    `serve_step`).  The cache holds, in ``cfg.dtype``, each layer's final
    time-mix state ``rwkv_state`` (n_layers, B, H, Dh, Dh) for the ssm
    family, each layer's attention keys and values ``k`` / ``v``
    (n_layers, B, S, KV, Dh) for the dense and moe families, for the
    hybrid family ``k`` / ``v`` and each layer's final SSM state
    ``ssm_state`` (n_layers, B, Di, N), and for the modal families ``k`` /
    ``v`` (the vlm's (groups, cross_attn_every - 1, B, S, KV, Dh)) and each
    cross block's keys and values of the modal input ``xk`` / ``xv``
    (layers or groups, B, T, KV, Dh).  ``modal_embeds`` (B, T, D) are
    cast to ``cfg.dtype``.  ``window`` masks the decoder's attention to
    keys ``window`` or more positions back (K2 takes it on the card).
    Self-attention runs ``impl``: on the card "auto" is K2, causal in the
    decoder and bidirectional in the encoder; where the port runs plain
    PyTorch (``impl="torch"``, or ``"auto"`` on the CPU) it runs the
    reference's prefill attention, `layers._sdpa_chunked` under
    ``cfg.attn_impl == "chunked"``, else the masked `_sdpa`.  The
    cross-attention is the plain `_sdpa` on every path."""
    check_family(cfg)
    if cfg.attn_impl == "chunked" and (
            impl == "torch" or (impl == "auto" and tokens.device.type != "cuda")):
        impl = "chunked"
    src = _modal(cfg, modal_embeds, cast=True)
    x = L.embed(_sub(params, "embed"), tokens).to(cfg.dtype)
    kept: dict[str, list] = {}
    for kind, lp, _ in units(params, cfg):
        x, src, entries, _ = apply_unit(cfg, kind, lp, x, src, impl=impl,
                                        window=window)
        # A float32 recurrent state is cast as it comes, not held to the
        # end; k, v, xk and xv are already in cfg.dtype.
        for name, t in zip(cache_names(cfg, kind), entries):
            kept.setdefault(name, []).append(t.to(cfg.dtype))
    last = _norm(cfg)(_sub(params, "final_norm"), x[:, -1])
    logits = L.unembed(_sub(params, "embed"), last)
    cache = {name: torch.stack(entries) for name, entries in kept.items()}
    if cfg.family == "vlm":          # k / v on (groups, self layers)
        g, ns = vlm_groups(cfg)
        for name in ("k", "v"):
            cache[name] = cache[name].view(g, ns, *cache[name].shape[1:])
    return logits, cache


def init_cache(cfg: ModelCfg, batch: int, max_len: int, *,
               window: int | None = None, device=None) -> Params:
    """Decode cache, zeros: one recurrent state per layer (ssm), attention
    keys and values (n_layers, B, T, KV, Dh) (dense, moe), or both
    (hybrid: ``ssm_state`` (n_layers, B, Di, N)); T = min(max_len,
    window): a windowed cache wraps (`serve_step`'s ``pos`` is the absolute
    position mod T).  The modal families add the cross keys and values
    ``xk`` / ``xv`` (n_layers, B, enc_seq, KV, Dh) (enc_dec) or (groups,
    B, n_modal_tokens, KV, Dh) (vlm, whose ``k`` / ``v`` are (groups,
    cross_attn_every - 1, B, T, KV, Dh)), filled by `prefill`."""
    check_family(cfg)
    if cfg.family == "ssm":
        rc = cfg.rwkv_cfg()
        return {"rwkv_state": torch.zeros(
            (cfg.n_layers, batch, rc.n_heads, rc.head_dim, rc.head_dim),
            dtype=cfg.dtype, device=device)}
    t = max_len if window is None else min(max_len, window)
    lead = (cfg.n_layers,)
    if cfg.family == "vlm":
        lead = vlm_groups(cfg)
    kv = (cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros((*lead, batch, t, *kv), dtype=cfg.dtype,
                              device=device),
             "v": torch.zeros((*lead, batch, t, *kv), dtype=cfg.dtype,
                              device=device)}
    if cfg.family == "hybrid":
        cache["ssm_state"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_cfg().d_inner, cfg.d_state),
            dtype=cfg.dtype, device=device)
    if cfg.family in ("enc_dec", "vlm"):
        shape = (lead[0], batch, modal_len(cfg), *kv)
        cache["xk"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
        cache["xv"] = torch.zeros(shape, dtype=cfg.dtype, device=device)
    return cache


def _decode_xattn(cfg: ModelCfg, lp: Params, x: torch.Tensor,
                  xk: torch.Tensor, xv: torch.Tensor) -> torch.Tensor:
    """Cross-attention of one token against the prefill's cross keys and
    values: unmasked, no RoPE, and (as the reference's) no QKV bias."""
    b = x.shape[0]
    ap = _sub(lp, "xattn")
    q = (x @ ap["wq"]).reshape(b, 1, cfg.n_heads, cfg.hd)
    out = L._sdpa(q, xk, xv, None, scale=1.0 / math.sqrt(cfg.hd))
    return out.reshape(b, 1, -1) @ ap["wo"]


def _at(t: torch.Tensor, at: tuple) -> torch.Tensor:
    for i in at:
        t = t[i]
    return t


def serve_step(params: Params, cfg: ModelCfg, cache: Params,
               token: torch.Tensor, pos, *, window: int | None = None,
               abs_pos=None, full_cache: bool = False):
    """One decode step.  token: (B, 1).  Returns (logits (B, 1, V) float32,
    new cache).  ``pos`` is the cache slot the attention families write the
    token's keys and values to, in place (see `layers.decode_attention`;
    the returned cache holds the same tensors): its position, or with a
    wrapped sliding-window cache its absolute position mod the cache's
    length.  ``abs_pos``: the absolute position for RoPE (default ``pos``).
    ``full_cache``: every slot holds a key of the window (the wrapped
    cache's steady state), so none is masked.  The ssm family returns new
    time-mix states, the hybrid new SSM states beside its K/V cache; the
    moe family routes the step's B tokens as one group (as the reference
    does, so its drops differ from a forward's); the modal families'
    cross blocks attend to the cached ``xk`` / ``xv``, which are returned
    as they are.  Decode runs in plain PyTorch."""
    check_family(cfg)
    norm = _norm(cfg)
    x = L.embed(_sub(params, "embed"), token).to(cfg.dtype)
    states = []
    for kind, lp, at in units(params, cfg):
        if kind in ("enc", "enc_norm"):     # the prefill ran the encoder
            continue
        if kind == "cross":
            xa = _decode_xattn(cfg, lp, norm(_sub(lp, "lnx"), x),
                               _at(cache["xk"], at), _at(cache["xv"], at))
            x = x + torch.tanh(lp["gate"]) * xa
            x = x + L.mlp(_sub(lp, "mlp"), norm(_sub(lp, "ln2"), x), cfg.act)
            continue
        h = norm(_sub(lp, "ln1"), x)
        if cfg.family == "ssm":
            mix, st = S.rwkv6_step(_sub(lp, "mix"), cfg.rwkv_cfg(), h,
                                   _at(cache["rwkv_state"], at))
            states.append(st)
        else:
            mix, _ = L.decode_attention(
                _sub(lp, "attn"), cfg.attn_cfg(window=window), h,
                {"k": _at(cache["k"], at), "v": _at(cache["v"], at)}, pos,
                rope_pos=abs_pos, full_cache=full_cache)
        if cfg.family == "hybrid":
            s_, st = S.ssm_step(_sub(lp, "ssm"), cfg.ssm_cfg(), h,
                                _at(cache["ssm_state"], at))
            states.append(st)
            mix = 0.5 * (mix + s_)
        x = x + mix
        if kind == "dec":
            xa = _decode_xattn(cfg, lp, norm(_sub(lp, "lnx"), x),
                               _at(cache["xk"], at), _at(cache["xv"], at))
            x = x + torch.tanh(lp["gate"]) * xa
        h = norm(_sub(lp, "ln2"), x)
        if cfg.family == "moe":
            y, _ = M.moe_layer(_sub(lp, "moe"), cfg.moe_cfg(), h)
        else:
            y = L.mlp(_sub(lp, "mlp"), h, cfg.act)
        x = x + y
    x = norm(_sub(params, "final_norm"), x)
    logits = L.unembed(_sub(params, "embed"), x)
    if cfg.family == "ssm":
        return logits, {"rwkv_state": torch.stack(states)}
    if cfg.family == "hybrid":
        return logits, dict(cache, ssm_state=torch.stack(states))
    return logits, cache
