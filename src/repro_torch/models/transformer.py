"""Transformer assembly, functional PyTorch: the decoder-only families
``dense``, ``moe``, ``ssm`` and ``hybrid``.

Port of the reference package's `models/transformer.py` for the
decoder-only families: `ModelCfg`, init, the full forward, `prefill`
(builds the decode cache, returns last-token logits) and `serve_step` (one
token against the cache), with the sliding window throughout (the window
mask in the forward and prefill, `init_cache(window=)`'s wrapped cache of
at most ``window`` slots, `serve_step`'s ``abs_pos`` / ``full_cache``).
Per layer:

  dense  : {ln1, attn, ln2, mlp}  (GQA + RoPE + optional QKV bias; qwen2.5,
                                   llama3, starcoder2, gemma)
  moe    : {ln1, attn, ln2, moe}                   (granite-moe, dbrx)
  ssm    : {ln1, rwkv6 time-mix, ln2, mlp}                         (rwkv6)
  hybrid : {ln1, attn ∥ selective ssm (0.5 (a + s)), ln2, mlp}    (hymba)

`forward` returns the sum of the layers' MoE load-balance losses (0 for
the other families).  As in the reference, gemma's embeddings are scaled by
sqrt(d_model) in `forward` only; `prefill` and `serve_step` embed without
it.  The modal families (enc_dec, vlm) raise `NotImplementedError`; they
come with ROADMAP Queue 1 item 7e.

Parameters are a flat ``dict[str, Tensor]`` in the reference's leaf order
(sorted keys, dotted names: "embed.table", "final_norm.scale",
"layers.attn.bk", ..., "layers.mlp.w_up").  Layer leaves are stacked on a
leading ``(n_layers, ...)`` axis as the reference stacks them, so
`interop.params_from_jax` maps one tree onto the other leaf for leaf; the
reference's `lax.scan` over layers is a Python loop over that axis here.
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


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_family(cfg: ModelCfg) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (only "
            f"{PORTED_FAMILIES}); see ROADMAP.md Queue 1 item 7e")


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


def init_params(gen: torch.Generator, cfg: ModelCfg) -> Params:
    """The full model, drawn with ``gen`` on ``gen.device`` (layer leaves
    stacked: (n_layers, ...))."""
    check_family(cfg)
    p = {**_prefixed("embed", L.init_embedding(gen, cfg.vocab, cfg.d_model,
                                               cfg.dtype)),
         **_prefixed("final_norm", _norm_init(cfg)(cfg.d_model, cfg.dtype,
                                                   gen.device))}
    blocks = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    for name in list(blocks[0]):
        p[f"layers.{name}"] = torch.stack([blk[name] for blk in blocks])
        for blk in blocks:   # free each layer's copy as soon as it is stacked
            del blk[name]
    return p


def layer_params(params: Params, n_layers: int) -> list[Params]:
    """Per-layer views of the stacked layer leaves.  `torch.unbind` makes
    them, so a gradient reaches each stacked leaf as one stack of the
    layers' gradients, not as one full-size scatter a layer."""
    stacked = _sub(params, "layers")
    views = [v.unbind(0) for v in stacked.values()]
    return [dict(zip(stacked, vals)) for vals in zip(*views)][:n_layers]


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
           window: int | None):
    """The layer's sequence mixer on its normed input: the rwkv6 time-mix
    (ssm; the attention impls "naive" / "chunked" / "flash" run its plain
    scan), causal self-attention under ``window`` (dense, moe), or both
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
    out = L.self_attention(q, k, v, causal=True, window=window, impl=impl,
                           chunk=cfg.attn_chunk)
    out = out.reshape(b, s, -1) @ ap["wo"]
    if cfg.family == "hybrid":
        s_, state = S.ssm_seq(_sub(lp, "ssm"), cfg.ssm_cfg(), h,
                              return_state=True)
        return 0.5 * (out + s_), (k, v, state)
    return out, (k, v)


def _block(cfg: ModelCfg, lp: Params, x: torch.Tensor, *, impl: str = "auto",
           window: int | None = None):
    """One layer: x + mixer(ln1 x), then + mlp(ln2 x) (or the experts').
    Returns (x, what the decode cache keeps of the layer, the MoE's aux
    loss or None).  The normed input is passed straight to `_mixer`, so it
    is freed before the MLP runs."""
    norm = _norm(cfg)
    mix, kept = _mixer(cfg, lp, norm(_sub(lp, "ln1"), x), impl, window)
    x = x + mix
    h = norm(_sub(lp, "ln2"), x)
    if cfg.family == "moe":
        y, aux = M.moe_layer(_sub(lp, "moe"), cfg.moe_cfg(), h)
    else:
        y, aux = L.mlp(_sub(lp, "mlp"), h, cfg.act), None
    return x + y, kept, aux


def _remat_block(cfg: ModelCfg, impl: str, window: int | None, names: list,
                 x: torch.Tensor, *leaves: torch.Tensor):
    """`_block`'s (x, aux) with the layer's leaves as positional tensors,
    the form `torch.utils.checkpoint` records."""
    x, _, aux = _block(cfg, dict(zip(names, leaves)), x, impl=impl,
                       window=window)
    return x, aux


def forward(params: Params, cfg: ModelCfg, tokens: torch.Tensor, *,
            impl: str = "auto", window: int | None = None,
            return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) float32, aux loss float32).

    The aux loss is the sum over layers of the MoE's load-balance loss (0
    for the other families).  ``return_hidden`` gives the final normed
    hidden states (B, S, D) instead of logits.  ``impl`` selects the
    time-mix scan or the attention (see `layers.self_attention`); training
    callers pass `train_impl` (on the card "auto" reaches K2 / K3, which
    refuse autograd).  ``window`` masks keys ``window`` or more positions
    back.  Gemma's embeddings are scaled by sqrt(d_model), in
    ``cfg.dtype`` (the reference multiplies by a numpy float64 scalar,
    which promotes bfloat16 activations to float32 for the rest of its
    forward; ROADMAP Queue 3).  With ``cfg.remat`` and grad mode on, each
    layer is checkpointed (recomputed in the backward), as the reference
    wraps its layer scan in `jax.checkpoint`; the values are the same.
    Under a `torch.func` transform (the simulator's vmapped gradient)
    layers are not checkpointed: it takes no saved-tensor hooks."""
    check_family(cfg)
    x = L.embed(_sub(params, "embed"), tokens).to(cfg.dtype)
    if cfg.family == "dense" and cfg.name.startswith("gemma"):
        x = x * math.sqrt(cfg.d_model)
    remat = (cfg.remat and torch.is_grad_enabled()
             and not func_transform_active())
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in layer_params(params, cfg.n_layers):
        if remat:
            x, aux = checkpoint(_remat_block, cfg, impl, window, list(lp), x,
                                *lp.values(), use_reentrant=False)
        else:
            x, _, aux = _block(cfg, lp, x, impl=impl, window=window)
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
            window: int | None = None, impl: str = "auto"):
    """tokens: (B, S) -> (last-token logits (B, V) float32, cache ready for
    `serve_step`).  The cache holds, in ``cfg.dtype``, each layer's final
    time-mix state ``rwkv_state`` (n_layers, B, H, Dh, Dh) for the ssm
    family, each layer's attention keys and values ``k`` / ``v``
    (n_layers, B, S, KV, Dh) for the dense and moe families, and for the
    hybrid family ``k`` / ``v`` and each layer's final SSM state
    ``ssm_state`` (n_layers, B, Di, N).  ``window`` masks attention to keys
    ``window`` or more positions back (K2 takes it on the card).  Where
    the port runs plain PyTorch (``impl="torch"``, or ``"auto"`` on the
    CPU) it runs the reference's prefill attention: `layers._sdpa_chunked`
    under ``cfg.attn_impl == "chunked"``, else the masked `_sdpa`."""
    check_family(cfg)
    if cfg.attn_impl == "chunked" and (
            impl == "torch" or (impl == "auto" and tokens.device.type != "cuda")):
        impl = "chunked"
    x = L.embed(_sub(params, "embed"), tokens).to(cfg.dtype)
    kept = []
    for lp in layer_params(params, cfg.n_layers):
        x, entry, _ = _block(cfg, lp, x, impl=impl, window=window)
        # A float32 recurrent state is cast as it comes, not held to the
        # end; k and v are already in cfg.dtype.
        if cfg.family == "ssm":
            entry = (entry.to(cfg.dtype),)
        elif cfg.family == "hybrid":
            entry = (*entry[:2], entry[2].to(cfg.dtype))
        kept.append(entry)
    last = _norm(cfg)(_sub(params, "final_norm"), x[:, -1])
    logits = L.unembed(_sub(params, "embed"), last)
    names = {"ssm": ("rwkv_state",),             # in the order _mixer keeps
             "hybrid": ("k", "v", "ssm_state")}.get(cfg.family, ("k", "v"))
    return logits, {name: torch.stack([e[i] for e in kept])
                    for i, name in enumerate(names)}


def init_cache(cfg: ModelCfg, batch: int, max_len: int, *,
               window: int | None = None, device=None) -> Params:
    """Decode cache, zeros: one recurrent state per layer (ssm), attention
    keys and values (n_layers, B, T, KV, Dh) (dense, moe), or both
    (hybrid: ``ssm_state`` (n_layers, B, Di, N)); T = min(max_len,
    window): a windowed cache wraps (`serve_step`'s ``pos`` is the absolute
    position mod T)."""
    check_family(cfg)
    if cfg.family == "ssm":
        rc = cfg.rwkv_cfg()
        return {"rwkv_state": torch.zeros(
            (cfg.n_layers, batch, rc.n_heads, rc.head_dim, rc.head_dim),
            dtype=cfg.dtype, device=device)}
    t = max_len if window is None else min(max_len, window)
    shape = (cfg.n_layers, batch, t, cfg.n_kv_heads, cfg.hd)
    cache = {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
    if cfg.family == "hybrid":
        cache["ssm_state"] = torch.zeros(
            (cfg.n_layers, batch, cfg.ssm_cfg().d_inner, cfg.d_state),
            dtype=cfg.dtype, device=device)
    return cache


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
    does, so its drops differ from a forward's).  Decode runs in plain
    PyTorch."""
    check_family(cfg)
    norm = _norm(cfg)
    x = L.embed(_sub(params, "embed"), token).to(cfg.dtype)
    states = []
    for i, lp in enumerate(layer_params(params, cfg.n_layers)):
        h = norm(_sub(lp, "ln1"), x)
        if cfg.family == "ssm":
            mix, st = S.rwkv6_step(_sub(lp, "mix"), cfg.rwkv_cfg(), h,
                                   cache["rwkv_state"][i])
            states.append(st)
        else:
            mix, _ = L.decode_attention(
                _sub(lp, "attn"), cfg.attn_cfg(window=window), h,
                {"k": cache["k"][i], "v": cache["v"][i]}, pos,
                rope_pos=abs_pos, full_cache=full_cache)
        if cfg.family == "hybrid":
            s_, st = S.ssm_step(_sub(lp, "ssm"), cfg.ssm_cfg(), h,
                                cache["ssm_state"][i])
            states.append(st)
            mix = 0.5 * (mix + s_)
        x = x + mix
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
