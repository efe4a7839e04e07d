"""Transformer assembly, functional PyTorch: the ``ssm`` family (rwkv6).

Port of the reference package's `models/transformer.py` for the rwkv6
serving slice: `ModelCfg`, init, the full forward, `prefill` (builds the
decode cache, returns last-token logits) and `serve_step` (one token
against the recurrent state).  Per layer: {ln1, rwkv6 time-mix, ln2, mlp}.
The other families (dense, moe, hybrid, enc_dec, vlm) raise
`NotImplementedError`; they come with ROADMAP Queue 1 item 7.

Parameters are a flat ``dict[str, Tensor]`` in the reference's leaf order
(sorted keys, dotted names: "embed.table", "final_norm.scale",
"layers.ln1.scale", ..., "layers.mlp.w_up").  Layer leaves are stacked on a
leading ``(n_layers, ...)`` axis as the reference stacks them, so
`interop.params_from_jax` maps one tree onto the other leaf for leaf; the
reference's `lax.scan` over layers is a Python loop over that axis here.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from . import layers as L
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

    def rwkv_cfg(self) -> S.RWKV6Cfg:
        return S.RWKV6Cfg(d_model=self.d_model,
                          n_heads=self.rwkv_heads or self.n_heads or 16)


def check_family(cfg: ModelCfg) -> None:
    """Raise for a family the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"unknown model family {cfg.family!r}")
    if cfg.family != "ssm":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (only "
            f"'ssm'); see ROADMAP.md Queue 1 item 7")


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
    p = {**_prefixed("ln1", _norm_init(cfg)(cfg.d_model, cfg.dtype, dev)),
         **_prefixed("ln2", _norm_init(cfg)(cfg.d_model, cfg.dtype, dev)),
         **_prefixed("mix", S.init_rwkv6(gen, cfg.rwkv_cfg(), cfg.dtype)),
         **_prefixed("mlp", L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                       cfg.dtype))}
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
    """Per-layer views of the stacked layer leaves."""
    stacked = _sub(params, "layers")
    return [{k: v[i] for k, v in stacked.items()} for i in range(n_layers)]


# ---------------------------------------------------------------------------
# Blocks (apply)
# ---------------------------------------------------------------------------
def _block(cfg: ModelCfg, lp: Params, x: torch.Tensor, *, impl: str = "auto",
           return_state: bool = False):
    """One layer: x + time-mix(ln1 x), then + mlp(ln2 x).  Returns x, or
    (x, the time-mix's final state) with ``return_state``."""
    norm = _norm(cfg)
    mix, state = S.rwkv6_seq(_sub(lp, "mix"), cfg.rwkv_cfg(),
                             norm(_sub(lp, "ln1"), x), impl=impl,
                             return_state=True)
    x = x + mix
    x = x + L.mlp(_sub(lp, "mlp"), norm(_sub(lp, "ln2"), x), cfg.act)
    return (x, state) if return_state else x


def forward(params: Params, cfg: ModelCfg, tokens: torch.Tensor, *,
            impl: str = "auto", return_hidden: bool = False):
    """tokens: (B, S) -> (logits (B, S, V) float32, aux loss 0).

    ``return_hidden`` gives the final normed hidden states (B, S, D)
    instead of logits.  ``impl`` selects the time-mix scan (see
    `ssm.rwkv6_seq`)."""
    check_family(cfg)
    x = L.embed(_sub(params, "embed"), tokens).to(cfg.dtype)
    for lp in layer_params(params, cfg.n_layers):
        x = _block(cfg, lp, x, impl=impl)
    x = _norm(cfg)(_sub(params, "final_norm"), x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return L.unembed(_sub(params, "embed"), x), aux


# ---------------------------------------------------------------------------
# Prefill and decode
# ---------------------------------------------------------------------------
def prefill(params: Params, cfg: ModelCfg, tokens: torch.Tensor, *,
            window: int | None = None, impl: str = "auto"):
    """tokens: (B, S) -> (last-token logits (B, V) float32, cache ready for
    `serve_step`).  The cache holds each layer's final time-mix state,
    ``rwkv_state`` (n_layers, B, H, Dh, Dh) in ``cfg.dtype``.  ``window``
    only bounds attention caches, which this family has none of."""
    check_family(cfg)
    x = L.embed(_sub(params, "embed"), tokens).to(cfg.dtype)
    states = []
    for lp in layer_params(params, cfg.n_layers):
        x, st = _block(cfg, lp, x, impl=impl, return_state=True)
        states.append(st.to(cfg.dtype))
    last = _norm(cfg)(_sub(params, "final_norm"), x[:, -1])
    logits = L.unembed(_sub(params, "embed"), last)
    return logits, {"rwkv_state": torch.stack(states)}


def init_cache(cfg: ModelCfg, batch: int, max_len: int, *,
               window: int | None = None, device=None) -> Params:
    """Decode cache: one recurrent state per layer, zeros."""
    check_family(cfg)
    rc = cfg.rwkv_cfg()
    return {"rwkv_state": torch.zeros(
        (cfg.n_layers, batch, rc.n_heads, rc.head_dim, rc.head_dim),
        dtype=cfg.dtype, device=device)}


def serve_step(params: Params, cfg: ModelCfg, cache: Params,
               token: torch.Tensor, pos, *, window: int | None = None):
    """One decode step.  token: (B, 1).  Returns (logits (B, 1, V) float32,
    new cache).  ``pos`` and ``window`` place attention-cache writes, which
    this family has none of."""
    check_family(cfg)
    norm = _norm(cfg)
    x = L.embed(_sub(params, "embed"), token).to(cfg.dtype)
    states = []
    for lp, st in zip(layer_params(params, cfg.n_layers), cache["rwkv_state"]):
        mix, st = S.rwkv6_step(_sub(lp, "mix"), cfg.rwkv_cfg(),
                               norm(_sub(lp, "ln1"), x), st)
        x = x + mix
        x = x + L.mlp(_sub(lp, "mlp"), norm(_sub(lp, "ln2"), x), cfg.act)
        states.append(st)
    x = norm(_sub(params, "final_norm"), x)
    return L.unembed(_sub(params, "embed"), x), {"rwkv_state": torch.stack(states)}
