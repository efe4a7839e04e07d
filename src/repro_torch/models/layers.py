"""Transformer building blocks, functional PyTorch: init/apply pairs.

Port of the reference package's `models/layers.py` for what the rwkv6 and
dense slices run: dense init, RMSNorm and LayerNorm, split-half RoPE,
grouped-query attention with optional QKV bias and sliding window
(`attention` with an optional ``attn_mask``, its prefill core
`self_attention`, the plain `_sdpa`, the online-softmax `_sdpa_chunked`),
`cross_attention` (queries from one sequence, keys and values from
another, no RoPE, an optional key mask), the KV cache with
`decode_attention` (including the wrapped sliding-window cache: RoPE at
``rope_pos``, ``full_cache``), the MLP with all four activations, and the
tied embedding.

Conventions, as in the reference:

  * every `init_*` returns a flat ``dict[str, Tensor]`` with the
    reference's leaf names (sorted keys); its draws come from ``gen`` on
    ``gen.device`` and cannot reproduce the reference's threefry draws;
  * every apply function is pure: (params, inputs) -> outputs;
  * activations are (batch, seq, d_model);
  * bfloat16 rounds where the reference rounds: `rmsnorm` casts the
    inverse RMS to ``x``'s dtype before it multiplies, `layernorm` casts
    the normalised value before scale and bias, `unembed` works in float32.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import flash

Params = dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, std: float, dtype) -> torch.Tensor:
    """Normal draws in float32 times ``std``, then cast (as the reference:
    ``(normal(key, shape) * std).astype(dtype)``)."""
    return (torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32) * std).to(dtype)


def _dense_init(gen: torch.Generator, d_in: int, d_out: int,
                dtype) -> torch.Tensor:
    return _normal(gen, (d_in, d_out), 1.0 / math.sqrt(d_in), dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    var = x.float().square().mean(-1, keepdim=True)
    y = x * torch.rsqrt(var + eps).to(x.dtype)
    return y * params["scale"]


def init_layernorm(d: int, dtype=torch.float32, device=None) -> Params:
    return {"bias": torch.zeros(d, dtype=dtype, device=device),
            "scale": torch.ones(d, dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    y = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return y * params["scale"] + params["bias"]


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    """1 / theta^(2i / head_dim) in float32.  The power is taken in float64
    and rounded once, as the reference's float32 power rounds it (torch's
    float32 power can be an ulp off, which at long_500k's positions moves
    an angle by 1.5e-5)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    base = torch.tensor(theta, dtype=torch.float32).double()
    return 1.0 / (base.to(device) ** exps.double()).float()


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """Split-half rotary embedding.  x: (B, S, H, Dh); positions: (B, S)
    integers.  Angles and the rotation are float32; the result takes x's
    dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs    # (B, S, Dh/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA + RoPE + optional bias/window + KV cache)
# ---------------------------------------------------------------------------
# "auto" (K2 on the card, else the masked `_sdpa`), "kernel" (K2; its plain
# version on the CPU), "torch" (the masked `_sdpa`), and the reference's
# training attentions: "naive" (the masked `_sdpa`), "chunked"
# (`_sdpa_chunked`) and "flash" (`flash.flash_attention`).
IMPLS = ("auto", "torch", "kernel", "naive", "chunked", "flash")


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10_000.0
    causal: bool = True
    sliding_window: int | None = None


def init_attention(gen: torch.Generator, cfg: AttnCfg,
                   dtype=torch.float32) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    # Draw order as the reference's split keys: wq, wk, wv, wo.
    p = {"wq": _dense_init(gen, d, h * dh, dtype),
         "wk": _dense_init(gen, d, kv * dh, dtype),
         "wv": _dense_init(gen, d, kv * dh, dtype),
         "wo": _dense_init(gen, h * dh, d, dtype)}
    if cfg.qkv_bias:
        for name, n in (("bq", h * dh), ("bk", kv * dh), ("bv", kv * dh)):
            p[name] = torch.zeros(n, dtype=dtype, device=gen.device)
    return dict(sorted(p.items()))


def _qkv(params: Params, cfg: AttnCfg, x: torch.Tensor,
         positions: torch.Tensor):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh) in x's dtype; the bias is
    added to the rounded product, and RoPE rotates q and k."""
    b, s, _ = x.shape
    h, kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(b, s, h, dh)
    k = k.reshape(b, s, kv, dh)
    v = v.reshape(b, s, kv, dh)
    if cfg.rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          mask: torch.Tensor | None, *, scale: float) -> torch.Tensor:
    """Grouped-query attention, rounding where the reference rounds: the
    logits product in the inputs' dtype, then float32 for the scale, mask
    (-1e30) and softmax, the probabilities cast to v's dtype.
    q: (B, S, H, Dh); k, v: (B, T, KV, Dh); mask: (B, S, T) bool or None."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    q = q.reshape(b, s, kv, h // kv, dh)
    logits = torch.einsum("bskgd,btkd->bkgst", q, k).float() * scale
    if mask is not None:
        logits = logits.masked_fill(~mask[:, None, None], -1e30)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(b, s, h, dh)


def _sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  scale: float, causal: bool, window: int | None,
                  chunk: int) -> torch.Tensor:
    """Memory-efficient attention: the online softmax over key blocks of the
    largest divisor of S at most ``chunk``, never holding the (S, S)
    scores (the reference's `_sdpa_chunked`; `flash.block_scan`).
    q: (B, S, H, Dh); k, v: (B, S, KV, Dh)."""
    return flash.block_scan(q, k, v, scale, causal, window, chunk)[0]


def _mask(s: int, causal: bool, window: int | None, device) -> torch.Tensor:
    """(S, S) bool, True where query i attends to key j."""
    idx = torch.arange(s, device=device)
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= idx[:, None] >= idx[None, :]
    if window is not None:
        mask &= idx[:, None] - idx[None, :] < window
    return mask


def self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = True, window: int | None = None,
                   impl: str = "auto", chunk: int = 512) -> torch.Tensor:
    """Full-sequence self-attention of projected heads (the prefill's
    attention).  q: (B, S, H, Dh); k, v: (B, S, KV, Dh) -> (B, S, H, Dh).

    ``impl="kernel"``, or ``"auto"`` on a CUDA tensor, runs
    `kernels.ops.flash_attention` with the window (the CUDA kernel K2 for
    CUDA tensors, its plain version for CPU tensors); ``"chunked"`` and
    ``"flash"`` run `_sdpa_chunked` and `flash.flash_attention` with
    ``chunk``; ``"torch"`` / ``"naive"``, or ``"auto"`` on the CPU, run
    `_sdpa` with the causal / window mask.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "kernel" or (impl == "auto" and q.device.type == "cuda"):
        return ops.flash_attention(q, k, v, scale=scale, causal=causal,
                                   window=window, device=q.device)
    if impl == "chunked":
        return _sdpa_chunked(q, k, v, scale=scale, causal=causal,
                             window=window, chunk=chunk)
    if impl == "flash":
        return flash.flash_attention(q, k, v, scale, causal, window, chunk)
    b, s = q.shape[:2]
    mask = _mask(s, causal, window, q.device)
    return _sdpa(q, k, v, mask.expand(b, s, s), scale=scale)


def attention(params: Params, cfg: AttnCfg, x: torch.Tensor, *,
              positions: torch.Tensor | None = None,
              attn_mask: torch.Tensor | None = None, impl: str = "auto",
              chunk: int = 512) -> torch.Tensor:
    """Full-sequence attention (training / prefill).  x: (B, S, D) ->
    (B, S, D).  ``impl`` and ``chunk`` as in `self_attention`.

    ``attn_mask``: optional (B, S, S) bool (True = attend), composed with
    the causal / window mask; given one, every ``impl`` runs the masked
    `_sdpa`, as the reference does."""
    b, s, _ = x.shape
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(params, cfg, x, positions)
    if attn_mask is None:
        out = self_attention(q, k, v, causal=cfg.causal,
                             window=cfg.sliding_window, impl=impl, chunk=chunk)
    else:
        mask = _mask(s, cfg.causal, cfg.sliding_window, x.device) & attn_mask
        out = _sdpa(q, k, v, mask, scale=1.0 / math.sqrt(cfg.head_dim))
    return out.reshape(b, s, -1) @ params["wo"]


def cross_attention(params: Params, cfg: AttnCfg, x: torch.Tensor,
                    kv_src: torch.Tensor, *,
                    kv_mask: torch.Tensor | None = None,
                    kv: tuple[torch.Tensor, torch.Tensor] | None = None
                    ) -> torch.Tensor:
    """Cross-attention: queries from x (B, S, D), keys and values from
    kv_src (B, T, D), through the plain `_sdpa`; no RoPE.  With
    ``cfg.qkv_bias`` each projection gets its bias, per head, added to the
    rounded product.  ``kv_mask``: optional (B, T) bool (True = attend),
    the same for every query.  ``kv``: kv_src's unbiased key and value
    projections (B, T, KV, Dh), when the caller has them already (the
    prefill keeps them as its cross cache)."""
    b, s, _ = x.shape
    t = kv_src.shape[1]
    h, nkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"]).reshape(b, s, h, dh)
    k, v = cross_kv(params, cfg, kv_src) if kv is None else kv
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(h, dh)
        k = k + params["bk"].reshape(nkv, dh)
        v = v + params["bv"].reshape(nkv, dh)
    mask = None if kv_mask is None else kv_mask[:, None, :].expand(b, s, t)
    out = _sdpa(q, k, v, mask, scale=1.0 / math.sqrt(dh))
    return out.reshape(b, s, -1) @ params["wo"]


def cross_kv(params: Params, cfg: AttnCfg, kv_src: torch.Tensor):
    """kv_src's (B, T, D) key and value projections (B, T, KV, Dh), without
    bias: what the decode cache keeps of a cross-attention."""
    b, t, _ = kv_src.shape
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim)
    return ((kv_src @ params["wk"]).reshape(shape),
            (kv_src @ params["wv"]).reshape(shape))


def init_kv_cache(batch: int, max_len: int, cfg: AttnCfg,
                  dtype=torch.float32, device=None) -> Params:
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def decode_attention(params: Params, cfg: AttnCfg, x: torch.Tensor,
                     cache: Params, pos: int, *, rope_pos: int | None = None,
                     full_cache: bool = False):
    """One-token decode step against a KV cache, in plain PyTorch.

    x: (B, 1, D); cache: k, v (B, T, KV, Dh); pos: the cache slot the new
    token's k and v are written to (with a wrapped sliding-window cache of
    T = window slots, its absolute position mod T).  ``rope_pos``: the
    absolute position RoPE rotates by (default ``pos``).  ``full_cache``:
    every slot holds a key of the window (a wrapped cache's steady state),
    so no slot is masked; otherwise slots after ``pos``, and with a window
    those ``window`` or more before it, are.

    Unlike the reference, which returns updated copies, the cache is
    written in place (one (B, KV, Dh) row per step instead of a copy of
    the whole cache); the returned dict holds the same tensors.  The write
    comes before the step's only read, as the reference's does: in a
    wrapped cache slot ``pos`` held the key ``window`` positions back, which
    the window no longer covers.  Returns (out (B, 1, D), cache).
    """
    b = x.shape[0]
    t = cache["k"].shape[1]
    pos = int(pos)
    if not 0 <= pos < t:
        raise IndexError(f"decode_attention: position {pos} is outside the "
                         f"cache of {t} slots")
    rp = pos if rope_pos is None else int(rope_pos)
    positions = torch.full((b, 1), rp, dtype=torch.int64, device=x.device)
    q, k_new, v_new = _qkv(params, cfg, x, positions)
    cache["k"][:, pos] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v_new[:, 0].to(cache["v"].dtype)
    mask = None
    if not full_cache:
        idx = torch.arange(t, device=x.device)
        valid = idx <= pos
        if cfg.sliding_window is not None:
            valid &= idx > pos - cfg.sliding_window
        mask = valid.expand(b, 1, t)
    out = _sdpa(q, cache["k"], cache["v"], mask,
                scale=1.0 / math.sqrt(cfg.head_dim))
    return out.reshape(b, 1, -1) @ params["wo"], cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------
ACTS = ("swiglu", "geglu", "gelu", "relu")


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, act: str,
             dtype=torch.float32) -> Params:
    if act not in ACTS:
        raise ValueError(act)
    # Draw order as the reference's split keys: up, down, then gate.
    p = {"w_up": _dense_init(gen, d_model, d_ff, dtype),
         "w_down": _dense_init(gen, d_ff, d_model, dtype)}
    if act in ("swiglu", "geglu"):
        p["w_gate"] = _dense_init(gen, d_model, d_ff, dtype)
    return dict(sorted(p.items()))


def mlp(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    up = x @ params["w_up"]
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"]) * up
    elif act == "geglu":   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * up
    elif act == "gelu":
        h = F.gelu(up, approximate="tanh")
    elif act == "relu":
        h = F.relu(up)
    else:
        raise ValueError(act)
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, vocab: int, d_model: int,
                   dtype=torch.float32) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits in float32."""
    return x.float() @ params["table"].float().T
