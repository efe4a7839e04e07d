"""Transformer building blocks, functional PyTorch: init/apply pairs.

Port of the reference package's `models/layers.py` for what the rwkv6
serving slice runs: dense init, RMSNorm and LayerNorm, the MLP with all
four activations, and the tied embedding.  Attention, RoPE and the KV
cache come with the dense family (ROADMAP Queue 1 item 7).

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

import math

import torch
import torch.nn.functional as F

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
