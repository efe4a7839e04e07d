"""RWKV-6 "Finch" time-mix: data-dependent decay linear attention.

Port of the rwkv6 half of the reference package's `models/ssm.py`; the
Mamba-style `ssm_*` functions come with the hybrid family (ROADMAP Queue 1
item 7).  Per head, with state S (key index first, value index second):

    out_t = r_t · (S_{t-1} + diag(exp(u)) k_t v_t^T)
    S_t   = diag(exp(w_t)) S_{t-1} + k_t v_t^T          (w_t = log decay <= 0)

`rwkv6_seq` runs the whole sequence: ``impl="kernel"`` through
`kernels.ops.rwkv6_scan` (the CUDA kernel K3 for CUDA tensors), ``"torch"``
through `rwkv6_chunked`, and ``"auto"`` picks the kernel for CUDA tensors
and `rwkv6_chunked` on the CPU.  The kernel writes the final state itself,
so the card runs no plain scan on that path.  `rwkv6_step` is one decode
token, in float32, cast back to the state's dtype.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..kernels import ops
from . import layers

Params = dict[str, torch.Tensor]
IMPLS = ("auto", "torch", "kernel")

# Per-step log-decay floor: a 64-token chunk's cumulative decay then stays
# inside float32 in `rwkv6_chunked`'s two-factor form (exp(-cum) would
# otherwise overflow); e^-60 is numerically zero, so semantics are kept.
LOG_DECAY_FLOOR = -60.0 / 64.0


@dataclasses.dataclass(frozen=True)
class RWKV6Cfg:
    d_model: int
    n_heads: int = 16

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_rwkv6(gen: torch.Generator, cfg: RWKV6Cfg,
               dtype=torch.float32) -> Params:
    d = cfg.d_model
    s = 1.0 / math.sqrt(d)
    p = {
        "w_r": layers._normal(gen, (d, d), s, dtype),
        "w_k": layers._normal(gen, (d, d), s, dtype),
        "w_v": layers._normal(gen, (d, d), s, dtype),
        "w_g": layers._normal(gen, (d, d), s, dtype),
        "w_decay": layers._normal(gen, (d, d), s * 0.1, dtype),
        "decay_bias": torch.full((d,), -2.0, dtype=dtype, device=gen.device),
        "bonus_u": layers._normal(gen, (cfg.n_heads, cfg.head_dim), 0.1, dtype),
        "w_out": layers._normal(gen, (d, d), s, dtype),
    }
    return dict(sorted(p.items()))


def _rkvwg(params: Params, cfg: RWKV6Cfg, x: torch.Tensor):
    """Projections: r, k, v (B, S, H, Dh) in x's dtype, the gate g
    (B, S, D), and the float32 log decay w (B, S, H, Dh), floored."""
    b, s, _ = x.shape
    h, dh = cfg.n_heads, cfg.head_dim
    r = (x @ params["w_r"]).reshape(b, s, h, dh)
    k = (x @ params["w_k"]).reshape(b, s, h, dh)
    v = (x @ params["w_v"]).reshape(b, s, h, dh)
    g = F.silu(x @ params["w_g"])
    wlog = -torch.exp((x @ params["w_decay"] + params["decay_bias"]).float())
    w = torch.clamp_min(wlog, LOG_DECAY_FLOOR).reshape(b, s, h, dh)
    return r, k, v, g, w


def rwkv6_seq(params: Params, cfg: RWKV6Cfg, x: torch.Tensor, *,
              chunk: int = 64, impl: str = "auto",
              return_state: bool = False):
    """Full-sequence time-mix.  x: (B, S, D) -> (B, S, D) [, final state
    (B, H, Dh, Dh) float32]."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    b, s, d = x.shape
    r, k, v, g, w = _rkvwg(params, cfg, x)
    u = params["bonus_u"].float()
    if impl == "kernel" or (impl == "auto" and x.device.type == "cuda"):
        y, state = ops.rwkv6_scan(r, k, v, w, u, chunk=chunk,
                                  return_state=True, device=x.device)
    else:
        y, state = rwkv6_chunked(r, k, v, w, u, chunk=chunk,
                                 return_state=True)
    out = (y.reshape(b, s, d) * g) @ params["w_out"]
    return (out, state) if return_state else out


def _chunk_len(s: int, chunk: int) -> int:
    """``chunk``, or the largest divisor of ``s`` below it."""
    c = min(chunk, s)
    return next(x for x in range(c, 0, -1) if s % x == 0)


def rwkv6_chunked(r, k, v, w, u, *, chunk: int = 64,
                  return_state: bool = False):
    """Chunked scan in plain PyTorch (the reference's `rwkv6_chunked`).

    r, k, v, w: (B, S, H, Dh) with w = log decay (<= 0); u: (H, Dh).
    Within a chunk, earlier tokens enter through a strictly-lower
    decay-masked product in the two-factor form exp(cum_{t-1})·exp(-cum_j);
    the carried state enters through cumulative decays.
    Returns (B, S, H, Dh) in r's dtype [, final state (B, H, Dh, Dh) f32].
    """
    b, s, h, dh = r.shape
    c = _chunk_len(s, chunk)
    nc = s // c
    rc, kc, vc, wc = (t.reshape(b, nc, c, h, dh).float() for t in (r, k, v, w))
    eu = torch.exp(u.float())[None, None]
    strict = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
    state = torch.zeros((b, h, dh, dh), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(nc):
        ri, ki, vi, wi = rc[:, i], kc[:, i], vc[:, i], wc[:, i]  # (B,C,H,Dh)
        cum = torch.cumsum(wi, dim=1)            # inclusive log decay
        total = cum[:, -1:]                      # (B, 1, H, Dh)
        dec_before = torch.exp(cum - wi)         # exp(cum_{t-1})
        out_state = torch.einsum("bchd,bhde->bche", ri * dec_before, state)
        att = torch.einsum("bchd,bjhd->bhcj", ri * dec_before,
                           ki * torch.exp(-cum))
        att = att * strict
        diag = torch.einsum("bchd,bchd->bch", ri * eu, ki)
        outs.append(out_state + torch.einsum("bhcj,bjhe->bche", att, vi)
                    + diag[..., None] * vi)
        state = torch.exp(total[:, 0, :, :, None]) * state + torch.einsum(
            "bjhd,bjhe->bhde", ki * torch.exp(total - cum), vi)
    out = torch.stack(outs, dim=1).reshape(b, s, h, dh).to(r.dtype)
    return (out, state) if return_state else out


def init_rwkv6_state(batch: int, cfg: RWKV6Cfg, dtype=torch.float32,
                     device=None) -> torch.Tensor:
    return torch.zeros((batch, cfg.n_heads, cfg.head_dim, cfg.head_dim),
                       dtype=dtype, device=device)


def rwkv6_step(params: Params, cfg: RWKV6Cfg, x: torch.Tensor,
               state: torch.Tensor):
    """Single-token step.  x: (B, 1, D); state: (B, H, Dh, Dh).  The math
    is float32; the new state takes ``state``'s dtype."""
    r, k, v, g, w = _rkvwg(params, cfg, x)
    r, k, v, w = (t[:, 0].float() for t in (r, k, v, w))
    eu = torch.exp(params["bonus_u"].float())[None, :, :, None]
    kv = k[..., :, None] * v[..., None, :]
    sf = state.float()
    out = torch.einsum("bhd,bhde->bhe", r, sf + eu * kv)
    new_state = torch.exp(w)[..., None] * sf + kv
    y = out.reshape(x.shape[0], 1, -1).to(x.dtype)
    return (y * g) @ params["w_out"], new_state.to(state.dtype)
