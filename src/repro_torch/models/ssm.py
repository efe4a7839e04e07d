"""State-space and linear-attention sequence mixers: the Mamba-style
selective SSM (hymba's parallel SSM heads) and the RWKV-6 "Finch" time-mix
(data-dependent decay linear attention).

Port of the reference package's `models/ssm.py`.

Selective SSM (diagonal A, data-dependent B, C and dt), per channel d and
state index n:

    h_t = exp(-dt_t a) * h_{t-1} + dt_t u_t b_t          (a = exp(log_a))
    y_t = sum_n h_t c_t + d_skip u_t,   out = (y * gate) @ w_out

`ssm_seq` runs the whole sequence with `ssm_scan`, a chunked scan in
plain PyTorch (the reference runs `jax.lax.associative_scan`; no Pallas
kernel computes it): the recurrence runs inside chunks of L positions,
all chunks at once, the chunks' end states are carried across chunks,
and a second pass through the chunks from their carried states gives
every position's output.  Each step's decay and input are formed as
the step comes, so no (B, S, Di, N) term is held.  The recurrence, its
terms and the ``w_out`` product are float32 whatever the parameters'
dtype; `ssm_seq` returns x's dtype and `ssm_step` the state in the
state's dtype.

RWKV-6, per head, with state S (key index first, value index second):

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


# ---------------------------------------------------------------------------
# Mamba-style selective SSM
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_model: int
    d_state: int = 16
    expand: int = 1          # d_inner = expand * d_model

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


def init_ssm(gen: torch.Generator, cfg: SSMCfg,
             dtype=torch.float32) -> Params:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.d_state
    s = 1.0 / math.sqrt(d)
    dev = gen.device
    # log A in [-ln N, 0]: stable decays.
    log_a = -torch.log(torch.linspace(1.0, float(n), n, device=dev))
    p = {
        "w_in": layers._normal(gen, (d, di), s, dtype),
        "w_gate": layers._normal(gen, (d, di), s, dtype),
        "w_bc": layers._normal(gen, (di, 2 * n), 1.0 / math.sqrt(di), dtype),
        "w_dt": layers._normal(gen, (di, 1), 1.0 / math.sqrt(di), dtype),
        "log_a": log_a[None, :].repeat(di, 1).to(dtype),
        "d_skip": torch.ones((di,), dtype=dtype, device=dev),
        "w_out": layers._normal(gen, (di, d), 1.0 / math.sqrt(di), dtype),
        "dt_bias": torch.zeros((1,), dtype=dtype, device=dev),
    }
    return dict(sorted(p.items()))


def _softplus(z: torch.Tensor) -> torch.Tensor:
    """log(1 + exp(z)) as the reference takes it (`logaddexp(z, 0)`);
    `F.softplus` returns z itself above its threshold."""
    return torch.logaddexp(z, torch.zeros_like(z))


def _ssm_terms(params: Params, u: torch.Tensor):
    """u: (B, S, Di) -> the recurrence's float32 terms: dt (B, S, 1), dt u
    (B, S, Di), b and c (B, S, N), and -a (Di, N).  Step t's decay is
    exp(dt_t (-a)) and its input (dt u)_t b_t^T; the reference forms both
    at (B, S, Di, N)."""
    u = u.float()
    b_t, c_t = (u @ params["w_bc"].float()).chunk(2, dim=-1)
    dt = _softplus(u @ params["w_dt"].float() + params["dt_bias"].float())
    neg_a = -torch.exp(params["log_a"].float())
    return dt, dt * u, b_t, c_t, neg_a


def ssm_scan(dt: torch.Tensor, dtu: torch.Tensor, b_t: torch.Tensor,
             c_t: torch.Tensor, neg_a: torch.Tensor):
    """The recurrence h_t = exp(dt_t (-a)) h_{t-1} + (dt u)_t b_t^T from
    h = 0, read out as y_t = h_t c_t.  Terms as `_ssm_terms` gives them.
    Returns (y (B, S, Di), final state (B, Di, N)), float32.

    Chunks of L positions (the sequence padded at its end with steps of decay 1 and input 0, which leave the state as it
    is): pass 1 runs each chunk's recurrence from 0, all chunks at once;
    the chunks' end states are carried across chunks (state_c =
    prod decay state_{c-1} + end_c, the product exp(-a sum dt)); pass 2
    runs each chunk again from its carried state and reads y.  2 L + S / L
    sequential steps in all, each a few elementwise kernels over every
    chunk (the same bytes whatever L), so L = sqrt(S / 2), which makes the
    fewest: 32 at S = 2048, 8 at S = 128."""
    bsz, s, di = dtu.shape
    n = b_t.shape[-1]
    ln = max(1, round(math.sqrt(s / 2)))
    nc = -(-s // ln)
    pad = nc * ln - s
    if pad:
        dt, dtu, b_t, c_t = (F.pad(t, (0, 0, 0, pad))
                             for t in (dt, dtu, b_t, c_t))
    dt = dt.reshape(bsz, nc, ln, 1, 1)
    dtu = dtu.reshape(bsz, nc, ln, di, 1)
    b_t = b_t.reshape(bsz, nc, ln, 1, n)
    c_t = c_t.reshape(bsz, nc, ln, n, 1)

    def decay(t):
        return torch.exp(dt[:, :, t] * neg_a)          # (B, nc, Di, N)

    def inp(t):
        return dtu[:, :, t] * b_t[:, :, t]             # (B, nc, Di, N)

    h = inp(0)
    for t in range(1, ln):
        h = torch.addcmul(inp(t), decay(t), h)
    whole = torch.exp(dt.sum(2) * neg_a)               # (B, nc, Di, N)
    state = torch.zeros_like(h[:, 0])
    carried = []
    for c in range(nc):
        carried.append(state)
        state = torch.addcmul(h[:, c], whole[:, c], state)
    h = torch.stack(carried, dim=1)
    ys = []
    for t in range(ln):
        h = torch.addcmul(inp(t), decay(t), h)
        ys.append(h @ c_t[:, :, t])                    # (B, nc, Di, 1)
    y = torch.stack(ys, dim=2).reshape(bsz, nc * ln, di)[:, :s]
    return y, h[:, -1]


def ssm_seq(params: Params, cfg: SSMCfg, x: torch.Tensor, *,
            return_state: bool = False):
    """Full-sequence selective SSM.  x: (B, S, D) -> (B, S, D) in x's
    dtype [, final state (B, Di, N) float32]."""
    u = F.silu(x @ params["w_in"])
    gate = F.silu(x @ params["w_gate"])
    dt, dtu, b_t, c_t, neg_a = _ssm_terms(params, u)
    y, state = ssm_scan(dt, dtu, b_t, c_t, neg_a)
    y = y + u.float() * params["d_skip"].float()
    out = ((y * gate.float()) @ params["w_out"].float()).to(x.dtype)
    return (out, state) if return_state else out


def init_ssm_state(batch: int, cfg: SSMCfg, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    return torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=dtype,
                       device=device)


def ssm_step(params: Params, cfg: SSMCfg, x: torch.Tensor,
             state: torch.Tensor):
    """Single-token step.  x: (B, 1, D); state: (B, Di, N).  The math is
    float32; returns (out (B, 1, D) in x's dtype, new state in the
    state's dtype)."""
    u = F.silu(x @ params["w_in"])
    gate = F.silu(x @ params["w_gate"])
    dt, dtu, b_t, c_t, neg_a = _ssm_terms(params, u)
    decay = torch.exp(dt[:, 0, :, None] * neg_a)       # (B, Di, N)
    new_state = decay * state.float() + dtu[:, 0, :, None] * b_t[:, 0, None]
    y = (new_state @ c_t[:, 0, :, None])[..., 0][:, None]
    y = y + u.float() * params["d_skip"].float()
    out = ((y * gate.float()) @ params["w_out"].float()).to(x.dtype)
    return out, new_state.to(state.dtype)


# ---------------------------------------------------------------------------
# RWKV-6 "Finch"
# ---------------------------------------------------------------------------
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
