"""Mixture-of-Experts layer: GShard-style capacity routing, functional
PyTorch.

Port of the reference package's `models/moe.py`.  Tokens are routed within
groups of at most ``group_size`` (the largest divisor of the token count
not above it); each token picks its ``top_k`` experts, and each (token, k)
selection takes the next slot of its expert's queue, token-major, up to
the capacity C = ceil(g top_k / E capacity_factor) of a group of g
tokens.  Later selections are dropped (combine weight 0); empty slots are
zero.  Experts are stacked: w_up / w_gate (E, D, F), w_down (E, F, D).

The reference builds (G, g, E, C) one-hot dispatch and combine tensors and
contracts them.  The port computes the same function in index form, in
four steps that a profiler can tell apart:

  * `route`: the router product in x's dtype, a float32 softmax, the
    top-k with ties to the lower expert index (XLA's `top_k` order), the
    renormalized gates, each selection's queue position and whether it is
    kept (`assign`);
  * `dispatch`: the token of every (expert, slot) gathered into
    (E, G * C, D), zero for an empty slot;
  * `experts`: the expert MLPs as batched products over E in x's dtype;
  * `combine`: each kept selection's expert output gathered back, weighted
    by its gate rounded to x's dtype, summed over k in float32 and rounded
    once (as the reference's float32-accumulated product of the rounded
    combine weights).

Shapes are static, nothing is written in place and nothing waits on the
host, so the layer runs under `torch.func.vmap` (the simulator's vmapped
gradient).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import layers

Params = dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int
    act: str = "swiglu"
    capacity_factor: float = 1.25
    group_size: int = 1024   # tokens per routing group


def init_moe(gen: torch.Generator, cfg: MoECfg,
             dtype=torch.float32) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    scale_in, scale_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    # Draw order as the reference's split keys: router, up, down, gate.
    p = {"router": layers._normal(gen, (d, e), scale_in, dtype),
         "w_up": layers._normal(gen, (e, d, f), scale_in, dtype),
         "w_down": layers._normal(gen, (e, f, d), scale_out, dtype)}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = layers._normal(gen, (e, d, f), scale_in, dtype)
    return dict(sorted(p.items()))


def _group_size(n_tokens: int, cfg: MoECfg) -> int:
    """``group_size``, or the largest divisor of ``n_tokens`` below it."""
    g = min(cfg.group_size, n_tokens)
    return next(c for c in range(g, 0, -1) if n_tokens % c == 0)


def _capacity(group: int, cfg: MoECfg) -> int:
    c = math.ceil(group * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(c, 1)


class Routing(NamedTuple):
    probs: torch.Tensor   # (G, g, E) float32 router probabilities
    idx: torch.Tensor     # (G, g, K) int64 expert of each selection
    gates: torch.Tensor   # (G, g, K) float32, renormalized, 0 where dropped
    pos: torch.Tensor     # (G, g, K) int64 position in the expert's queue
    keep: torch.Tensor    # (G, g, K) bool: pos < capacity


def router_probs(params: Params, xt: torch.Tensor) -> torch.Tensor:
    """xt: (G, g, D) -> (G, g, E) float32 softmax of the router logits,
    whose product is taken in xt's dtype."""
    return torch.softmax((xt @ params["router"]).float(), dim=-1)


def top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, largest first and
    equal values in index order, as XLA's `top_k` gives them (a stable
    descending sort; `torch.topk` promises no order for ties, and bfloat16
    router logits tie often)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def assign(probs: torch.Tensor, idx: torch.Tensor, cap: int) -> Routing:
    """The routing of selections ``idx`` (G, g, K) under ``probs``: gates
    renormalized over the k selections, each selection's position in its
    expert's queue (earlier tokens first, then lower k) and whether it
    fits in ``cap`` slots."""
    e = probs.shape[-1]
    ng, g, k = idx.shape
    vals = probs.gather(-1, idx)
    gates = vals / torch.clamp_min(vals.sum(-1, keepdim=True), 1e-9)
    # Selections of each expert, in (token, k) order along the last axis,
    # so that the count runs along the innermost dimension.
    rows = idx.reshape(ng, 1, g * k)
    sel = (rows == torch.arange(e, device=idx.device)[:, None]).int()
    before = torch.cumsum(sel, dim=-1) - sel                 # (G, E, g k)
    pos = before.gather(1, rows).reshape(ng, g, k).long()
    keep = pos < cap
    return Routing(probs, idx, gates * keep, pos, keep)


def route(params: Params, cfg: MoECfg, xt: torch.Tensor, cap: int) -> Routing:
    """Route the groups ``xt`` (G, g, D) into ``cap`` slots an expert."""
    probs = router_probs(params, xt)
    return assign(probs, top_k(probs, cfg.top_k), cap)


def _slots(r: Routing, cap: int, dropped: int) -> torch.Tensor:
    """Each selection's row in the (E, G, C) slot order, flattened; a
    dropped selection points at row ``dropped``."""
    group = torch.arange(r.idx.shape[0], device=r.idx.device)[:, None, None]
    return torch.where(r.keep, (r.idx * r.idx.shape[0] + group) * cap + r.pos,
                       dropped)


def dispatch(xt: torch.Tensor, r: Routing, cap: int) -> torch.Tensor:
    """xt: (G, g, D) -> (E, G * cap, D): slot (e, group, c) holds the token
    routed there, or zeros."""
    ng, g, d = xt.shape
    e = r.probs.shape[-1]
    k = r.idx.shape[-1]
    n_slots = e * ng * cap
    token = torch.arange(ng * g, device=xt.device).reshape(ng, g, 1)
    # Empty slots read the zero row appended after the T tokens.
    src = torch.full((n_slots + 1,), ng * g, dtype=torch.long,
                     device=xt.device)
    src = src.scatter(0, _slots(r, cap, n_slots).reshape(-1),
                      token.expand(ng, g, k).reshape(-1))
    rows = torch.cat([xt.reshape(ng * g, d), xt.new_zeros(1, d)])
    return rows[src[:n_slots]].reshape(e, ng * cap, d)


def experts(params: Params, act: str, xe: torch.Tensor) -> torch.Tensor:
    """The expert MLPs: xe (E, N, D) -> (E, N, D), batched over E."""
    up = torch.bmm(xe, params["w_up"])
    if act == "swiglu":
        h = F.silu(torch.bmm(xe, params["w_gate"])) * up
    elif act == "geglu":   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.bmm(xe, params["w_gate"]), approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.bmm(h, params["w_down"])


def combine(ye: torch.Tensor, r: Routing, cap: int) -> torch.Tensor:
    """ye: (E, G * cap, D) -> (G, g, D) in ye's dtype: each token's kept
    selections' outputs weighted by their gates rounded to that dtype,
    summed in float32 (a product over k, accumulated in float32) and
    rounded once.  A dropped selection reads slot 0 at weight 0."""
    ng, g, k = r.idx.shape
    d = ye.shape[-1]
    picked = ye.reshape(-1, d)[_slots(r, cap, 0)]       # (G, g, K, D)
    w = r.gates.to(ye.dtype).reshape(ng * g, 1, k)
    return torch.bmm(w, picked.reshape(ng * g, k, d)).reshape(ng, g, d)


def moe_layer(params: Params, cfg: MoECfg, x: torch.Tensor):
    """x: (B, S, D) -> (y (B, S, D), aux) with the Switch load-balance
    loss aux = E sum_e (share of selections of e) (mean router prob of e),
    taken before any drop, float32."""
    b, s, d = x.shape
    t = b * s
    g = _group_size(t, cfg)
    ng = t // g
    cap = _capacity(g, cfg)
    xt = x.reshape(ng, g, d)
    r = route(params, cfg, xt, cap)
    ye = experts(params, cfg.act, dispatch(xt, r, cap))
    y = combine(ye, r, cap)
    e = cfg.n_experts
    sel = (r.idx[..., None] == torch.arange(e, device=x.device)).float()
    frac_tokens = sel.sum(2).mean((0, 1))
    mean_probs = r.probs.mean((0, 1))
    aux = e * (frac_tokens * mean_probs).sum()
    return y.reshape(b, s, d), aux
