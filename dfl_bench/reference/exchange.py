"""Reference model exchange of one D-FL round (paper Sec. III).

Frozen copies, without importing the port, of:

  * min-E2E-PER routing (Proposition 1; `src/repro_torch/core/routing.py`
    `e2e_success`): all-pairs shortest paths on -log(eps) by
    Floyd–Warshall with a strict ``<``, rho = exp(-distance), 1 on the
    diagonal, 0 where unreachable.  It runs on the CPU in float32, in the
    port's order of operations, so that ``u < rho`` decides every packet as
    the port decides it.
  * eq. 6, adaptive normalization, and the substitution baseline
    (`src/repro_torch/core/aggregation.py`);
  * R&A's packet draws (`core/errors.py` `sample_success`), AaYG's J
    one-hop mixes and C-FL's lossy uplink / downlink star
    (`src/repro_torch/core/protocols.py`), and error-free C-FL.

Segments are (N, L, K): N clients' models cut into L packets of K values.
"""
from __future__ import annotations

import torch

PROTOCOLS = ("ra", "aayg", "cfl", "ideal_cfl", "none")
MODES = ("ra_normalized", "substitution")
_EPS = 1e-12


def route(link_eps: torch.Tensor) -> torch.Tensor:
    """rho (V, V) of a (V, V) per-link success matrix, on the CPU."""
    eps = link_eps.detach().to("cpu", torch.float32)
    v = eps.shape[0]
    tiny = torch.finfo(torch.float32).tiny
    inf = torch.tensor(float("inf"))
    cost = torch.where(eps > 0.0, -torch.log(torch.clamp(eps, tiny, 1.0)), inf)
    eye = torch.eye(v, dtype=torch.bool)
    dist = torch.where(eye, torch.zeros(()), cost)
    for k in range(v):
        through = dist[:, k, None] + dist[None, k, :]
        dist = torch.where(through < dist, through, dist)
    return torch.where(torch.isfinite(dist), torch.exp(-dist), torch.zeros(()))


def draw_shape(protocol: str, n: int, segments: int,
               mixes: int) -> tuple[int, ...] | None:
    """The shape of a round's uniforms (None: the protocol draws none)."""
    return {"ra": (n, n, segments), "aayg": (mixes, n, n, segments),
            "cfl": (2, n, segments)}.get(protocol)


def aggregate(w: torch.Tensor, p: torch.Tensor, e: torch.Tensor,
              mode: str) -> torch.Tensor:
    """Receiver n's segment l from the senders m with e[m, n, l] = 1.

    ra_normalized (eq. 6): sum_m p_m e w_m / sum_m p_m e.
    substitution: sum_m p_m (e w_m + (1 - e) w_n).
    """
    ef = e.to(torch.float32)
    if mode == "ra_normalized":
        wts = p[:, None, None] * ef
        coeff = wts / torch.clamp(wts.sum(dim=0, keepdim=True), min=_EPS)
        return torch.einsum("mnl,mlk->nlk", coeff, w)
    recv = torch.einsum("mnl,mlk->nlk", p[:, None, None] * ef, w)
    miss = (p[:, None, None] * (1.0 - ef)).sum(dim=0)
    return recv + miss[:, :, None] * w


def exchange(w: torch.Tensor, p: torch.Tensor, rho: torch.Tensor,
             link_eps: torch.Tensor, protocol: str, mode: str,
             aggregator: int, u: torch.Tensor | None) -> torch.Tensor:
    """One round's exchange of the trained segments ``w`` (N, L, K)."""
    n = w.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=w.device)[:, :, None]
    if protocol == "ra":
        e = (u < rho[:n, :n, None]) | eye
        return aggregate(w, p, e, mode)
    if protocol == "aayg":
        eps = link_eps[:n, :n, None]
        for j in range(u.shape[0]):
            w = aggregate(w, p, (u[j] < eps) | eye, mode)
        return w
    if protocol == "cfl":
        a = aggregator
        up = (u[0] < rho[:n, a, None]).to(torch.float32)
        up[a] = 1.0
        if mode == "ra_normalized":
            wts = p[:, None] * up
            g = (torch.einsum("ml,mlk->lk", wts, w)
                 / torch.clamp(wts.sum(dim=0), min=_EPS)[:, None])
        else:
            g = (torch.einsum("ml,mlk->lk", p[:, None] * up, w)
                 + (p[:, None] * (1.0 - up)).sum(dim=0)[:, None] * w[a])
        down = (u[1] < rho[a, :n, None]).to(torch.float32)
        down[a] = 1.0
        return down[:, :, None] * g[None] + (1.0 - down)[:, :, None] * w
    if protocol == "ideal_cfl":
        g = torch.einsum("m,mlk->lk", p, w)
        return g[None].expand(w.shape).contiguous()
    if protocol == "none":
        return w
    raise ValueError(f"unknown protocol {protocol!r}: choose from {PROTOCOLS}")
