"""Min-E2E-PER routing for R&A D-FL (paper Proposition 1).

Port of the reference package's `core/routing.py`.  The optimal route
between clients (m, n) maximizes the product of per-hop packet success
rates: the all-pairs shortest path on edge weights ``-log eps_{m,n}``,
computed by Floyd–Warshall over a dense cost matrix with next-hop pointers
for route reconstruction.  The relaxation keeps the strict ``<`` of the
reference, so ties resolve to the same next hops.
"""
from __future__ import annotations

import numpy as np
import torch


def floyd_warshall(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """All-pairs shortest paths on a dense non-negative cost matrix.

    Args:
      cost: (V, V) edge costs; inf where no edge; diagonal ignored.

    Returns:
      dist:     (V, V) shortest path costs (0 on diagonal).
      next_hop: (V, V) int32 next-hop matrix; next_hop[i, j] is the neighbor
                of i on the shortest i->j path (j itself for direct edges,
                i on the diagonal / unreachable pairs).
    """
    v = cost.shape[0]
    eye = torch.eye(v, dtype=torch.bool, device=cost.device)
    dist = torch.where(eye, torch.zeros((), dtype=cost.dtype,
                                        device=cost.device), cost)
    idx = torch.arange(v, dtype=torch.int32, device=cost.device)
    nxt = torch.where(torch.isfinite(cost) & ~eye,
                      idx[None, :].expand(v, v), idx[:, None].expand(v, v))
    for k in range(v):
        through_k = dist[:, k, None] + dist[None, k, :]
        better = through_k < dist
        dist = torch.where(better, through_k, dist)
        nxt = torch.where(better, nxt[:, k, None], nxt)
    return dist, nxt


def link_cost(link_eps: torch.Tensor) -> torch.Tensor:
    """Edge weight -log(eps) (inf for missing / zero-quality links).

    The clip floor is the dtype's smallest normal value, so it survives
    float32 (a literal 1e-300 would underflow to 0).
    """
    if not link_eps.is_floating_point():
        link_eps = link_eps.to(torch.float32)     # 0/1 integer matrices
    floor = torch.finfo(link_eps.dtype).tiny
    inf = torch.full((), float("inf"), dtype=link_eps.dtype,
                     device=link_eps.device)
    return torch.where(link_eps > 0.0,
                       -torch.log(torch.clamp(link_eps, floor, 1.0)), inf)


def e2e_success(link_eps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """E2E packet success rate matrix rho_{m,n} under min-PER routing (eq. 5).

    Returns (rho, next_hop).  rho has 1.0 on the diagonal (a client always
    "receives" its own model), 0.0 for unreachable pairs.
    """
    dist, nxt = floyd_warshall(link_cost(link_eps))
    rho = torch.where(torch.isfinite(dist), torch.exp(-dist),
                      torch.zeros((), dtype=dist.dtype, device=dist.device))
    return rho, nxt


def reconstruct_route(next_hop, src: int, dst: int,
                      max_hops: int | None = None) -> list[int]:
    """Node sequence src -> ... -> dst from a next-hop matrix (host-side).

    Returns ``[]`` when dst is unreachable: `floyd_warshall` marks an
    unreachable pair (i, j) with ``next_hop[i, j] == i``, checked at every
    hop, and a visited set rejects cycles in hand-built matrices.
    """
    next_hop = np.asarray(next_hop.cpu() if torch.is_tensor(next_hop)
                          else next_hop)
    if src == dst:
        return [src]
    if max_hops is None:
        max_hops = next_hop.shape[0] + 1
    route = [src]
    visited = {src}
    cur = src
    for _ in range(max_hops):
        nxt = int(next_hop[cur, dst])
        if nxt == cur:          # unreachable sentinel (at any hop)
            return []
        if nxt in visited:      # cycle: not a valid route
            return []
        route.append(nxt)
        if nxt == dst:
            return route
        visited.add(nxt)
        cur = nxt
    return []


def all_routes(next_hop, n_clients: int) -> dict[tuple[int, int], list[int]]:
    """All client-pair routes (host-side helper for overhead accounting)."""
    routes = {}
    for m in range(n_clients):
        for n in range(n_clients):
            if m != n:
                routes[(m, n)] = reconstruct_route(next_hop, m, n)
    return routes
