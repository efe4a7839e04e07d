"""Min-E2E-PER routing for R&A D-FL (paper Proposition 1).

Port of the reference package's `core/routing.py`.  The optimal route
between clients (m, n) maximizes the product of per-hop packet success
rates: the all-pairs shortest path on edge weights ``-log eps_{m,n}``,
computed by Floyd–Warshall over a dense cost matrix with next-hop pointers
for route reconstruction.  The relaxation keeps the strict ``<`` of the
reference, so ties resolve to the same next hops.  The Section-IV
admission of homologous route-sets under limited bandwidth closes the
module (`admission_scores`, `admit_homologous_routes`,
`admitted_rho_mask`).
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


def route_edges(route: list[int]) -> list[tuple[int, int]]:
    """Undirected edge list (u<v canonical) of a node-sequence route."""
    return [tuple(sorted((route[i], route[i + 1])))
            for i in range(len(route) - 1)]


# ---------------------------------------------------------------------------
# Bandwidth-constrained joint routing (Section IV, final paragraphs).
# ---------------------------------------------------------------------------
def admission_scores(p, rho):
    """Section-IV admission priority: ``(p_m^2 + p_m) * sum_n (1 - rho_{m,n})``.

    Pure arithmetic on numpy arrays or torch tensors alike: it serves the
    host-side admission order (`admit_homologous_routes`) and the
    bandwidth-aware selection policies (`core.selection`).

    Args: p (N,) weights; rho (N, N) client-block E2E success matrix.
    Returns: (N,) scores (higher = admitted earlier).
    """
    deficiency = (1.0 - rho).sum(1)
    return (p * p + p) * deficiency


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if torch.is_tensor(x) else x)


def admit_homologous_routes(p, rho, *, n_clients: int,
                            max_admitted: int | None = None) -> list[int]:
    """Priority admission of homologous route-sets under limited bandwidth:
    per-source route sets (source m -> all destinations) in decreasing
    `admission_scores` order (a stable sort: ties keep the lower index).

    Returns the admission order (list of source client indices).
    """
    p = _host(p)
    rho = _host(rho)[:n_clients, :n_clients]
    order = list(np.argsort(-admission_scores(p, rho), kind="stable"))
    if max_admitted is not None:
        order = order[:max_admitted]
    return [int(i) for i in order]


def admitted_rho_mask(p, rho, *, n_clients: int,
                      max_admitted: int | None = None) -> np.ndarray:
    """``rho`` masked to the admitted homologous route-sets (host-side).

    A non-admitted source's row of the client block zeroes except the
    diagonal (a client always holds its own model); rows past
    ``n_clients`` (routing-only relays) pass through untouched.
    """
    rho = np.array(_host(rho), copy=True)
    admitted = admit_homologous_routes(
        p, rho, n_clients=n_clients, max_admitted=max_admitted
    )
    cut = np.ones(rho.shape[0], dtype=bool)
    cut[np.asarray(admitted, dtype=int)] = False
    cut[n_clients:] = False
    block = rho[:n_clients, :n_clients]        # view: writes through
    diag = np.diagonal(block).copy()
    block[cut[:n_clients]] = 0.0
    np.fill_diagonal(block, diag)
    return rho
