"""Closed-loop client-selection policies.

Port of the reference package's `core/selection.py`.  Every round the
participation mask is computed from per-client signals carried in the
round loop's state:

  * ``uniform``   — the scenario's precomputed participation mask,
                    unchanged (all ones when it has none).
  * ``loss``      — the k clients with the largest trailing train loss.
  * ``grad_norm`` — the k clients whose last local update moved furthest.
  * ``bandwidth`` — the k sources the Section-IV admission rule
                    (`routing.admission_scores`) admits first.
  * ``budget``    — ``select_frac * N`` full-model transmissions
                    waterfilled down the admission ranking: who takes part
                    (allocation > 0) and, under a codec, how much each
                    compresses (`budget_ratio`).

Clients the precomputed schedule rules out are unavailable (score
``-inf``) and never selected.  ``k = clip(ceil(select_frac * N), 1, N)``.
Ranks come from a stable descending sort: ties break toward the lower
client index, so the all-``+inf`` update norms of round 0 pick the lowest
indices first.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import routing
from .compression import descending_ranks

# Policy selector values, as in the reference.
POLICY_IDS = {"uniform": 0, "loss": 1, "grad_norm": 2, "bandwidth": 3,
              "budget": 4}


class SelectionSignals(NamedTuple):
    """Live per-client signals carried in the round loop's state.

    ``loss`` — trailing train loss, (N,) float32.
    ``upd_norm`` — trailing local parameter-update norm, (N,) float32.
    """

    loss: torch.Tensor
    upd_norm: torch.Tensor


def init_signals(loss0: torch.Tensor) -> SelectionSignals:
    """Round-0 signals: the common init's per-client loss and optimistic
    (+inf) update norms, so a client that never trained keeps priority
    under ``grad_norm`` until it has taken part once."""
    loss0 = torch.as_tensor(loss0, dtype=torch.float32)
    return SelectionSignals(loss=loss0,
                            upd_norm=torch.full_like(loss0, float("inf")))


def select_count(select_frac, n: int) -> torch.Tensor:
    """Participant count k = clip(ceil(frac * N - 1e-6), 1, N) in float32
    (the nudge keeps 0.3 * 50 = 15.000001 at 15)."""
    frac = torch.as_tensor(select_frac, dtype=torch.float32)
    k = torch.ceil(frac * n - 1e-6).to(torch.int32)
    return torch.clamp(k, 1, n)


def topk_mask(scores: torch.Tensor, k) -> torch.Tensor:
    """(N,) float32 mask of the k highest-scoring clients (stable ranks;
    ``-inf`` scores rank last)."""
    k = torch.as_tensor(k, device=scores.device)
    return (descending_ranks(scores) < k).to(torch.float32)


def budget_allocation(base_mask: torch.Tensor, p: torch.Tensor,
                      rho: torch.Tensor, select_frac) -> torch.Tensor:
    """Per-client transmit budget waterfill (the ``budget`` policy's core).

    The budget ``B = select_frac * N`` full-model transmissions goes down
    the availability-gated admission ranking: the client ranked r gets
    ``clip(B - r, 0, 1)``; unavailable clients get 0.
    """
    n = base_mask.shape[0]
    budget = torch.as_tensor(select_frac, dtype=torch.float32,
                             device=base_mask.device) * n
    avail = base_mask > 0
    scores = torch.where(avail, routing.admission_scores(p, rho[:n, :n]),
                         -torch.inf)
    ranks = descending_ranks(scores)
    alloc = torch.clamp(budget - ranks.to(torch.float32), 0.0, 1.0)
    return alloc * avail.to(torch.float32)


def budget_ratio(policy_id: int, base_mask: torch.Tensor, p: torch.Tensor,
                 rho: torch.Tensor, select_frac, base_ratio) -> torch.Tensor:
    """The (N,) per-client compress ratio a codec scenario realizes: the
    waterfill scaled by the scenario's ratio under ``budget``, the scalar
    ratio broadcast under every other policy."""
    n = base_mask.shape[0]
    scalar = torch.as_tensor(base_ratio, dtype=torch.float32,
                             device=base_mask.device).reshape(()).expand(n)
    if policy_id == POLICY_IDS["budget"]:
        return budget_allocation(base_mask, p, rho, select_frac) * scalar
    return scalar


def select_clients(policy_id: int, base_mask: torch.Tensor,
                   signals: SelectionSignals, p: torch.Tensor,
                   rho: torch.Tensor, select_frac) -> torch.Tensor:
    """The round's (N,) float32 participation mask under ``policy_id``.

    ``base_mask`` is the scenario's open-loop mask for the round (all ones
    when it has none); ``rho`` the (N, N) client-block E2E success matrix;
    ``select_frac`` the participant fraction (ignored by ``uniform``).
    """
    n = base_mask.shape[0]
    k = select_count(select_frac, n)
    avail = base_mask > 0

    def gated(scores):
        return torch.where(avail, scores, -torch.inf)

    if policy_id == POLICY_IDS["uniform"]:
        return base_mask
    if policy_id == POLICY_IDS["loss"]:
        return topk_mask(gated(signals.loss), k) * base_mask
    if policy_id == POLICY_IDS["grad_norm"]:
        return topk_mask(gated(signals.upd_norm), k) * base_mask
    if policy_id == POLICY_IDS["bandwidth"]:
        scores = routing.admission_scores(p, rho[:n, :n])
        return topk_mask(gated(scores), k) * base_mask
    if policy_id == POLICY_IDS["budget"]:
        alloc = budget_allocation(base_mask, p, rho, select_frac)
        return (alloc > 0).to(torch.float32)
    raise ValueError(f"unknown policy id {policy_id}: choose from "
                     f"{POLICY_IDS}")


def update_norms(new_views: dict, old_views: dict) -> torch.Tensor:
    """Per-client L2 norm of the update between two client-stacked
    parameter dicts (every leaf (N, ...)), reduced leaf by leaf in the
    dicts' order: the ``grad_norm`` policy's signal."""
    sq = [(a - old_views[name]).square().reshape(a.shape[0], -1).sum(dim=1)
          for name, a in new_views.items()]
    return torch.sqrt(sum(sq)).to(torch.float32)
