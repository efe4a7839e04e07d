"""Convergence-bound machinery (paper Sec. IV: Lemmas 1-3, Theorems 1-2).

Port of the reference package's `core/convergence.py`: host-side
arithmetic on torch tensors (p and rho may also be numpy arrays).

These functions evaluate the paper's analytical quantities so experiments can
check that the bound's protocol-dependent term tracks empirical behaviour:

  * zeta coefficients of Lemma 1,
  * the bias-matrix bound  E||Lambda_l||^2 <= sum_{n,m} (1-rho_{m,n})(p_m^2+p_m)
    (eq. 17),
  * the one-round bound of Theorem 1 and the horizon bound of Theorem 2,
  * the routing objective  sum_m (p_m^2 + p_m) sum_n (1 - rho_{m,n}).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Smoothness:
    """Assumption-1 constants."""

    L: float
    mu: float
    eta: float
    I: int          # local epochs per round
    tau: float = 0.1  # noise-level parameter tau_rho of Lemma 1

    def __post_init__(self):
        if not 0 < self.eta < 1.0 / (2.0 * self.L):
            raise AssertionError("Assumption 1-3: eta < 1/(2L)")


def zetas(c: Smoothness) -> tuple[float, float, float, float]:
    """The zeta_1..zeta_4 coefficients of Lemma 1."""
    L, mu, eta, I, tau = c.L, c.mu, c.eta, c.I, c.tau
    a = 1.0 - 1.5 * mu * eta + 2.0 * L * mu * eta**2          # per-epoch contraction
    b = (1.0 + eta) * (1.0 + 4.0 * L**2 * eta)                # divergence growth
    z1 = a ** (I - 1) * (1.0 + tau) * (1.0 - 2.0 * mu * eta + eta**2 * L**2)
    geo_ab = (b ** (I - 1) - a ** (I - 1)) / (b - a) if b != a else (I - 1) * b ** (I - 2)
    geo_b = (b ** (I - 1) - 1.0) / (b - 1.0) if b != 1.0 else float(I - 1)
    front = 2.0 * (1.0 + eta) * (2.0 * eta**2 * L**2 + (L + mu) * eta) * b**2
    z2 = front / (1.0 + 4.0 * L**2 + 4.0 * L**2 * eta) * (geo_ab - geo_b / b**2)
    z2 = abs(z2)  # the paper's zeta_2 is a positive variance multiplier
    z3 = a ** (I - 1) * (1.0 + 1.0 / tau) * (1.0 + eta * L)
    z4 = (2.0 * eta**2 * L**2 + (L + mu) * eta) * b**2 * geo_ab
    return float(z1), float(z2), float(z3), float(z4)


def routing_objective(p, rho) -> torch.Tensor:
    """sum_n sum_m (1 - rho_{m,n}) (p_m^2 + p_m) — Theorem 1's dominant term.

    Minimized by min-E2E-PER routing (Proposition 1).
    """
    p = torch.as_tensor(p)
    rho = torch.as_tensor(rho)
    n = p.shape[0]
    r = rho[:n, :n]
    per = 1.0 - r
    return torch.sum(per * (p**2 + p)[:, None])


def lambda_bound(p, rho) -> torch.Tensor:
    """Eq. (17): upper bound on E||Lambda_l||^2 (identical to the routing
    objective; kept separate for clarity at call sites)."""
    return routing_objective(p, rho)


def theorem1_gap(
    c: Smoothness,
    p,
    rho,
    prev_gap: float,
    sigma_bar_sq: float,
    w_norm_sq: float,
) -> torch.Tensor:
    """One-round upper bound of Theorem 1.

    Args:
      prev_gap:     ||w_bar^{t-1} - w*||^2.
      sigma_bar_sq: global gradient-divergence bound  sigma_bar^2.
      w_norm_sq:    sum_l ||W_l^{t-1}||^2  (total squared norm of stacked
                    client models, summed over segments).
    """
    z1, z2, z3, z4 = zetas(c)
    pn = torch.as_tensor(p)
    diag_p_sq = torch.max(pn) ** 2              # ||diag(p)||^2 (spectral norm)
    diag_p = torch.max(pn)
    diag_sqrtp_minus_p_sq = torch.max((torch.sqrt(pn) - pn) ** 2)
    n = pn.shape[0]
    protocol = (
        z3 * n * diag_p_sq + z3 * c.eta * c.L * diag_p + z4 * diag_sqrtp_minus_p_sq
    )
    return (
        z1 * prev_gap
        + z2 * sigma_bar_sq
        + protocol * w_norm_sq * lambda_bound(pn, rho)
    )


def theorem2_gap(
    c: Smoothness,
    p,
    rho,
    sigma_bar_sq: float,
    lambda_max: float,
    horizon: int = 10_000,
) -> torch.Tensor:
    """Horizon (t -> inf) bound of Theorem 2 with static per-round channels."""
    z1, z2, z3, z4 = zetas(c)
    if not z1 < 1.0:
        raise AssertionError("Theorem 2 requires zeta_1 < 1")
    pn = torch.as_tensor(p)
    n = pn.shape[0]
    protocol = (
        z3 * n * torch.max(pn) ** 2
        + z3 * c.eta * c.L * torch.max(pn)
        + z4 * torch.max((torch.sqrt(pn) - pn) ** 2)
    )
    geom = z1 * (1.0 - z1**horizon) / (1.0 - z1)
    return z2 / (1.0 - z1) * sigma_bar_sq + geom * lambda_bound(pn, rho) * (
        lambda_max * protocol
    )
