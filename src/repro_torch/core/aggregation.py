"""Local model aggregation rules (paper Sec. III-B.3 + benchmarks).

Port of the reference package's `core/aggregation.py`.

  * ``ra_normalized`` — the paper's adaptive aggregation-coefficient
                        normalization (eq. 6): per segment, weights of the
                        error-free senders are renormalized to sum to 1.
  * ``substitution``  — baseline [12]: erroneous segments are replaced by
                        the receiver's own corresponding segment, ideal
                        weights p_m retained.
  * ``ideal``         — error-free weighted average (C-FL / eq. 8 target).

Inputs are client-stacked segment tensors W (N, L, K), success masks
e (N, N, L) with e[m, n, l] = 1 iff segment l of sender m reached receiver
n error-free, and weights p (N,).  Outputs are receiver-major (N, L, K).

A participation mask s (N,) composes through `mask_senders` (sampled-out
senders leave e) and `keep_nonparticipants` (sampled-out receivers keep
their own segments).

Substrates: `apply_mode` — the simulator's aggregation hot path — runs on
``torch`` (the einsum versions in this module) or ``kernel`` (the CUDA
kernel through `kernels.ops.ra_aggregate`, whose CPU twin is the plain
version in `kernels.ref`); ``auto`` picks the kernel for CUDA tensors and
the einsum versions elsewhere.  Masks may arrive packed (bool/uint8) and
are cast to float32 once, at the aggregation boundary.

The process-wide default substrate, for calls that pass ``impl=None``, is
read from ``REPRO_AGG_IMPL`` as in the reference (`default_impl`).  Its
values map onto the port's: ``auto`` -> ``auto``, ``jnp`` -> ``torch``
(the plain einsum versions), ``pallas`` -> ``kernel``; the port's own
names ``torch`` and ``kernel`` are taken as they are, and anything else
raises.
"""
from __future__ import annotations

import os

import torch

from ..kernels import ops

_EPS = 1e-12

IMPLS = ("auto", "torch", "kernel")
# REPRO_AGG_IMPL's values (the reference's substrate names, and the port's
# own) -> the port's substrate.
_ENV_IMPLS = {"auto": "auto", "jnp": "torch", "pallas": "kernel",
              "torch": "torch", "kernel": "kernel"}


def default_impl() -> str:
    """The process-wide substrate (``REPRO_AGG_IMPL``, default auto),
    mapped onto `IMPLS` by `_ENV_IMPLS`; an unknown value raises."""
    value = os.environ.get("REPRO_AGG_IMPL", "auto")
    if value not in _ENV_IMPLS:
        raise ValueError(f"REPRO_AGG_IMPL={value!r} is not one of "
                         f"{sorted(_ENV_IMPLS)}")
    return _ENV_IMPLS[value]


def resolve_impl(impl: str | None = None,
                 device: torch.device | None = None) -> str:
    """Normalize an impl choice to one of `IMPLS`.

    ``None`` defers to `default_impl`.  With a ``device``, ``auto``
    resolves to a concrete substrate: the kernel on CUDA, the einsum
    versions elsewhere (without one it stays ``auto``, resolved per call
    by the tensors' device).
    """
    impl = default_impl() if impl is None else impl
    if impl not in IMPLS:
        raise ValueError(f"agg_impl must be one of {IMPLS}, got {impl!r}")
    if impl == "auto" and device is not None:
        return "kernel" if torch.device(device).type == "cuda" else "torch"
    return impl
MODE_IDS = {"ra_normalized": 0, "substitution": 1}
MODE_NAMES = tuple(MODE_IDS)


def _as_f32_mask(e: torch.Tensor) -> torch.Tensor:
    """The single packed-mask -> float32 cast at the aggregation boundary."""
    return e if e.dtype == torch.float32 else e.to(torch.float32)


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)[:, :, None]


def aggregation_coefficients(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Adaptive coefficients p_{m,n,l} = p_m e_{m,n,l} / sum_m' p_m' e_{m',n,l}.

    Returns (N, N, L); for every (n, l) the coefficients over m sum to 1
    (the own model always counts).
    """
    w = p[:, None, None] * _as_f32_mask(e)
    denom = w.sum(dim=0, keepdim=True)
    return w / torch.clamp(denom, min=_EPS)


def ra_normalized(w_seg: torch.Tensor, p: torch.Tensor,
                  e: torch.Tensor) -> torch.Tensor:
    """Paper eq. (6): adaptively normalized aggregation.

    out[n, l] = sum_m p_m e[m,n,l] w_seg[m, l] / sum_m p_m e[m,n,l]
    """
    coeff = aggregation_coefficients(p, e)
    return torch.einsum("mnl,mlk->nlk", coeff, w_seg)


def substitution(w_seg: torch.Tensor, p: torch.Tensor,
                 e: torch.Tensor) -> torch.Tensor:
    """Model-substitution baseline [12].

    out[n, l] = sum_m p_m * (e[m,n,l] w[m,l] + (1 - e[m,n,l]) w[n,l])
    """
    ef = _as_f32_mask(e)
    recv = torch.einsum("mnl,mlk->nlk", p[:, None, None] * ef, w_seg)
    miss = (p[:, None, None] * (1.0 - ef)).sum(dim=0)           # (N, L)
    return recv + miss[:, :, None] * w_seg


def ideal(w_seg: torch.Tensor, p: torch.Tensor,
          e: torch.Tensor | None = None,
          participation: torch.Tensor | None = None) -> torch.Tensor:
    """Error-free global aggregate, broadcast to every receiver (eq. 8).

    With a ``participation`` mask s the aggregate renormalizes over the
    sampled clients and only sampled receivers take it.
    """
    if participation is None:
        g = torch.einsum("m,mlk->lk", p, w_seg)
        return g[None].expand(w_seg.shape).contiguous()
    n = w_seg.shape[0]
    s = participation[:n]
    w = p * s
    g = torch.einsum("m,mlk->lk", w, w_seg) / torch.clamp(w.sum(), min=_EPS)
    return keep_nonparticipants(s, g[None].expand(w_seg.shape), w_seg)


def mask_senders(e: torch.Tensor, participation: torch.Tensor) -> torch.Tensor:
    """Remove sampled-out SENDERS from a success mask.

    Zeroes e[m, :, :] for every m with participation[m] == 0, keeping the
    own-model diagonal at 1.  Packed bool masks stay packed.
    """
    n = e.shape[0]
    if e.dtype == torch.bool:
        masked = e & (participation[:n, None, None] > 0)
        return masked | _eye(n, e)
    masked = e * participation[:n, None, None]
    return torch.maximum(masked, _eye(n, masked))


def apply_transmit_mask(e: torch.Tensor, tx: torch.Tensor) -> torch.Tensor:
    """Compose a per-segment TRANSMIT mask tx (N, L) into a success mask.

    A pruned segment (tx[m, l] == 0) is never sent: it leaves e for every
    receiver, with the own-model diagonal kept at 1.
    """
    n = e.shape[0]
    if e.dtype == torch.bool:
        masked = e & (tx[:n, None, :] > 0)
        return masked | _eye(n, e)
    masked = e * tx[:n, None, :]
    return torch.maximum(masked, _eye(n, masked))


def keep_nonparticipants(participation: torch.Tensor,
                         aggregated: torch.Tensor,
                         w_seg: torch.Tensor) -> torch.Tensor:
    """Sampled-out RECEIVERS keep their own segments untouched."""
    n = w_seg.shape[0]
    s = participation[:n].reshape((-1,) + (1,) * (w_seg.ndim - 1))
    return torch.where(s > 0, aggregated, w_seg)


_MODE_FNS = (ra_normalized, substitution)

AGGREGATORS = {
    "ra_normalized": ra_normalized,
    "substitution": substitution,
    "ideal": ideal,
}


def apply_mode(mode_id: int, w_seg: torch.Tensor, p: torch.Tensor,
               e: torch.Tensor, *, tx: torch.Tensor | None = None,
               impl: str | None = "auto") -> torch.Tensor:
    """Aggregate with the mechanism ``mode_id`` (see MODE_IDS).

    ``impl`` selects the substrate: ``torch`` (einsum, this module),
    ``kernel`` (`kernels.ops.ra_aggregate`: the CUDA kernel for CUDA
    tensors, its plain version for CPU tensors), ``auto`` (the kernel on
    CUDA, einsum elsewhere) or None (`default_impl`).  ``tx`` is an
    optional (N, L) transmit mask (`apply_transmit_mask`); the kernel
    composes it on chip.
    """
    impl = resolve_impl(impl, w_seg.device)
    if impl == "kernel":
        return ops.ra_aggregate(w_seg, p, e, tx=tx, mode=MODE_NAMES[mode_id],
                                device=w_seg.device)
    if tx is not None:
        e = apply_transmit_mask(e, tx)
    return _MODE_FNS[mode_id](w_seg, p, _as_f32_mask(e))


def bias_matrix(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """Aggregation bias matrix Lambda_l with entries p_m - p_{m,n,l} (eq. 10).

    Returns (L, N, N): one (sender x receiver) bias matrix per segment.
    """
    coeff = aggregation_coefficients(p, e)          # (m, n, l)
    lam = p[:, None, None] - coeff
    return lam.permute(2, 0, 1)


def bias_sq_norm(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """||Lambda_l||_F^2 per segment, shape (L,) — the Fig. 8 statistic
    (the entry-wise sum of squares the paper's bound (26a) uses)."""
    lam = bias_matrix(p, e)
    return (lam * lam).sum(dim=(1, 2))


def bias_sq_norm_fused(p: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """||Lambda_l||_F^2 per segment (Fig. 8 statistic), shape (L,).

    Lambda_l has entries p_m - p_{m,n,l} (eq. 10).  Because e is 0/1 the
    entry-wise sum of squares collapses onto two (N, L) reductions:

      sum_m (p_m - p_m e/d)^2 = sum_m p_m^2 - (2/d - 1/d^2) sum_m p_m^2 e

    with d[n, l] = sum_m p_m e[m, n, l] clamped like
    `aggregation_coefficients`; no (N, N, L) coefficient tensor is kept.
    """
    w = p[:, None, None] * _as_f32_mask(e)
    d = torch.clamp(w.sum(dim=0), min=_EPS)                 # (N, L)
    s2 = (p[:, None, None] * w).sum(dim=0)                  # (N, L)
    per_nl = (p * p).sum() - (2.0 / d - 1.0 / (d * d)) * s2
    return per_nl.sum(dim=0)                                # (L,)
