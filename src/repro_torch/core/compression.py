"""Exchange codecs: what goes over the air, segment by segment.

Port of the reference package's `core/compression.py`.  A codec sits
between local training and delivery:

  * ``none``  — every segment ships untouched (an exact pass-through).
  * ``topk``  — each client transmits only its ``ceil(ratio * S)``
                largest-L2-norm segments; pruned segments are never sent,
                so the (N, S) transmit mask composes with the channel's
                success mask (`aggregation.apply_transmit_mask`).
  * ``quant`` — every segment ships, rounded stochastically (unbiased) to
                ``ceil(ratio * dtype_bits)``-bit levels on a per-segment
                max-abs scale.

``compress_ratio`` is a scalar or a per-client (N,) vector (the ``budget``
selection policy produces one).  The quantizer's uniforms are an explicit
optional argument ``u`` of shape (N, n_real, K), so a test can replay the
reference's draws; without them they come from ``generator``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

# Codec selector values, as in the reference.
CODEC_IDS = {"none": 0, "topk": 1, "quant": 2}

# The same nudge as `selection.select_count`: float32 cannot represent
# ratios like 0.3 exactly (0.3 * 50 is 15.000001), and a raw ceil would
# keep 16 of 50 segments instead of the documented 15.
_CEIL_EPS = 1e-6


def _ceil_count(ratio, total: int) -> torch.Tensor:
    """clip(ceil(ratio * total - eps), 1, total) in float32, as int32."""
    r = torch.as_tensor(ratio, dtype=torch.float32)
    k = torch.ceil(r * total - _CEIL_EPS).to(torch.int32)
    return torch.clamp(k, 1, total)


def keep_count(compress_ratio, n_real: int) -> torch.Tensor:
    """Kept-segment count k = clip(ceil(ratio * S), 1, S), per ratio entry."""
    return _ceil_count(compress_ratio, n_real)


def quant_bits(compress_ratio, dtype_bits: int = 32) -> torch.Tensor:
    """Per-value bit width b = clip(ceil(ratio * dtype_bits), 1, B)."""
    return _ceil_count(compress_ratio, dtype_bits)


def descending_ranks(scores: torch.Tensor) -> torch.Tensor:
    """Rank of each entry along the last axis under a stable descending
    sort (ties toward the lower index), built by scatter (out of place:
    `torch.func.vmap` batches it, where it loops over an in-place one)."""
    order = torch.argsort(-scores, dim=-1, stable=True)
    pos = torch.arange(scores.shape[-1], device=scores.device)
    return torch.scatter(torch.empty_like(order), -1, order,
                         pos.expand_as(order))


def topk_transmit_mask(w_rows: torch.Tensor, compress_ratio, *,
                       n_real: int | None = None) -> torch.Tensor:
    """(N, S) bool transmit mask: each client's top-k segments by L2 norm.

    ``w_rows`` is the client-stacked (N, S, K) segment tensor, possibly
    padded past ``n_real`` real segments with zero rows (which rank last).
    Ties break toward the lower segment index.
    """
    n, s, _ = w_rows.shape
    n_real = s if n_real is None else n_real
    norms = w_rows.to(torch.float32).square().sum(dim=2)         # (N, S)
    k = keep_count(compress_ratio, n_real).to(w_rows.device)
    return descending_ranks(norms) < k.expand(n)[:, None]


def stochastic_quantize(w_rows: torch.Tensor, compress_ratio, *,
                        u: torch.Tensor | None = None,
                        generator: torch.Generator | None = None,
                        dtype_bits: int = 32,
                        n_real: int | None = None) -> torch.Tensor:
    """Unbiased stochastic uniform quantization on a per-segment scale.

    Each (client, segment) block is scaled by its max-abs value, rounded
    stochastically to ``levels = 2^bits - 1`` steps and rescaled; all-zero
    segments stay exactly zero.  ``u``: optional (N, n_real, K) uniforms,
    zero-padded to the row width past ``n_real``.
    """
    n, s, k_len = w_rows.shape
    n_real = s if n_real is None else n_real
    dev = w_rows.device
    bits = quant_bits(compress_ratio, dtype_bits).to(dev).expand(n)
    levels = torch.exp2(bits.to(torch.float32)) - 1.0             # (N,)
    w = w_rows.to(torch.float32)
    scale = w.abs().amax(dim=2, keepdim=True)                     # (N, S, 1)
    safe = torch.clamp(scale, min=torch.finfo(torch.float32).tiny)
    y = w / safe * levels[:, None, None]
    lo = torch.floor(y)
    shape = (n, n_real, k_len)
    if u is None:
        u = torch.rand(shape, generator=generator, device=dev)
    elif tuple(u.shape) != shape:
        raise ValueError(f"quantizer uniforms must have shape {shape}, got "
                         f"{tuple(u.shape)}")
    u = u.to(dev)
    if n_real != s:
        u = torch.nn.functional.pad(u, (0, 0, 0, s - n_real))
    q = lo + (u < (y - lo)).to(torch.float32)
    out = q / levels[:, None, None] * safe
    out = torch.where(scale > 0, out, torch.zeros((), device=dev))
    return out.to(w_rows.dtype)


def encode(codec_id: int, w_rows: torch.Tensor, compress_ratio, *,
           u: torch.Tensor | None = None,
           generator: torch.Generator | None = None,
           n_real: int | None = None,
           dtype_bits: int = 32) -> tuple[torch.Tensor, torch.Tensor]:
    """Apply codec ``codec_id`` (`CODEC_IDS`) to the client-stacked rows.

    Returns ``(w_tx, tx_mask)``: the segments as transmitted and the (N, S)
    bool transmit mask (all ones except under ``topk``).  Only ``quant``
    draws (``u`` / ``generator``, see `stochastic_quantize`).
    """
    n, s, _ = w_rows.shape
    if codec_id == CODEC_IDS["none"]:
        return w_rows, torch.ones((n, s), dtype=torch.bool,
                                  device=w_rows.device)
    if codec_id == CODEC_IDS["topk"]:
        return w_rows, topk_transmit_mask(w_rows, compress_ratio,
                                          n_real=n_real)
    if codec_id == CODEC_IDS["quant"]:
        w_tx = stochastic_quantize(w_rows, compress_ratio, u=u,
                                   generator=generator,
                                   dtype_bits=dtype_bits, n_real=n_real)
        return w_tx, torch.ones((n, s), dtype=torch.bool,
                                device=w_rows.device)
    raise ValueError(f"unknown codec id {codec_id}: choose from {CODEC_IDS}")


def bits_fraction(codec_id: int, compress_ratio, n_segments: int, *,
                  dtype_bits: int = 32) -> torch.Tensor:
    """Realized fraction of the uncompressed payload actually sent.

    none -> 1; topk -> k/S (kept-segment fraction); quant -> bits/B.
    """
    r = torch.as_tensor(compress_ratio, dtype=torch.float32)
    if codec_id == CODEC_IDS["none"]:
        return torch.ones_like(r)
    if codec_id == CODEC_IDS["topk"]:
        return keep_count(r, n_segments).to(torch.float32) / n_segments
    if codec_id == CODEC_IDS["quant"]:
        return quant_bits(r, dtype_bits).to(torch.float32) / dtype_bits
    raise ValueError(f"unknown codec id {codec_id}: choose from {CODEC_IDS}")


def host_factor(codec: str, compress_ratio: float, *,
                n_segments: int | None = None,
                dtype_bits: int = 32) -> float:
    """Host-side mirror of `bits_fraction` for overhead accounting
    (`core.overhead.Overhead.compressed`)."""
    if codec not in CODEC_IDS:
        raise ValueError(
            f"unknown codec {codec!r}: choose from {sorted(CODEC_IDS)}"
        )
    if not 0.0 < float(compress_ratio) <= 1.0:
        raise ValueError(
            f"compress_ratio must be in (0, 1], got {compress_ratio}"
        )
    if codec == "none":
        return 1.0
    if codec == "topk":
        if n_segments is None:
            raise ValueError("topk factor needs n_segments (S)")
        k = int(np.clip(math.ceil(compress_ratio * n_segments - _CEIL_EPS),
                        1, n_segments))
        return k / n_segments
    b = int(np.clip(math.ceil(compress_ratio * dtype_bits - _CEIL_EPS),
                    1, dtype_bits))
    return b / dtype_bits
