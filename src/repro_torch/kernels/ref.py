"""Plain PyTorch versions of the port's kernels.

  * ra_aggregate_ref    — the paper's adaptive-normalized segment
    aggregation (eq. 6) over client-stacked segment tensors.
  * ra_substitution_ref — the model-substitution baseline [12].
  * rwkv6_scan_ref      — the rwkv6 data-dependent-decay linear attention,
    as the sequential token recurrence with a float32 state.
  * flash_attention_ref — causal (or full) grouped-query softmax attention,
    optionally windowed, materialising the float32 logits.

The two aggregation rules take an optional per-segment transmit mask
``tx``, composed into the success mask as
`core.aggregation.apply_transmit_mask` does: a pruned sender segment is
delivered to nobody, and a receiver always holds its own.  Any leading
batch axes are allowed as long as ``p``, ``e`` and ``tx`` carry the same
ones as ``w_seg``.  Arithmetic is float32; the result takes ``w_seg``'s
dtype.  These are what the kernel wrappers run for tensors on the CPU,
and what `chip_smoke.py` holds the CUDA kernels to.
"""
from __future__ import annotations

import torch


def _mask(e: torch.Tensor, tx: torch.Tensor | None) -> torch.Tensor:
    """float32 (..., N, N, L) mask, with ``tx`` (..., N, L) composed in."""
    ef = e.to(torch.float32)
    if tx is None:
        return ef
    n = ef.shape[-3]
    eye = torch.eye(n, dtype=torch.float32, device=ef.device)[:, :, None]
    return torch.maximum(ef * tx.to(torch.float32)[..., :, None, :], eye)


def ra_aggregate_ref(w_seg: torch.Tensor, p: torch.Tensor, e: torch.Tensor,
                     tx: torch.Tensor | None = None) -> torch.Tensor:
    """Paper eq. (6).

    Args:
      w_seg: (..., N, L, K) client-stacked model segments.
      p:     (..., N) aggregation weights.
      e:     (..., N, N, L) success indicators (sender, receiver, segment).
      tx:    optional (..., N, L) transmit mask.

    Returns:
      (..., N, L, K) receiver-major aggregated segments:
        out[n, l] = sum_m p_m e[m,n,l] w[m,l] / max(sum_m p_m e[m,n,l], 1e-12)
    """
    w = p.to(torch.float32)[..., :, None, None] * _mask(e, tx)
    denom = torch.clamp(w.sum(dim=-3), min=1e-12)            # (..., N, L)
    num = torch.einsum("...mnl,...mlk->...nlk", w, w_seg.to(torch.float32))
    return (num / denom[..., None]).to(w_seg.dtype)


def ra_substitution_ref(w_seg: torch.Tensor, p: torch.Tensor,
                        e: torch.Tensor,
                        tx: torch.Tensor | None = None) -> torch.Tensor:
    """Model-substitution baseline [12] over segments.

    out[n, l] = sum_m p_m (e[m,n,l] w[m,l] + (1 - e[m,n,l]) w[n,l])
    """
    ef = _mask(e, tx)
    pf = p.to(torch.float32)[..., :, None, None]
    wf = w_seg.to(torch.float32)
    recv = torch.einsum("...mnl,...mlk->...nlk", pf * ef, wf)
    miss = (pf * (1.0 - ef)).sum(dim=-3)                      # (..., N, L)
    return (recv + miss[..., None] * wf).to(w_seg.dtype)


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, *,
                   return_state: bool = False):
    """Sequential rwkv6 recurrence (float32 state).

    r, k, v, w: (B, S, H, D) with w = per-step log decay (<= 0);
    u: (H, D) bonus.  Per head, state S in R^{DxD} (key index first):
      out_t = r_t · (S_{t-1} + diag(exp(u)) k_t v_t^T)
      S_t   = diag(exp(w_t)) S_{t-1} + k_t v_t^T
    Returns out (B, S, H, D) in ``r``'s dtype and, with ``return_state``,
    the final state (B, H, D, D) in float32.
    """
    b, s, h, d = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    eu = torch.exp(u.float())[None, :, :, None]            # (1, H, D, 1)
    state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(s):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]   # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", rf[:, t], state + eu * kv))
        state = torch.exp(wf[:, t])[..., None] * state + kv
    out = torch.stack(outs, dim=1).to(r.dtype)
    return (out, state) if return_state else out


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        scale: float, causal: bool = True,
                        window: int | None = None) -> torch.Tensor:
    """Grouped-query softmax attention, all in float32.

    q: (B, S, H, D); k, v: (B, S, KV, D) -> (B, S, H, D) in q's dtype.
    Query head h reads kv head h // (H // KV); with ``causal``, logits of
    later keys are set to -1e30 before the softmax, and with ``window``
    those of keys ``window`` or more rows back (the reference's
    sliding-window mask), causal or not.
    """
    b, s, h, d = q.shape
    kv = k.shape[2]
    qf = q.reshape(b, s, kv, h // kv, d).float()
    logits = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * scale
    idx = torch.arange(s, device=q.device)
    if causal:
        logits = logits.masked_fill(idx[:, None] < idx[None, :], -1e30)
    if window is not None:
        logits = logits.masked_fill(idx[:, None] - idx[None, :] >= window,
                                    -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, d).to(q.dtype)
