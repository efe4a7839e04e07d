"""Flash attention with a recomputing backward, in plain PyTorch.

Port of the reference package's `models/flash.py`, its memory-saving
training attention.  `layers._sdpa_chunked` (this module's `block_scan`)
keeps the (S, S) score tensor out of the forward, but autograd through the
block scan would still save every block's probabilities for the backward.
`FlashAttention` saves only (q, k, v, out, the rows' logsumexp) and
recomputes each block's probabilities in the backward while it sums dq,
dk and dv: the reference's `custom_vjp` as a `torch.autograd.Function`.
Like the reference's, it is plain tensor code and reaches no kernel.

Shapes: q (B, S, H, Dh); k, v (B, S, KV, Dh), grouped-query with
G = H // KV.  The chunk is the largest divisor of S at most ``chunk``.
"""
from __future__ import annotations

import torch


def chunk_size(s: int, chunk: int) -> int:
    """The reference's chunk rule: ``min(chunk, s)``, lowered to the largest
    divisor of ``s``."""
    c = min(chunk, s)
    while s % c:
        c -= 1
    return c


def _block_mask(s: int, c: int, jblk: int, *, causal: bool,
                window: int | None, device) -> torch.Tensor:
    q_idx = torch.arange(s, device=device)
    k_idx = jblk * c + torch.arange(c, device=device)
    mask = torch.ones((s, c), dtype=torch.bool, device=device)
    if causal:
        mask &= q_idx[:, None] >= k_idx[None, :]
    if window is not None:
        mask &= q_idx[:, None] - k_idx[None, :] < window
    return mask


def _block_logits(qr, kb, scale, mask):
    """Masked float32 logits (B, KV, G, S, C) of one key block: the product
    in the inputs' dtype, then float32, the scale and -1e30 where masked."""
    logits = torch.einsum("bskgd,bckd->bkgsc", qr, kb).float() * scale
    return logits.masked_fill(~mask, -1e30)


def block_scan(q, k, v, scale: float, causal: bool = True,
               window: int | None = None, chunk: int = 512):
    """The online softmax over key blocks (the reference's `_fwd`).
    Returns (out (B, S, H, Dh) in q's dtype, logsumexp (B, KV, G, S)
    float32)."""
    b, s, h, dh = q.shape
    kv = k.shape[2]
    g = h // kv
    c = chunk_size(s, chunk)
    qr = q.reshape(b, s, kv, g, dh)
    m = torch.full((b, kv, g, s), -torch.inf, device=q.device)
    denom = torch.zeros((b, kv, g, s), device=q.device)
    acc = torch.zeros((b, kv, g, s, dh), device=q.device)
    for j in range(s // c):
        kb, vb = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
        logits = _block_logits(qr, kb, scale, _block_mask(
            s, c, j, causal=causal, window=window, device=q.device))
        m_new = torch.maximum(m, logits.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(logits - m_new[..., None])
        denom = denom * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgsc,bckd->bkgsd", p.to(vb.dtype), vb).float()
        m = m_new
    denom = denom.clamp_min(1e-30)
    out = acc / denom[..., None]
    lse = m + torch.log(denom)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, h, dh)
    return out.to(q.dtype), lse


class FlashAttention(torch.autograd.Function):
    """`block_scan`, with the reference's flash backward.  Written in the
    `setup_context` form, with a generated vmap rule, so that `torch.func`
    transforms (the simulator's vmapped gradient) can run it too."""

    generate_vmap_rule = True

    @staticmethod
    def forward(q, k, v, scale, causal, window, chunk):
        return block_scan(q, k, v, scale, causal, window, chunk)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, scale, causal, window, chunk = inputs
        out, lse = output
        ctx.mark_non_differentiable(lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (scale, causal, window, chunk)

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, chunk = ctx.args
        b, s, h, dh = q.shape
        kv = k.shape[2]
        g = h // kv
        c = chunk_size(s, chunk)
        qr = q.reshape(b, s, kv, g, dh)
        do = dout.reshape(b, s, kv, g, dh).float()
        o = out.reshape(b, s, kv, g, dh).float()
        # delta_i = sum_d do_i o_i, the rows' correction term.
        delta = (do * o).sum(-1).permute(0, 2, 3, 1)       # (B, KV, G, S)
        do_t = do.permute(0, 2, 3, 1, 4)                    # (B, KV, G, S, Dh)
        dq = torch.zeros((b, s, kv, g, dh), device=q.device)
        dk, dv = [], []
        for j in range(s // c):
            kb, vb = k[:, j * c:(j + 1) * c], v[:, j * c:(j + 1) * c]
            logits = _block_logits(qr, kb, scale, _block_mask(
                s, c, j, causal=causal, window=window, device=q.device))
            p = torch.exp(logits - lse[..., None])          # exact probabilities
            dv.append(torch.einsum("bkgsc,bkgsd->bckd", p, do_t))
            dp = torch.einsum("bkgsd,bckd->bkgsc", do_t, vb.float())
            ds = p * (dp - delta[..., None]) * scale
            dq = dq + torch.einsum("bkgsc,bckd->bskgd", ds, kb.float())
            dk.append(torch.einsum("bkgsc,bskgd->bckd", ds, qr.float()))
        return (dq.reshape(b, s, h, dh).to(q.dtype),
                torch.cat(dk, dim=1).to(k.dtype),
                torch.cat(dv, dim=1).to(v.dtype), None, None, None, None)


def flash_attention(q, k, v, scale: float, causal: bool = True,
                    window: int | None = None, chunk: int = 512):
    """Memory-efficient attention with the flash backward.  Returns
    (B, S, H, Dh) in q's dtype."""
    return FlashAttention.apply(q, k, v, scale, causal, window, chunk)[0]
