"""One-round model-exchange protocols (paper Sec. III + benchmarks Sec. V).

Port of the segment-level layer of the reference package's
`core/protocols.py`.  Every function takes client-stacked segment tensors
w_seg (N, L, K), the aggregation weights p (N,) and link / E2E quality
matrices, and returns the segments after local aggregation.

  * `ra_round_seg`    — Route-and-Aggregate D-FL (the paper's proposal):
                        each segment survives its min-E2E-PER route with
                        prob rho_{m,n}; receivers run adaptive
                        normalization (or the substitution baseline).
  * `aayg_round_seg`  — Aggregate-as-You-Go gossip: J one-hop mixes.
  * `cfl_round_seg`   — Centralized FL via routes: lossy uplink to an
                        aggregator, lossy downlink back.
  * `ideal_round_seg` — error-free C-FL.
  * `dispatch_round_seg` selects one of them (plus "none") by protocol id.

The pytree-level wrappers `ra_round`, `aayg_round`, `cfl_round` and
`ideal_cfl_round` take client-stacked params (a flat dict, leaves (N, ...))
and a static ``seg_len`` / mode name, segment them, run the round and
rebuild the dict (`launch.train`'s exchange).

The codec layer (`core.compression`) threads in through ``tx_mask``, the
(N, S) per-segment transmit mask at full width, and ``w_raw``, the
unencoded segments (`dispatch_round_seg`).

Random draws: each function that samples takes its uniforms as ``u``
(shapes below) so a test can replay the reference's draws; without them it
draws from ``generator`` on the segments' device.

Model-axis sharding: with ``seg_total=S`` a round runs on one model
shard's window, ``w_seg`` being the (N, L_local, K) slice of the global
(N, S, K) rows that starts at segment ``seg_start``.  Every draw is taken
at the full width S (``u`` has S where the shapes below say L) and sliced
to the window (`errors.local_slice`), so the shards of one scenario,
drawing alike, aggregate each global segment as the unsharded round does;
the R&A mask returned is the full (N, N, S) one, so the bias diagnostic
agrees across shards.  ``seg_total=None`` is the unsharded round.
"""
from __future__ import annotations

import math

import torch

from . import aggregation, errors

# Protocol selector values, as in the reference.
PROTOCOL_IDS = {"ra": 0, "aayg": 1, "cfl": 2, "ideal_cfl": 3, "none": 4}
MODE_IDS = aggregation.MODE_IDS


def _to_segments(stacked: dict, seg_len: int):
    mat, spec = errors.stack_to_matrix(stacked)
    m_params = mat.shape[1]
    return errors.segment(mat, seg_len), spec, m_params


def _from_segments(seg: torch.Tensor, spec, m_params: int) -> dict:
    return errors.matrix_to_stack(errors.unsegment(seg, m_params), spec)


def _uniform(shape, u, generator, device) -> torch.Tensor:
    if u is None:
        return torch.rand(shape, generator=generator, device=device)
    if tuple(u.shape) != tuple(shape):
        raise ValueError(f"uniforms must have shape {tuple(shape)}, got "
                         f"{tuple(u.shape)}")
    return u.to(device)


def ra_round_seg(
    w_seg: torch.Tensor,
    p: torch.Tensor,
    rho: torch.Tensor,
    mode_id: int,
    participation: torch.Tensor | None = None,
    *,
    tx_mask: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    agg_impl: str = "auto",
    seg_total: int | None = None,
    seg_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """R&A local aggregation on segments; returns (out, e) with the sampled
    packed-bool success mask exposed for the bias diagnostic.

    ``u``: optional (N, N, L) uniforms for the success mask.  With a
    ``participation`` mask (N,), sampled-out senders leave ``e`` and
    sampled-out receivers keep their own segments.  The codec's
    ``tx_mask`` (N, L) composes into the returned ``e`` (the realized
    coefficients) and reaches the aggregation separately, so the kernel
    runs its transmit-mask variant.
    """
    n, l = w_seg.shape[0], w_seg.shape[1]
    l_draw = l if seg_total is None else seg_total
    e = errors.sample_success(
        rho, l_draw, n_clients=n,
        u=_uniform((n, n, l_draw), u, generator, w_seg.device))
    if participation is not None:
        e = aggregation.mask_senders(e, participation)
    e_loc, tx_loc = e, tx_mask
    if seg_total is not None:
        e_loc = errors.local_slice(e, l, seg_start)
        if tx_mask is not None:
            tx_loc = errors.local_slice(tx_mask, l, seg_start)
    out = aggregation.apply_mode(mode_id, w_seg, p, e_loc, tx=tx_loc,
                                 impl=agg_impl)
    if tx_mask is not None:
        e = aggregation.apply_transmit_mask(e, tx_mask)
    if participation is not None:
        out = aggregation.keep_nonparticipants(participation, out, w_seg)
    return out, e


def aayg_round_seg(
    w_seg: torch.Tensor,
    p: torch.Tensor,
    link_eps: torch.Tensor,
    mode_id: int,
    *,
    n_mixes: int = 1,
    participation: torch.Tensor | None = None,
    tx_mask: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    agg_impl: str = "auto",
    seg_total: int | None = None,
    seg_start: int = 0,
) -> torch.Tensor:
    """Aggregate-as-You-Go gossip: J = n_mixes one-hop mix iterations.

    ``link_eps`` is the (V, V) one-hop packet success matrix; only the
    leading N-client block takes part.  ``u``: optional (J, N, N, L)
    uniforms, one (N, N, L) draw per mix.  A ``participation`` mask
    silences sampled-out clients for the whole round.  The codec's
    ``tx_mask`` (N, L) holds on every mix (the codec runs once a round);
    it reaches the aggregation beside the mask, which composes it as the
    reference composes it into ``e``.
    """
    n, l, _ = w_seg.shape
    eps = link_eps[:n, :n]
    u = _uniform((n_mixes, n, n, l if seg_total is None else seg_total), u,
                 generator, w_seg.device)
    eye = torch.eye(n, dtype=torch.bool, device=w_seg.device)[:, :, None]
    tx = None if tx_mask is None else tx_mask[:n]
    if seg_total is not None and tx is not None:
        tx = errors.local_slice(tx, l, seg_start)
    w = w_seg
    for j in range(n_mixes):
        e = u[j] < eps[:, :, None]                  # packed bool mask
        if participation is not None:
            e = e & (participation[:n, None, None] > 0)
        e = e | eye                                  # own model present
        if seg_total is not None:
            e = errors.local_slice(e, l, seg_start)
        out = aggregation.apply_mode(mode_id, w, p, e, tx=tx, impl=agg_impl)
        if participation is not None:
            out = aggregation.keep_nonparticipants(participation[:n], out, w)
        w = out
    return w


def cfl_round_seg(
    w_seg: torch.Tensor,
    p: torch.Tensor,
    rho: torch.Tensor,
    mode_id: int,
    aggregator: int,
    participation: torch.Tensor | None = None,
    *,
    tx_mask: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    seg_total: int | None = None,
    seg_start: int = 0,
) -> torch.Tensor:
    """C-FL benchmark: star aggregation at ``aggregator`` via min-PER routes.

    Uplink: segment l of client m reaches the aggregator w.p. rho[m, a].
    Downlink: the global segment reaches client n w.p. rho[a, n]; on
    failure the client keeps its own segment.  ``u``: optional (2, N, L)
    uniforms, the uplink draw then the downlink draw.  The aggregator's own
    participation entry is ignored (the star center always takes part).
    The codec's ``tx_mask`` (N, L) prunes the uplink (before the
    aggregator's own row is restored) and, through the aggregator's row,
    the downlink broadcast.
    """
    n, l, _ = w_seg.shape
    u = _uniform((2, n, l if seg_total is None else seg_total), u, generator,
                 w_seg.device)
    if participation is not None:
        star = torch.zeros(n, dtype=torch.float32, device=w_seg.device)
        star[aggregator] = 1.0
        participation = torch.maximum(participation[:n], star)

    tx_f = None if tx_mask is None else (tx_mask[:n] > 0).to(torch.float32)

    rho_up = rho[:n, aggregator]                                # (N,)
    e_up = (u[0] < rho_up[:, None]).to(torch.float32)
    if tx_f is not None:
        e_up = e_up * tx_f
    e_up[aggregator] = 1.0
    if participation is not None:
        e_up = e_up * participation[:, None]
    if seg_total is not None:
        e_up = errors.local_slice(e_up, l, seg_start)
    if mode_id == 0:
        wts = p[:, None] * e_up
        denom = torch.clamp(wts.sum(dim=0), min=1e-12)          # (L,)
        g = torch.einsum("ml,mlk->lk", wts, w_seg) / denom[:, None]
    else:  # the aggregator substitutes its own segments
        recv = torch.einsum("ml,mlk->lk", p[:, None] * e_up, w_seg)
        miss = (p[:, None] * (1.0 - e_up)).sum(dim=0)
        g = recv + miss[:, None] * w_seg[aggregator]

    rho_dn = rho[aggregator, :n]                                # (N,)
    e_dn = (u[1] < rho_dn[:, None]).to(torch.float32)
    if tx_f is not None:
        e_dn = e_dn * tx_f[aggregator][None, :]
    e_dn[aggregator] = 1.0
    if participation is not None:
        e_dn = e_dn * participation[:, None]
    if seg_total is not None:
        e_dn = errors.local_slice(e_dn, l, seg_start)
    return e_dn[:, :, None] * g[None] + (1.0 - e_dn)[:, :, None] * w_seg


def ideal_round_seg(w_seg: torch.Tensor, p: torch.Tensor,
                    participation: torch.Tensor | None = None) -> torch.Tensor:
    """Error-free C-FL (the paper's ideal reference in Fig. 9)."""
    return aggregation.ideal(w_seg, p, participation=participation)


def dispatch_round_seg(
    w_seg: torch.Tensor,
    p: torch.Tensor,
    rho: torch.Tensor,
    link_eps: torch.Tensor,
    protocol_id: int,
    mode_id: int,
    aggregator: int,
    *,
    n_mixes: int = 1,
    participation: torch.Tensor | None = None,
    tx_mask: torch.Tensor | None = None,
    w_raw: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    agg_impl: str = "auto",
    track_bias: bool = True,
    seg_total: int | None = None,
    seg_start: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exchange round of protocol ``protocol_id`` (`PROTOCOL_IDS`).

    Returns (new_w_seg, e, bias): ``e`` is the sampled (N, N, L) R&A
    success mask (packed bool; all-ones for the other protocols) and
    ``bias`` the mean ||Lambda_l||_F^2 diagnostic (NaN where undefined or
    with ``track_bias=False``, 0 for ideal C-FL), as a 0-d float32 tensor.
    ``u`` carries the protocol's uniforms: (N, N, L) for R&A, (J, N, N, L)
    for AaYG, (2, N, L) for C-FL; ideal C-FL and "none" draw nothing.

    The codec: ``tx_mask`` ((N, S) bool, full width) composes into every
    lossy protocol's channel (R&A and AaYG masks, C-FL up- and downlink);
    ``w_raw`` (the unencoded segments) is what ideal C-FL and "none" use,
    since they put nothing on the air.  None keeps the codec-free round.

    ``seg_total`` / ``seg_start`` run the round on a model shard's window
    (see the module docstring): ``w_seg`` (and ``w_raw``) are the local
    window, ``u`` and ``tx_mask`` full width, and ``e`` comes back at the
    full (N, N, S).
    """
    n, l, _ = w_seg.shape
    dev = w_seg.device
    w_keep = w_seg if w_raw is None else w_raw
    e_ones = torch.ones((n, n, l if seg_total is None else seg_total),
                        dtype=torch.bool, device=dev)
    shard = dict(seg_total=seg_total, seg_start=seg_start)
    nan = torch.full((), math.nan, dtype=torch.float32, device=dev)
    if protocol_id == PROTOCOL_IDS["ra"]:
        out, e = ra_round_seg(w_seg, p, rho, mode_id, participation,
                              tx_mask=tx_mask, u=u, generator=generator,
                              agg_impl=agg_impl, **shard)
        bias = (aggregation.bias_sq_norm_fused(p, e).mean()
                if track_bias else nan)
        return out, e, bias
    if protocol_id == PROTOCOL_IDS["aayg"]:
        out = aayg_round_seg(w_seg, p, link_eps, mode_id, n_mixes=n_mixes,
                             participation=participation, tx_mask=tx_mask,
                             u=u, generator=generator, agg_impl=agg_impl,
                             **shard)
        return out, e_ones, nan
    if protocol_id == PROTOCOL_IDS["cfl"]:
        out = cfl_round_seg(w_seg, p, rho, mode_id, aggregator,
                            participation, tx_mask=tx_mask, u=u,
                            generator=generator, **shard)
        return out, e_ones, nan
    if protocol_id == PROTOCOL_IDS["ideal_cfl"]:
        out = ideal_round_seg(w_keep, p, participation)
        return out, e_ones, torch.zeros((), dtype=torch.float32, device=dev)
    if protocol_id == PROTOCOL_IDS["none"]:
        return w_keep, e_ones, nan
    raise ValueError(f"unknown protocol id {protocol_id}: choose from "
                     f"{PROTOCOL_IDS}")


# ---------------------------------------------------------------------------
# Pytree-level wrappers (static string API).
# ---------------------------------------------------------------------------
def ra_round(
    stacked: dict,
    p: torch.Tensor,
    rho: torch.Tensor,
    *,
    seg_len: int,
    mode: str = "ra_normalized",
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    agg_impl: str = "auto",
) -> tuple[dict, torch.Tensor]:
    """R&A D-FL local aggregation round.  Returns (new_stacked, e), ``e``
    the (N, N, L) success mask sampled (``u``: its uniforms)."""
    w_seg, spec, m_params = _to_segments(stacked, seg_len)
    out, e = ra_round_seg(w_seg, p, rho, MODE_IDS[mode], u=u,
                          generator=generator, agg_impl=agg_impl)
    return _from_segments(out, spec, m_params), e


def aayg_round(
    stacked: dict,
    p: torch.Tensor,
    link_eps: torch.Tensor,
    *,
    seg_len: int,
    mode: str = "ra_normalized",
    n_mixes: int = 1,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    agg_impl: str = "auto",
) -> dict:
    """Aggregate-as-You-Go gossip round (see `aayg_round_seg`)."""
    w_seg, spec, m_params = _to_segments(stacked, seg_len)
    out = aayg_round_seg(w_seg, p, link_eps, MODE_IDS[mode], n_mixes=n_mixes,
                         u=u, generator=generator, agg_impl=agg_impl)
    return _from_segments(out, spec, m_params)


def cfl_round(
    stacked: dict,
    p: torch.Tensor,
    rho: torch.Tensor,
    *,
    seg_len: int,
    mode: str = "ra_normalized",
    aggregator: int = 6,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> dict:
    """C-FL benchmark round (see `cfl_round_seg`)."""
    w_seg, spec, m_params = _to_segments(stacked, seg_len)
    out = cfl_round_seg(w_seg, p, rho, MODE_IDS[mode], aggregator, u=u,
                        generator=generator)
    return _from_segments(out, spec, m_params)


def ideal_cfl_round(stacked: dict, p: torch.Tensor, *, seg_len: int) -> dict:
    """Error-free C-FL (the paper's ideal reference in Fig. 9)."""
    w_seg, spec, m_params = _to_segments(stacked, seg_len)
    return _from_segments(ideal_round_seg(w_seg, p), spec, m_params)
