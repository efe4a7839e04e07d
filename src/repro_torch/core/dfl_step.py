"""The production R&A D-FL step: the paper's protocol over the ranks of a
`torch.distributed` process group.

Port of the reference package's `core/dfl_step.py`.  D-FL clients are the
ranks of a group (client i = group rank i).  Each trains its own replica
for I local steps, then the R&A exchange runs as collectives:

  * the segment success mask e_{m,n,l} is drawn from uniforms every rank
    holds alike (given as ``u``, or drawn from a generator seeded alike on
    every rank), so every client builds the same (N, N, L) mask and no
    mask is communicated;
  * the routed unicast becomes an all-to-all of destination-weighted
    segments (client m sends p_m e_{m,n,l} w_m(l) to destination n),
    followed by the sum over senders and the adaptive renormalization of
    eq. (6); or a reduce-scatter of the same contributions; or an
    all-reduce of them of which each client keeps its own row.

The arithmetic is the reference's plain math: no kernel runs here (the
reference reaches no Pallas kernel in this module either).  The
collectives are `launch.mesh`'s, which count their bytes.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..launch import mesh as launch_mesh
from . import aggregation, errors, selection

Params = dict[str, torch.Tensor]

COMMS = ("all_to_all", "reduce_scatter", "psum")


def _flatten(params: Params) -> tuple[torch.Tensor, list]:
    """One float32 vector of every leaf, keys sorted and leaves row-major
    (`jax.flatten_util.ravel_pytree`'s order for a flat dict); returns it
    and the (name, shape, dtype) spec that `_unflatten` undoes."""
    names = sorted(params)
    flat = torch.cat([params[k].reshape(-1).to(torch.float32) for k in names])
    return flat, [(k, tuple(params[k].shape), params[k].dtype) for k in names]


def _unflatten(flat: torch.Tensor, spec: list, order: list) -> Params:
    sizes = [math.prod(shape) for _, shape, _ in spec]
    parts = dict(zip((k for k, _, _ in spec), torch.split(flat, sizes)))
    shapes = {k: (shape, dtype) for k, shape, dtype in spec}
    return {k: parts[k].reshape(shapes[k][0]).to(shapes[k][1])
            for k in order}


def ra_exchange(
    params: Params,
    p: torch.Tensor,
    rho: torch.Tensor,
    *,
    group=None,
    seg_len: int,
    comm: str = "all_to_all",
    participation: torch.Tensor | None = None,
    u: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
) -> Params:
    """R&A aggregation across the ranks of ``group``; every rank calls it.

    Args:
      params: this client's parameters (the same names and shapes on every
        rank, different values).
      p: (N,) aggregation weights, N the group size (the same on every
        rank).
      rho: (N, N) or (V, V) E2E packet success rates (the client block is
        used).
      group: the process group whose ranks are the clients (None: the
        default group).
      seg_len: K values per segment.
      comm: ``"all_to_all"`` (the routed unicast's analogue),
        ``"reduce_scatter"`` or ``"psum"`` (an all-reduce).
      participation: optional (N,) sampling mask, the same on every rank:
        sampled-out clients leave the mask as senders
        (`aggregation.mask_senders`) and keep their own parameters, bit
        for bit, as receivers.
      u: the (N, N, L) uniforms of the success mask, the same on every
        rank; without them they are drawn from ``generator`` (seeded alike
        on every rank) on ``params``' device.

    Returns:
      This client's aggregated parameters, each leaf in its own dtype.
    """
    if comm not in COMMS:
        raise ValueError(f"unknown comm mode {comm!r}: choose from {COMMS}")
    n = p.shape[0]
    if dist.get_world_size(group) != n:
        raise ValueError(f"p holds {n} clients but the group has "
                         f"{dist.get_world_size(group)} ranks")
    me = dist.get_rank(group)

    flat, spec = _flatten(params)
    m_params = flat.shape[0]
    l = errors.num_segments(m_params, seg_len)
    seg = torch.nn.functional.pad(flat, (0, l * seg_len - m_params)).reshape(
        l, seg_len)                                               # (L, K)

    # The shared mask: every client builds the same (N, N, L) tensor.
    if u is None:
        u = torch.rand((n, n, l), generator=generator, device=flat.device)
    e = errors.sample_success(rho.to(flat.device), l, n_clients=n,
                              u=u.to(flat.device))
    if participation is not None:
        e = aggregation.mask_senders(e, participation[:n])
    e = e.to(torch.float32)
    p = p.to(device=flat.device, dtype=torch.float32)

    # Destination-weighted copies: contrib[d] = p_me * e[me, d, :] * seg.
    contrib = p[me] * e[me][:, :, None] * seg[None]               # (N, L, K)
    if comm == "all_to_all":
        # received[m] = p_m e[m, me, :] * seg_m
        num = launch_mesh.all_to_all(contrib, group).sum(dim=0)
    elif comm == "reduce_scatter":
        num = launch_mesh.reduce_scatter(contrib, group)[0]
    else:
        num = launch_mesh.all_reduce(contrib, group)[me]

    # The denominator needs no communication (shared mask).
    denom = torch.clamp(torch.einsum("m,ml->l", p, e[:, me]), min=1e-12)
    out = (num / denom[:, None]).reshape(-1)[:m_params]
    if participation is not None and not participation[me] > 0:
        out = flat                          # sampled out: keep own params
    return _unflatten(out, spec, list(params))


def _stack_metrics(steps: list) -> dict:
    """Per-step metric dicts stacked along a new leading axis (the
    reference's scan output)."""
    return {k: torch.stack([torch.as_tensor(m[k]) for m in steps])
            for k in steps[0]}


def make_dfl_train_step(
    local_train_step: Callable[..., tuple[dict, Any]],
    *,
    group=None,
    p: torch.Tensor,
    seg_len: int,
    n_local_steps: int = 1,
    comm: str = "all_to_all",
    selection_policy: str | None = None,
    select_frac: float = 0.5,
    signal_fn: Callable[[Any], torch.Tensor] | None = None,
):
    """Wrap a train step into one full R&A D-FL round.

    ``local_train_step(state, batch) -> (state, metrics)`` runs on this
    rank's shard; ``state`` is a dict with a ``"params"`` entry.  The
    returned ``dfl_round(state, batches, rho, *, u=None, generator=None)``
    runs ``n_local_steps`` local steps (step i takes ``batches[i]``, or
    None when ``batches`` is None), then `ra_exchange` of the parameters,
    and returns (state, metrics stacked over the steps).

    Closed-loop selection: with ``selection_policy`` (a
    `core.selection.POLICY_IDS` name) each round gathers every client's
    two scalars — its loss signal (``signal_fn(metrics)``, default the
    mean of ``metrics["loss"]``) and its true local update norm (the
    parameters before vs after the local steps) — in one all-gather into
    (N, 2), and every rank computes the same participation mask with
    `selection.select_clients`, which the exchange then takes.
    """
    policy_id = (None if selection_policy is None
                 else selection.POLICY_IDS[selection_policy])
    if signal_fn is None:
        def signal_fn(metrics):
            return torch.mean(torch.as_tensor(metrics["loss"],
                                              dtype=torch.float32))

    def dfl_round(state: dict, batches, rho: torch.Tensor, *,
                  u: torch.Tensor | None = None,
                  generator: torch.Generator | None = None):
        params_before = state["params"]
        steps = []
        for i in range(n_local_steps):
            state, metrics = local_train_step(
                state, None if batches is None else batches[i])
            steps.append(metrics)
        metrics = _stack_metrics(steps)
        part = None
        if policy_id is not None:
            n = p.shape[0]
            dev = state["params"][next(iter(state["params"]))].device
            loss_sig = torch.as_tensor(signal_fn(metrics),
                                       dtype=torch.float32).to(dev)
            upd_sq = sum(torch.sum(torch.square(
                state["params"][k] - params_before[k])).to(torch.float32)
                for k in sorted(state["params"]))
            sig = torch.stack([loss_sig.reshape(()),
                               torch.sqrt(upd_sq).reshape(())])
            sig_vec = launch_mesh.all_gather(sig[None], group)     # (N, 2)
            signals = selection.SelectionSignals(loss=sig_vec[:, 0],
                                                 upd_norm=sig_vec[:, 1])
            pp = p.to(device=dev, dtype=torch.float32)
            part = selection.select_clients(
                policy_id, torch.ones(n, dtype=torch.float32, device=dev),
                signals, pp, rho[:n, :n].to(dev), select_frac)
        new_params = ra_exchange(
            state["params"], p, rho, group=group, seg_len=seg_len,
            comm=comm, participation=part, u=u, generator=generator)
        state = dict(state, params=new_params)
        return state, metrics

    return dfl_round
