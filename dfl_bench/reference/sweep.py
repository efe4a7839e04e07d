"""Reference rounds of one D-FL scenario (paper Sec. V; mirrors the round
of `src/repro_torch/fl/simulator.py` without importing it).

Each round:
  1. the protocol's uniforms are drawn from the scenario's generator, a
     ``torch.Generator`` on the run's device seeded with the scenario seed
     (R&A (N, N, L), AaYG (J, N, N, L), C-FL (2, N, L); nothing else
     draws from it);
  2. every client takes ``epochs`` full-batch gradient steps of
     ``w <- w - lr * grad`` on the mean cross-entropy of its shard, each
     shard tiled to the largest shard's size (full-batch GD over equal
     shapes, as the port pads them);
  3. the trained models, flattened in leaf order and cut into L segments of
     K values, are exchanged (`exchange.exchange`);
  4. each client's test accuracy and the loss on its tiled shard are read.

Clients are trained one after another, each as one plain autograd graph.
"""
from __future__ import annotations

import dataclasses

import torch

from . import exchange


@dataclasses.dataclass
class Shards:
    """Every client's shard tiled to the largest size, and the test set,
    on the run's device."""

    xs: list[torch.Tensor]
    ys: list[torch.Tensor]
    test_x: torch.Tensor
    test_y: torch.Tensor
    p: torch.Tensor              # (N,) float32, shard sizes over their sum


def tile_shards(train_x, train_y, test_x, test_y) -> Shards:
    """Tile each shard (repeat it whole, then cut) to the largest size."""
    size = max(len(x) for x in train_x)

    def tile(t):
        reps = -(-size // len(t))
        return t.repeat((reps,) + (1,) * (t.ndim - 1))[:size]

    counts = torch.tensor([len(x) for x in train_x], dtype=torch.float64)
    return Shards([tile(x) for x in train_x], [tile(y) for y in train_y],
                  test_x, test_y,
                  (counts / counts.sum()).to(torch.float32).to(
                      test_x.device))


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over every position."""
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def _views(flat: torch.Tensor, names, shapes) -> dict:
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    parts = torch.split(flat[:sum(sizes)], sizes)
    return {n: t.reshape(s) for n, t, s in zip(names, parts, shapes)}


def run_scenario(model, weights: dict, shards: Shards, link_eps: torch.Tensor,
                 *, seed: int, protocol: str, mode: str, aggregator: int,
                 lr: float, epochs: int, rounds: int, seg_len: int,
                 mixes: int) -> dict[str, torch.Tensor]:
    """acc and loss, each (rounds, N) on the CPU, of one scenario started
    from ``weights`` (one client's leaves, in leaf order)."""
    dev = shards.test_x.device
    n = len(shards.xs)
    names = list(weights)
    shapes = [tuple(t.shape) for t in weights.values()]
    flat0 = torch.cat([t.reshape(-1) for t in weights.values()])
    m = flat0.numel()
    segs = -(-m // seg_len)
    w = torch.nn.functional.pad(flat0, (0, segs * seg_len - m))
    w = w.reshape(1, segs, seg_len).repeat(n, 1, 1).to(dev)
    rho = exchange.route(link_eps).to(dev)
    eps = link_eps.to(dev, torch.float32)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    shape = exchange.draw_shape(protocol, n, segs, mixes)
    accs, losses = [], []
    for _ in range(rounds):
        u = (None if shape is None
             else torch.rand(shape, generator=gen, device=dev))
        # Each trained row goes straight into one buffer (its padding
        # zero), and the round's start rows are freed before the exchange:
        # the sweep holds at most three copies of the clients' rows at once
        # (the start rows, the buffer and one row in training; then the
        # buffer and the exchange's result, beside what `exchange` makes
        # for itself: one more copy for AaYG's mixes, two for C-FL's
        # star).
        trained = torch.zeros((n, segs * seg_len), dtype=w.dtype, device=dev)
        for c in range(n):
            row = w[c].reshape(-1)[:m]
            for _ in range(epochs):
                row = row.detach().requires_grad_(True)
                loss = ce_loss(model.forward(_views(row, names, shapes),
                                             shards.xs[c]), shards.ys[c])
                (grad,) = torch.autograd.grad(loss, row)
                row = row.detach() - lr * grad
            trained[c, :m] = row
        del row, w
        w = exchange.exchange(trained.reshape(n, segs, seg_len), shards.p,
                              rho, eps, protocol, mode, aggregator, u)
        del trained
        acc, loss = [], []
        with torch.no_grad():
            for c in range(n):
                params = _views(w[c].reshape(-1), names, shapes)
                pred = model.forward(params, shards.test_x).argmax(dim=-1)
                acc.append((pred == shards.test_y).to(torch.float32).mean())
                loss.append(ce_loss(model.forward(params, shards.xs[c]),
                                    shards.ys[c]))
        accs.append(torch.stack(acc))
        losses.append(torch.stack(loss))
    return {"acc": torch.stack(accs).cpu(), "loss": torch.stack(losses).cpu()}
