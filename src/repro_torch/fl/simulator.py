"""D-FL training simulator: N clients, local epochs, protocol exchange.

Port of the one-device round loop of the reference package's
`fl/simulator.py` (paper Sec. V): every round each client trains I
full-batch GD epochs on its local shard (batched over clients with
`torch.func.vmap` of `torch.func.grad`), then models are exchanged and
locally aggregated under the selected protocol (R&A / AaYG / C-FL / ideal
C-FL) and aggregation mechanism (adaptive normalization / substitution).

State is segment-native, as in the reference: client-stacked segment rows
``(N, S, seg_len)``; local training differentiates the loss through views
of a row as the model's parameters (reshape/split/slice), so the codec
padding past the last parameter gets zero gradient.

The loop is a Python loop over rounds (the reference scans).  Each
`Scenario` is one static network (rank-2 ``link_eps``).  Random draws come
from a ``torch.Generator`` on the run's device seeded with the scenario
seed; model init draws from a CPU generator with the same seed, so a model
starts from the same weights on every device.  `SimPrograms.round_step`
also takes a round's uniforms explicitly, which is how the parity tests
replay the reference's key chain.

Entry points `build_sim` and `run` run on the CUDA card unless the caller
passes ``device="cpu"``.  On CUDA, TF32 is off for matmuls and cuDNN
convolutions (`repro_torch.resolve_device`): the reference computes in
float32.

Public API
----------
  SimConfig                 static + default per-scenario knobs
  Scenario / make_scenario  one static grid point
  build_sim(...)            bind (init, apply, data, statics) -> SimPrograms
  SimPrograms.round_step    (state, scenario, u=) -> (state, metrics)
  SimPrograms.run_scenario  scenario -> metrics dict (n_rounds)
  run                       scalar one-scenario entry point -> SimResult
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..core import aggregation, errors, protocols, routing, topology
from ..data.synthetic import FederatedDataset
from ..models.smallnets import accuracy, ce_loss


class PacketLengthMismatchWarning(UserWarning):
    """The codec's segment size and the network's PER packet length differ."""


@dataclasses.dataclass
class SimConfig:
    """Simulation knobs.

    Static fields (seg_len, local_epochs, n_rounds, aayg_mixes) shape the
    loop; the rest are per-scenario defaults that `make_scenario` lifts
    into a `Scenario`.
    """

    protocol: str = "ra"          # ra | aayg | cfl | ideal_cfl | none
    mode: str = "ra_normalized"   # ra_normalized | substitution
    seg_len: int = 1024           # K float32 values per segment (32*K bits)
    local_epochs: int = 5         # I
    lr: float = 0.05
    n_rounds: int = 50
    aayg_mixes: int = 1           # J
    cfl_aggregator: int = 6       # paper: node 7 (index 6)
    seed: int = 0
    agg_impl: str = "auto"        # auto | torch | kernel (aggregation substrate)
    eval_every: int = 1           # evaluate acc/loss every k-th round
    track_bias: bool = True       # False: skip the R&A bias diagnostic

    @property
    def packet_len_bits(self) -> int:
        """Bits per transmitted packet implied by ``seg_len`` (32 * K).

        The paper's own defaults disagree (25,000-bit PER packets against
        32,768-bit segments); `check_packet_consistency` warns about it.
        """
        return errors.packet_len_bits(self.seg_len)


class Scenario(NamedTuple):
    """One static grid point.

    ``link_eps`` is the (V, V) per-link packet success matrix; ``rho`` the
    derived min-E2E-PER success matrix (None until `prepare`).
    """

    link_eps: torch.Tensor        # (V, V) float32
    seed: int
    protocol_id: int              # protocols.PROTOCOL_IDS
    mode_id: int                  # protocols.MODE_IDS
    aggregator: int               # C-FL star center
    lr: float                     # local GD step size
    rho: torch.Tensor | None = None

    def prepare(self) -> "Scenario":
        """Fill the derived min-E2E-PER success matrix (idempotent)."""
        if self.rho is not None:
            return self
        rho, _ = routing.e2e_success(self.link_eps)
        return self._replace(rho=rho)

    def to(self, device: torch.device) -> "Scenario":
        return self._replace(
            link_eps=self.link_eps.to(device),
            rho=None if self.rho is None else self.rho.to(device))


# One-time-warned (packet_len_bits, seg_len, bits_per_value) triples.
_WARNED_PACKET_PAIRS: set[tuple[int, ...]] = set()


def validate_eval_schedule(n_rounds: int, eval_every: int) -> None:
    """Raise unless ``eval_every`` divides ``n_rounds``."""
    if eval_every < 1 or n_rounds % eval_every:
        raise ValueError(
            f"eval_every={eval_every} must be >= 1 and divide "
            f"n_rounds={n_rounds} (metrics keep a static shape); the "
            f"nearest valid values are the divisors of {n_rounds}"
        )


def check_packet_len(recorded_bits: int | None, seg_len: int,
                     *, bits_per_value: int = errors.FLOAT_BITS) -> bool:
    """Validate the codec segment size against a recorded PER packet length.

    Returns True when ``bits_per_value * seg_len`` equals the recorded
    packet length (or none was recorded); otherwise warns once per distinct
    triple.
    """
    if recorded_bits is None:
        return True
    implied = errors.packet_len_bits(seg_len, bits_per_value)
    if int(recorded_bits) == implied:
        return True
    msg = (
        f"network PER model uses {int(recorded_bits)}-bit packets but "
        f"seg_len={seg_len} transmits {implied}-bit "
        f"({bits_per_value}-bit-value) segments; pass "
        "packet_len_bits=cfg.packet_len_bits to the network builder "
        "for a self-consistent channel (the paper's own defaults "
        "carry this mismatch)"
    )
    key = (int(recorded_bits), int(seg_len), int(bits_per_value))
    if key not in _WARNED_PACKET_PAIRS:
        _WARNED_PACKET_PAIRS.add(key)
        warnings.warn(msg, PacketLengthMismatchWarning, stacklevel=3)
    return False


def check_packet_consistency(net: topology.Network, seg_len: int,
                             bits_per_value: int = errors.FLOAT_BITS) -> bool:
    """`check_packet_len` against a network's recorded packet length."""
    return check_packet_len(getattr(net, "packet_len_bits", None), seg_len,
                            bits_per_value=bits_per_value)


def make_scenario(net: topology.Network, cfg: SimConfig) -> Scenario:
    """Lift a (Network, SimConfig) pair into a Scenario."""
    if cfg.protocol not in protocols.PROTOCOL_IDS:
        raise ValueError(f"unknown protocol {cfg.protocol!r}: choose from "
                         f"{sorted(protocols.PROTOCOL_IDS)}")
    if cfg.mode not in protocols.MODE_IDS:
        raise ValueError(f"unknown mode {cfg.mode!r}: choose from "
                         f"{sorted(protocols.MODE_IDS)}")
    check_packet_consistency(net, cfg.seg_len)
    return Scenario(
        link_eps=torch.as_tensor(net.link_eps, dtype=torch.float32),
        seed=int(cfg.seed),
        protocol_id=protocols.PROTOCOL_IDS[cfg.protocol],
        mode_id=protocols.MODE_IDS[cfg.mode],
        aggregator=int(cfg.cfl_aggregator),
        lr=float(cfg.lr),
    )


@dataclasses.dataclass
class SimResult:
    acc_per_client: np.ndarray    # (rounds, N) test accuracy
    loss_per_client: np.ndarray   # (rounds, N) train loss
    bias_norms: np.ndarray        # (rounds,) mean ||Lambda_l||_F^2 (ra only)

    @property
    def mean_acc(self) -> np.ndarray:
        return self.acc_per_client.mean(axis=1)


def _pad_shards(data: FederatedDataset) -> tuple[np.ndarray, np.ndarray]:
    """Pad client shards to a common size by tiling (full-batch GD)."""
    max_sz = max(len(x) for x in data.train_x)

    def pad(x):
        reps = -(-max_sz // len(x))
        return np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:max_sz]

    return (np.stack([pad(x) for x in data.train_x]),
            np.stack([pad(y) for y in data.train_y]))


@dataclasses.dataclass(frozen=True)
class SimPrograms:
    """The round loop bound to one (init, apply, data, statics) binding.

    ``round_step(state, scenario, *, u=None, generator=None)`` advances one
    round on pytree-like state ``{"params": client-stacked dict}`` and
    evaluates it; ``u`` carries the round's uniforms (see
    `protocols.dispatch_round_seg`).  ``init_scan(scenario)`` builds the
    segment-native state ``{"w": (N, S, K) rows, "gen": Generator}`` and
    ``advance_chunk(state, scenario)`` advances one chunk (``eval_every``
    rounds, one metrics row); ``run_scenario`` loops it.
    """

    round_step: Callable
    run_scenario: Callable[[Scenario], dict]
    init_scan: Callable[[Scenario], dict]
    advance_chunk: Callable
    n_clients: int
    n_rounds: int
    n_chunks: int
    eval_every: int
    n_segments: int       # S: segment count of the bound model
    seg_len: int
    device: torch.device


def build_sim(
    init_fn: Callable[[torch.Generator], dict],
    apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    data: FederatedDataset,
    *,
    seg_len: int,
    local_epochs: int,
    n_rounds: int,
    aayg_mixes: int = 1,
    agg_impl: str = "auto",
    eval_every: int = 1,
    track_bias: bool = True,
    device: str | torch.device | None = None,
) -> SimPrograms:
    """Bind data + statics into the round loop on ``device``.

    Args:
      init_fn: model init, ``CPU generator -> params`` (flat dict in the
        reference's leaf order); every client starts from the same init.
      apply_fn: forward pass, ``(params, x) -> logits``.
      data: federated dataset; client shards are padded to a common size by
        tiling (full-batch GD per the paper).
      seg_len: K values per packet segment.
      local_epochs: I full-batch GD epochs per round.
      n_rounds: rounds in `run_scenario`.
      aayg_mixes: J one-hop mix iterations for AaYG.
      agg_impl: aggregation substrate (auto | torch | kernel; see
        `core.aggregation.apply_mode`).
      eval_every: evaluate test accuracy / train loss only every k-th round
        (must divide ``n_rounds``); ``bias`` stays per-round.
      track_bias: False skips the R&A ||Lambda||^2 diagnostic (NaN).
      device: where the loop runs; default the CUDA card (raises without
        one).  Pass ``"cpu"`` for the plain path.
    """
    dev = resolve_device(device)
    validate_eval_schedule(n_rounds, eval_every)
    if agg_impl not in aggregation.IMPLS:
        raise ValueError(f"agg_impl must be one of {aggregation.IMPLS}, got "
                         f"{agg_impl!r}")

    n = data.n_clients
    p = torch.tensor(data.weights(), dtype=torch.float32, device=dev)
    xs_np, ys_np = _pad_shards(data)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    test_x = torch.from_numpy(np.asarray(data.test_x)).to(dev)
    test_y = torch.from_numpy(np.asarray(data.test_y)).to(dev)

    # Static segment layout: every parameter view below is pure layout.
    params_like = init_fn(torch.Generator().manual_seed(0))
    names = list(params_like)
    shapes = [tuple(t.shape) for t in params_like.values()]
    sizes = [int(t.numel()) for t in params_like.values()]
    m_params = sum(sizes)
    s_total = errors.num_segments(m_params, seg_len)

    def _leaf_views(row: torch.Tensor) -> dict:
        """One client's params as layout views of its (S, K) row."""
        parts = torch.split(row.reshape(-1)[:m_params], sizes)
        return {nm: pt.reshape(sh) for nm, pt, sh in zip(names, parts, shapes)}

    def _row_loss(row, x, y):
        return ce_loss(apply_fn(_leaf_views(row), x), y)

    _batched_grad = torch.func.vmap(torch.func.grad(_row_loss))
    _batched_loss = torch.func.vmap(_row_loss)

    def _row_acc(row):
        return accuracy(apply_fn(_leaf_views(row), test_x), test_y)

    _batched_acc = torch.func.vmap(_row_acc)

    def local_train(rows: torch.Tensor, lr: float) -> torch.Tensor:
        """``local_epochs`` full-batch GD steps per client (paper eq. 3)."""
        for _ in range(local_epochs):
            rows = rows - lr * _batched_grad(rows, xs, ys)
        return rows

    def _init_rows(seed: int) -> torch.Tensor:
        params0 = init_fn(torch.Generator().manual_seed(seed))
        stacked = {k: v.to(dev)[None].expand((n,) + tuple(v.shape))
                   for k, v in params0.items()}
        return protocols._to_segments(stacked, seg_len)[0].contiguous()

    def _round_core(w: torch.Tensor, scenario: Scenario, u, generator):
        """Train -> exchange: returns (new rows, bias)."""
        trained = local_train(w, scenario.lr)
        new, _e, bias = protocols.dispatch_round_seg(
            trained, p, scenario.rho, scenario.link_eps,
            scenario.protocol_id, scenario.mode_id, scenario.aggregator,
            n_mixes=aayg_mixes, u=u, generator=generator,
            agg_impl=agg_impl, track_bias=track_bias,
        )
        return new, bias

    def _metrics(rows: torch.Tensor) -> dict:
        return {"acc": _batched_acc(rows), "loss": _batched_loss(rows, xs, ys)}

    @torch.no_grad()
    def round_step(state: dict, scenario: Scenario, *, u=None,
                   generator: torch.Generator | None = None):
        """One D-FL round: local training + protocol exchange + metrics.

        state: {"params": client-stacked dict (leaves (N, ...))}.  ``u``:
        this round's uniforms for the protocol (else drawn from
        ``generator``).
        """
        scenario = scenario.prepare().to(dev)
        stacked = {k: v.to(dev) for k, v in state["params"].items()}
        w_seg, spec, mp = protocols._to_segments(stacked, seg_len)
        new, bias = _round_core(w_seg, scenario, u, generator)
        metrics = {**_metrics(new), "bias": bias}
        return {"params": protocols._from_segments(new, spec, mp)}, metrics

    n_chunks = n_rounds // eval_every

    def init_scan(scenario: Scenario) -> dict:
        """The segment-native state at round 0 (before training)."""
        gen = torch.Generator(device=dev).manual_seed(int(scenario.seed))
        return {"w": _init_rows(int(scenario.seed)), "gen": gen}

    @torch.no_grad()
    def advance_chunk(state: dict, scenario: Scenario):
        """Advance ``eval_every`` rounds, drawing from the state's
        generator; returns (state, metrics row) with per-round ``bias`` and
        chunk-end ``acc`` / ``loss``."""
        scenario = scenario.prepare().to(dev)
        w, biases = state["w"], []
        for _ in range(eval_every):
            w, bias = _round_core(w, scenario, None, state["gen"])
            biases.append(bias)
        return ({"w": w, "gen": state["gen"]},
                {**_metrics(w), "bias": torch.stack(biases)})

    def run_scenario(scenario: Scenario) -> dict:
        """Run ``n_rounds`` rounds; metrics as CPU tensors: acc / loss
        (n_chunks, N), bias (n_rounds,)."""
        scenario = scenario.prepare().to(dev)
        state = init_scan(scenario)
        accs, losses, biases = [], [], []
        for _ in range(n_chunks):
            state, m = advance_chunk(state, scenario)
            accs.append(m["acc"])
            losses.append(m["loss"])
            biases.append(m["bias"])
        return {"acc": torch.stack(accs).cpu(),
                "loss": torch.stack(losses).cpu(),
                "bias": torch.cat(biases).cpu()}

    return SimPrograms(
        round_step=round_step,
        run_scenario=run_scenario,
        init_scan=init_scan,
        advance_chunk=advance_chunk,
        n_clients=n,
        n_rounds=n_rounds,
        n_chunks=n_chunks,
        eval_every=eval_every,
        n_segments=s_total,
        seg_len=seg_len,
        device=dev,
    )


def metrics_to_result(metrics: dict) -> SimResult:
    return SimResult(
        acc_per_client=np.asarray(metrics["acc"]),
        loss_per_client=np.asarray(metrics["loss"]),
        bias_norms=np.asarray(metrics["bias"]),
    )


def run(
    init_fn: Callable[[torch.Generator], dict],
    apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    data: FederatedDataset,
    net: topology.Network,
    cfg: SimConfig,
    *,
    device: str | torch.device | None = None,
) -> SimResult:
    """Scalar entry point: one scenario on ``device`` (default: the card)."""
    sim = build_sim(
        init_fn, apply_fn, data,
        seg_len=cfg.seg_len, local_epochs=cfg.local_epochs,
        n_rounds=cfg.n_rounds, aayg_mixes=cfg.aayg_mixes,
        agg_impl=cfg.agg_impl, eval_every=cfg.eval_every,
        track_bias=cfg.track_bias, device=device,
    )
    return metrics_to_result(sim.run_scenario(make_scenario(net, cfg)))
