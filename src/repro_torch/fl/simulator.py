"""D-FL training simulator: N clients, local epochs, protocol exchange.

Port of the one-device round loop of the reference package's
`fl/simulator.py` (paper Sec. V): every round each client trains I
full-batch GD epochs on its local shard (an image model with convolutions
one client at a time over its own samples, any other batched over clients
with `torch.func.vmap` of `torch.func.grad`), then models are exchanged and
locally aggregated under the selected protocol (R&A / AaYG / C-FL / ideal
C-FL) and aggregation mechanism (adaptive normalization / substitution).

State is segment-native, as in the reference: client-stacked segment rows
``(N, S, seg_len)``; local training differentiates the loss through views
of a row as the model's parameters (reshape/split/slice), so the codec
padding past the last parameter gets zero gradient.

The loop is a Python loop over rounds (the reference scans).  A
`Scenario` is one network (rank-2 ``link_eps``) or a link schedule
(rank-3 (T, V, V) ``link_eps``; round t uses entry ``t % T``, each entry
routed once by `Scenario.prepare`).  A scenario may also carry, as in the
reference:

  * a ``participation`` mask (N,) or (T, N) (client sampling: sampled-out
    clients keep their parameters and take no part in any aggregation)
    and a per-client ``local_epochs`` vector (N,) (clipped to the static
    bound ``build_sim(local_epochs=)``);
  * a closed-loop sampling policy (``policy_id`` / ``select_frac``,
    `core.selection`): each round's mask is chosen from per-client
    signals carried in the loop's state;
  * an exchange codec (``codec_id`` / ``compress_ratio``,
    `core.compression`) between local training and delivery.

``build_sim(local_optimizer=)`` replaces plain GD by an `optim.optimizers`
rule, with fresh state every round.

Random draws come from a ``torch.Generator`` on the run's device seeded
with the scenario seed (in each round: the codec's uniforms under
``quant``, then the protocol's); model init draws from a CPU generator
with the same seed, so a model starts from the same weights on every
device.  `SimPrograms.round_step` and `SimPrograms.advance_chunk` also
take a round's uniforms explicitly (``u`` for the protocol, ``u_codec``
for the quantizer), which is how the parity tests replay the reference's
key chain.

A batch of G scenarios (`SimPrograms.prepare_batch`, then
`init_scan_batch` / `advance_chunk_batch` / `run_scenario_batch`; the
engine that builds such batches is `fl.scenarios`) runs the same round
under `torch.func.vmap` over the G scenarios.  Fields equal across the
batch are hoisted out of the vmap; the discrete ids (protocol, mode,
aggregator, codec, policy) must be, since the round branches on them in
Python.  No draw happens inside the vmap: each scenario draws its round's
uniforms from its own generator, seeded with its seed, in the order and
shapes of the scalar path (`_round_draws`), so row i of a batch uses the
numbers the scalar path uses for that scenario.  A round of the batch runs
one local-training pass over G * N clients and one K1 launch for R&A (J
for AaYG), whatever G is.

Model-axis sharding: ``build_sim(model_shards=Dm, mesh=)`` splits the
segment axis over the Dm ranks of this rank's model-sharding group (the
``model`` axis of a `launch.mesh.grid_model_mesh`).  The loop's state then
holds the local window (N, L_local, K), L_local = ceil(S / Dm), starting
at segment (model coordinate) * L_local.  Each round all-gathers the full
rows inside the group, trains them (every shard alike), encodes them,
and exchanges only the window (`protocols.dispatch_round_seg` with
``seg_total`` / ``seg_start``): draws are taken at the full width and
sliced, so every global segment is aggregated as the unsharded loop
aggregates it, and on the card each shard launches K1 on its window.
Metrics come from the gathered full rows, the same on every shard.  Every
rank of the group runs the same calls (SPMD).

Under a profiler the round's phases are named ranges
(`launch.tracker.span`): ``dfl:prepare`` (`prepare_batch`), ``dfl:init``,
``dfl:draws`` (a round's uniforms), ``dfl:local_train`` (each gradient
evaluation; the update is outside), ``dfl:exchange`` (the
`protocols.dispatch_round_seg` call), ``dfl:eval`` (test accuracy and
train loss) and ``dfl:fetch`` (the copy of the metrics to the host).
`SAMPLE_PASSES` counts local training's sample passes, padding included
(none for an image model with convolutions).

Entry points `build_sim` and `run` run on the CUDA card unless the caller
passes ``device="cpu"``.  On CUDA, TF32 is off for matmuls and cuDNN
convolutions (`repro_torch.resolve_device`): the reference computes in
float32.

Public API
----------
  SimConfig                 static + default per-scenario knobs
  Scenario / make_scenario  one grid point or a trajectory of them
  build_sim(...)            bind (init, apply, data, statics) -> SimPrograms
  Scenario.prepare()        route (each entry of a link schedule, once)
  Scenario.at_round(t)      per-round view of a dynamic scenario
  SimPrograms.round_step    (state, scenario, u=, u_codec=) -> (state, metrics)
  SimPrograms.advance_chunk (state, scenario, u=, u_codec=) -> (state, metrics)
  SimPrograms.run_scenario  scenario -> metrics dict (n_rounds)
  SimPrograms.full_rows / local_window
                            a model shard's window <-> the full rows
  SimPrograms.prepare_batch (batch, axes) -> ScenarioBatch (G scenarios)
  SimPrograms.{init_scan,advance_chunk,run_scenario}_batch
                            the same over a ScenarioBatch, (G, ...) metrics
  run                       scalar one-scenario entry point -> SimResult
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from .. import resolve_device, vmap_size
from ..core import (aggregation, compression, errors, protocols, routing,
                    selection, topology)
from ..data.synthetic import FederatedDataset
from ..kernels import count_launch
from ..launch import mesh as launch_mesh
from ..launch.tracker import span, spanned
from ..models.smallnets import (accuracy, ce_loss, channels_last_kernels,
                               weighted_ce_loss)
from ..optim import optimizers

# Default mesh axis name of model-axis (segment) sharding.
MODEL_AXIS = launch_mesh.MODEL_AXIS

# Local training's sample passes, counted on the host by the round loops
# (`kernels.count_launch`'s lock): ``computed``, the rows every gradient
# evaluation runs (under vmap(grad) each client's shard tiled to the
# largest, `_pad_shards`; an image model with convolutions its own
# samples), and ``own``, the clients' own samples among them.  The rest is
# padding.
SAMPLE_PASSES: dict[str, int] = {}


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
    codec: str | None = None      # None | none | topk | quant
    compress_ratio: float = 1.0   # codec intensity, (0, 1]
    local_optimizer: Any = None   # None | optimizers name | Optimizer | factory

    @property
    def packet_len_bits(self) -> int:
        """Bits per transmitted packet implied by ``seg_len`` (32 * K).

        The paper's own defaults disagree (25,000-bit PER packets against
        32,768-bit segments); `check_packet_consistency` warns about it.
        """
        return errors.packet_len_bits(self.seg_len)


class Scenario(NamedTuple):
    """One grid point, or a trajectory of them.

    ``link_eps`` is the (V, V) per-link packet success matrix, or a
    (T, V, V) schedule of them (round t uses entry ``t % T``); networks of
    fewer nodes may be padded with isolated nodes, which leaves the routed
    client block unchanged.  ``rho`` is the derived min-E2E-PER success
    matrix of matching rank (None until `prepare`).  ``participation`` is
    an optional (N,) or (T, N) client sampling mask; ``local_epochs`` an
    optional (N,) per-client epoch vector.  ``policy_id`` / ``select_frac``
    select a closed-loop sampling policy (`core.selection.POLICY_IDS`),
    with the ``participation`` schedule as the availability base;
    ``codec_id`` / ``compress_ratio`` an exchange codec
    (`core.compression.CODEC_IDS`).  Every optional field defaults to the
    static behaviour.
    """

    link_eps: torch.Tensor        # (V, V) / (T, V, V) float32
    seed: int
    protocol_id: int              # protocols.PROTOCOL_IDS
    mode_id: int                  # protocols.MODE_IDS
    aggregator: int               # C-FL star center
    lr: float                     # local GD step size
    rho: torch.Tensor | None = None
    participation: torch.Tensor | None = None   # (N,) / (T, N) float32
    local_epochs: torch.Tensor | None = None    # (N,) int32
    policy_id: int | None = None                # selection.POLICY_IDS
    select_frac: float | None = None            # participant fraction
    codec_id: int | None = None                 # compression.CODEC_IDS
    compress_ratio: float | None = None         # codec intensity, (0, 1]

    def prepare(self) -> "Scenario":
        """Fill the derived min-E2E-PER success matrix (idempotent).  A
        rank-3 schedule is routed entry by entry, once, here, outside the
        round loop."""
        if self.rho is not None:
            return self
        return self._replace(rho=route(self.link_eps))

    @property
    def is_dynamic(self) -> bool:
        """True if any trajectory axis is active (a link schedule, client
        sampling, or per-client local epochs)."""
        return (self.link_eps.ndim == 3 or self.participation is not None
                or self.local_epochs is not None)

    @property
    def is_closed_loop(self) -> bool:
        """True if a live sampling policy decides participation."""
        return self.policy_id is not None

    def at_round(self, t: int) -> "Scenario":
        """The static per-round view: a link schedule (and its ``rho``) and
        a (T, N) participation schedule are sliced at ``t`` modulo their
        own length; static fields pass through."""
        s = self
        if s.link_eps.ndim == 3:
            tt = t % s.link_eps.shape[0]
            s = s._replace(link_eps=s.link_eps[tt],
                           rho=None if s.rho is None else s.rho[tt])
        part = s.participation
        if part is not None and part.ndim == 2:
            s = s._replace(participation=part[t % part.shape[0]])
        return s

    def to(self, device: torch.device) -> "Scenario":
        def move(x):
            return None if x is None else x.to(device)

        return self._replace(
            link_eps=self.link_eps.to(device), rho=move(self.rho),
            participation=move(self.participation),
            local_epochs=move(self.local_epochs))


def route(link_eps: torch.Tensor) -> torch.Tensor:
    """The min-E2E-PER success matrix of a (V, V) link matrix, or of each
    entry of a (T, V, V) schedule (`routing.e2e_success`, one call per
    entry: a scenario batch routes each entry with the same call, so its
    rows match the scalar path's bit for bit)."""
    link_eps = torch.as_tensor(link_eps, dtype=torch.float32)
    if link_eps.ndim == 3:
        return torch.stack([routing.e2e_success(le)[0] for le in link_eps])
    return routing.e2e_success(link_eps)[0]


# The fields a scenario batch must hold one value of (the round branches on
# them in Python), and how every field is held for one scenario.
BATCH_IDS = ("protocol_id", "mode_id", "aggregator", "codec_id", "policy_id")
_INT_FIELDS = ("seed",) + BATCH_IDS
_FLOAT_FIELDS = ("lr", "select_frac", "compress_ratio")
_TENSOR_DTYPES = {"link_eps": torch.float32, "rho": torch.float32,
                  "participation": torch.float32,
                  "local_epochs": torch.int32}


def field_value(name: str, value):
    """One scenario's field as the scalar path holds it (a Python int or
    float, or a CPU tensor), from a host value such as a grid's numpy
    leaf."""
    if value is None:
        return None
    if name in _INT_FIELDS:
        return int(value)
    if name in _FLOAT_FIELDS:
        return float(value)
    if torch.is_tensor(value):
        return value.to(_TENSOR_DTYPES[name])
    return torch.tensor(np.asarray(value), dtype=_TENSOR_DTYPES[name])


class ScenarioBatch(NamedTuple):
    """G scenarios prepared for the batched round (`prepare_batch`).

    ``scenario`` holds every hoisted field as the scalar path holds it and
    every field named in ``mapped`` as a (G, ...) tensor on the run's
    device; ``rho`` is routed.  ``seeds`` are the G scenario seeds.
    """

    scenario: Scenario
    mapped: tuple[str, ...]
    seeds: tuple[int, ...]

    def at_round(self, t: int) -> Scenario:
        """`Scenario.at_round` applied row by row: time axes sliced at
        ``t`` modulo their length (axis 1 of a mapped field)."""
        s = self.scenario
        out = {}
        for name, rank in (("link_eps", 3), ("rho", 3),
                           ("participation", 2)):
            x = getattr(s, name)
            if x is None:
                continue
            mapped = name in self.mapped
            if x.ndim == rank + mapped:
                tt = t % x.shape[mapped]
                out[name] = x[:, tt] if mapped else x[tt]
        return s._replace(**out)


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
                     *, bits_per_value: int = errors.FLOAT_BITS,
                     strict: bool = False) -> bool:
    """Validate the codec segment size against a recorded PER packet length.

    Returns True when ``bits_per_value * seg_len`` equals the recorded
    packet length (or none was recorded); otherwise warns once per distinct
    triple, or with ``strict`` (admission) raises ValueError.
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
    if strict:
        raise ValueError(msg)
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


def make_scenario(
    net: topology.Network,
    cfg: SimConfig,
    *,
    link_schedule=None,
    participation=None,
    local_epochs=None,
    sampling_policy: str | None = None,
    select_frac: float = 0.5,
    codec: str | None = None,
    compress_ratio: float | None = None,
) -> Scenario:
    """Lift a (Network, SimConfig) pair into a Scenario.

    Optional axes: ``link_schedule`` replaces the network's link matrix by
    a (T, V, V) stack (`topology.markov_link_schedule` /
    `mobility_link_schedule` / `fading_per_schedule`); ``participation``
    an (N,) or (T, N) sampling mask;
    ``local_epochs`` an (N,) per-client vector; ``sampling_policy`` (a
    `core.selection.POLICY_IDS` name) makes participation closed-loop,
    each round selecting ``ceil(select_frac * N)`` clients from live
    signals, with ``participation`` as the availability base; ``codec`` (a
    `core.compression.CODEC_IDS` name, default ``cfg.codec``) encodes the
    exchange at ``compress_ratio`` (default ``cfg.compress_ratio``).
    """
    if cfg.protocol not in protocols.PROTOCOL_IDS:
        raise ValueError(f"unknown protocol {cfg.protocol!r}: choose from "
                         f"{sorted(protocols.PROTOCOL_IDS)}")
    if cfg.mode not in protocols.MODE_IDS:
        raise ValueError(f"unknown mode {cfg.mode!r}: choose from "
                         f"{sorted(protocols.MODE_IDS)}")
    codec = cfg.codec if codec is None else codec
    if codec is not None and codec not in compression.CODEC_IDS:
        raise ValueError(
            f"unknown codec {codec!r}: "
            f"choose from {sorted(compression.CODEC_IDS)}"
        )
    ratio = cfg.compress_ratio if compress_ratio is None else compress_ratio
    if codec is not None and not 0.0 < float(ratio) <= 1.0:
        raise ValueError(f"compress_ratio must be in (0, 1], got {ratio}")
    check_packet_consistency(net, cfg.seg_len)
    link_eps = (net.link_eps if link_schedule is None
                else np.array(link_schedule, np.float32))
    if sampling_policy is not None and sampling_policy not in selection.POLICY_IDS:
        raise ValueError(
            f"unknown sampling_policy {sampling_policy!r}: "
            f"choose from {sorted(selection.POLICY_IDS)}"
        )
    return Scenario(
        link_eps=torch.as_tensor(link_eps, dtype=torch.float32),
        seed=int(cfg.seed),
        protocol_id=protocols.PROTOCOL_IDS[cfg.protocol],
        mode_id=protocols.MODE_IDS[cfg.mode],
        aggregator=int(cfg.cfl_aggregator),
        lr=float(cfg.lr),
        participation=(None if participation is None else
                       torch.as_tensor(participation, dtype=torch.float32)),
        local_epochs=(None if local_epochs is None else
                      torch.as_tensor(local_epochs, dtype=torch.int32)),
        policy_id=(None if sampling_policy is None
                   else selection.POLICY_IDS[sampling_policy]),
        select_frac=None if sampling_policy is None else float(select_frac),
        codec_id=None if codec is None else compression.CODEC_IDS[codec],
        compress_ratio=None if codec is None else float(ratio),
    )


@dataclasses.dataclass
class SimResult:
    acc_per_client: np.ndarray    # (rounds, N) test accuracy
    loss_per_client: np.ndarray   # (rounds, N) train loss
    bias_norms: np.ndarray        # (rounds,) mean ||Lambda_l||_F^2 (ra only)

    @property
    def mean_acc(self) -> np.ndarray:
        return self.acc_per_client.mean(axis=1)


def _pad_shards(
        data: FederatedDataset) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad client shards to a common size by tiling (full-batch GD):
    (xs, ys, the clients' own shard sizes).  A tiled shard's first rows are
    the client's own samples, in order."""
    max_sz = max(len(x) for x in data.train_x)

    def pad(x):
        reps = -(-max_sz // len(x))
        return np.tile(x, (reps,) + (1,) * (x.ndim - 1))[:max_sz]

    return (np.stack([pad(x) for x in data.train_x]),
            np.stack([pad(y) for y in data.train_y]),
            np.array([len(x) for x in data.train_x]))


@dataclasses.dataclass(frozen=True)
class SimPrograms:
    """The round loop bound to one (init, apply, data, statics) binding.

    ``round_step(state, scenario, *, u=None, u_codec=None, generator=None)``
    advances one round on pytree-like state ``{"params": client-stacked
    dict}`` and evaluates it; ``u`` carries the round's protocol uniforms
    (see `protocols.dispatch_round_seg`) and ``u_codec`` the quantizer's
    (N, S, K) uniforms.  ``init_scan(scenario)`` builds the segment-native
    state ``{"w": (N, S, K) rows, "gen": Generator, "t": next round[,
    "sig": SelectionSignals]}`` and ``advance_chunk(state, scenario, *,
    u=None, u_codec=None)`` advances one chunk (``eval_every`` rounds, one
    metrics row; ``u`` / ``u_codec`` are then per-round lists);
    ``run_scenario`` loops it.

    The batched counterparts run G scenarios at once:
    ``prepare_batch(batch, axes)`` takes a Scenario of (G, ...) leaves and
    a Scenario of axes (0: the field varies across the batch, None: it is
    hoisted, its leaf one scenario's value) and returns a `ScenarioBatch`;
    ``init_scan_batch(sb)`` builds ``{"w": (G, N, S, K), "gens": G
    generators, "t"[, "sig"]}``, ``advance_chunk_batch(state, sb, *,
    u=None, u_codec=None)`` advances one chunk (``u`` / ``u_codec``: None
    or one entry per scenario, each None or a per-round list as
    ``advance_chunk`` takes), and ``run_scenario_batch(sb)`` loops it,
    returning metrics with a leading G axis.

    With ``model_shards > 1`` every state's ``"w"`` is this rank's window
    (N, L_local, K) (batched: (G, N, L_local, K)); ``full_rows`` gathers
    the full (..., N, S, K) rows from the model group and ``local_window``
    takes this rank's window of them (both the identity when
    ``model_shards == 1``).  ``round_step`` refuses a sharded sim.
    """

    round_step: Callable
    run_scenario: Callable[[Scenario], dict]
    init_scan: Callable[[Scenario], dict]
    advance_chunk: Callable
    prepare_batch: Callable[[Scenario, Scenario], ScenarioBatch]
    init_scan_batch: Callable[[ScenarioBatch], dict]
    advance_chunk_batch: Callable
    run_scenario_batch: Callable[[ScenarioBatch], dict]
    n_clients: int
    n_rounds: int
    n_chunks: int
    eval_every: int
    n_segments: int       # S: segment count of the bound model
    seg_len: int
    device: torch.device
    bits_per_value: int = errors.FLOAT_BITS   # from the bound state dtype
    model_shards: int = 1
    local_segments: int = 0   # L_local = ceil(S / model_shards)
    full_rows: Callable | None = None
    local_window: Callable | None = None


def _optimizer_factory(local_optimizer) -> Callable | None:
    """``lr -> Optimizer`` for a `build_sim(local_optimizer=)` value."""
    if local_optimizer is None:
        return None
    if isinstance(local_optimizer, str):
        optimizers.get(local_optimizer, 0.0)   # fail on unknown names now
        return functools.partial(optimizers.get, local_optimizer)
    if isinstance(local_optimizer, optimizers.Optimizer):
        return lambda lr: local_optimizer
    if callable(local_optimizer):
        return local_optimizer
    raise ValueError(
        "local_optimizer must be None, an optimizer name, an "
        f"Optimizer, or a factory lr -> Optimizer; got {local_optimizer!r}"
    )


def _per_round(draws, count: int, name: str) -> list:
    """``advance_chunk``'s explicit draws: None, or one entry a round."""
    if draws is None:
        return [None] * count
    if len(draws) != count:
        raise ValueError(f"{name} needs one entry per round of the chunk "
                         f"({count}), got {len(draws)}")
    return list(draws)


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
    local_optimizer: Any = None,
    device: str | torch.device | None = None,
    model_shards: int = 1,
    mesh: launch_mesh.Mesh | None = None,
) -> SimPrograms:
    """Bind data + statics into the round loop on ``device``.

    Args:
      init_fn: model init, ``CPU generator -> params`` (flat dict in the
        reference's leaf order); every client starts from the same init.
      apply_fn: forward pass, ``(params, x) -> logits``.
      data: federated dataset; client shards are padded to a common size by
        tiling (full-batch GD per the paper); an image model with
        convolutions trains on each client's own samples, each weighed by
        its count in the tiled shard.
      seg_len: K values per packet segment.
      local_epochs: I full-batch epochs per round (the bound that
        per-client ``Scenario.local_epochs`` clip to).
      n_rounds: rounds in `run_scenario`.
      aayg_mixes: J one-hop mix iterations for AaYG.
      agg_impl: aggregation substrate (auto | torch | kernel, or None for
        ``REPRO_AGG_IMPL``; see `core.aggregation.apply_mode`).
      eval_every: evaluate test accuracy / train loss only every k-th round
        (must divide ``n_rounds``); ``bias`` stays per-round.
      track_bias: False skips the R&A ||Lambda||^2 diagnostic (NaN).
      local_optimizer: the local-update rule.  None is the paper's plain
        full-batch GD; otherwise an `optim.optimizers` name ("sgd",
        "adamw"), an `optimizers.Optimizer` (its own lr wins over the
        scenario's) or a factory ``lr -> Optimizer``.  Optimizer state is
        fresh every round; it acts on all clients' rows at once (its
        updates are elementwise), outside the vmapped gradient.
      device: where the loop runs; default the CUDA card (raises without
        one), or with a sharded ``mesh`` the mesh's device.  Pass
        ``"cpu"`` for the plain path.
      model_shards: Dm, the model-axis size.  With ``model_shards > 1``
        the state holds this rank's ``L_local = ceil(S / Dm)`` segment
        window and every rank of its model group runs the same calls;
        ``mesh`` must carry the model axis (`launch.mesh.MODEL_AXIS`) at
        size Dm.  ``model_shards=1`` (default) needs no mesh and is the
        single-device loop.
      mesh: a `launch.mesh.grid_model_mesh` holding this rank (read only
        when ``model_shards > 1``).
    """
    if model_shards < 1:
        raise ValueError(f"model_shards={model_shards} must be >= 1")
    if model_shards > 1:
        if mesh is None:
            raise ValueError(
                f"model_shards={model_shards} needs a mesh with a "
                f"'{MODEL_AXIS}' axis (e.g. launch.mesh.grid_model_mesh)")
        if mesh.shape.get(MODEL_AXIS) != model_shards:
            raise ValueError(f"mesh axes {mesh.shape} do not provide "
                             f"{MODEL_AXIS}={model_shards}")
        if device is None:
            device = mesh.device
    else:
        mesh = None
    dev = resolve_device(device)
    validate_eval_schedule(n_rounds, eval_every)
    agg_impl = aggregation.resolve_impl(agg_impl)
    opt_factory = _optimizer_factory(local_optimizer)

    n = data.n_clients
    p = torch.tensor(data.weights(), dtype=torch.float32, device=dev)
    xs_np, ys_np, own_np = _pad_shards(data)
    xs = torch.from_numpy(xs_np).to(dev)
    ys = torch.from_numpy(ys_np).to(dev)
    own_samples = int(own_np.sum())
    test_x = torch.from_numpy(np.asarray(data.test_x)).to(dev)
    test_y = torch.from_numpy(np.asarray(data.test_y)).to(dev)

    # Static segment layout: every parameter view below is pure layout.
    params_like = init_fn(torch.Generator().manual_seed(0))
    names = list(params_like)
    shapes = [tuple(t.shape) for t in params_like.values()]
    sizes = [int(t.numel()) for t in params_like.values()]
    m_params = sum(sizes)
    s_total = errors.num_segments(m_params, seg_len)
    l_local = -(-s_total // model_shards)
    seg_start = 0
    if model_shards > 1:
        model_group, model_fiber = mesh.axis_group(MODEL_AXIS)
        seg_start = mesh.axis_index(MODEL_AXIS) * l_local
    # Segments carry the promoted state dtype; the quantizer prices it.
    bits_per_value = errors.dtype_bits(functools.reduce(
        torch.promote_types, (t.dtype for t in params_like.values())))

    def _leaf_views(row: torch.Tensor) -> dict:
        """One client's params as layout views of its (S, K) row."""
        parts = torch.split(row.reshape(-1)[:m_params], sizes)
        return {nm: pt.reshape(sh) for nm, pt, sh in zip(names, parts, shapes)}

    def _stacked_views(rows: torch.Tensor) -> dict:
        """Every client's params as layout views of the (N, S, K) rows."""
        parts = torch.split(rows.reshape(n, -1)[:, :m_params], sizes, dim=1)
        return {nm: pt.reshape((n,) + sh)
                for nm, pt, sh in zip(names, parts, shapes)}

    def _row_loss(row, x, y):
        return ce_loss(apply_fn(_leaf_views(row), x), y)

    # Local training's gradients, (N, S, K) from the (N, S, K) rows.  A
    # model of images (NHWC samples) with convolutions (a rank-4 leaf, an
    # HWIO kernel; a language model's rank-4 leaves are stacked experts)
    # trains one client at a time over its own samples: under vmap over
    # clients each convolution would be one grouped convolution over N
    # channel groups (cuDNN's legacy float32 engines, wrapped in layout
    # transposes), and every client would compute its shard tiled to the
    # largest.  Sample i of a client's k appears M // k + (i < M % k) times
    # among the M rows of its tiled shard, so weighing it by that count
    # over M gives the tiled shard's mean (eq. 3).  Other models keep
    # vmap(grad) over the tiled shards: a linear layer with per-client
    # weights batches into one GEMM, and the LSTM's steps are
    # launch-bound already.
    if xs.ndim == 5 and any(len(sh) == 4 for sh in shapes):
        def _client_loss(row, x, y, weights, grouped):
            params = _leaf_views(row)
            if grouped:
                params = channels_last_kernels(params)
            return weighted_ce_loss(apply_fn(params, x), y, weights)

        _client_grad = torch.func.grad(_client_loss)
        big = xs.shape[1]
        shards = [(xs[m, :k], ys[m, :k],
                   ((big // k + (torch.arange(k) < big % k)) / big).to(
                       device=dev, dtype=torch.float32))
                  for m, k in enumerate(own_np.tolist())]
        rows_per_pass = own_samples

        def _grads(rows: torch.Tensor) -> torch.Tensor:
            # Under a batch's vmap over G > 1 scenarios each convolution is
            # grouped over them, and cuDNN transposes far less with the
            # kernels channels-last, as the NHWC input is; a dense one
            # (G = 1) runs faster from the HWIO view (ResNet-56 sweeps on
            # the H100: 1.55 against 1.21 scenario-rounds/s at G = 4, 0.485
            # against 0.509 at G = 1).
            grouped = vmap_size(rows) > 1
            return torch.stack([_client_grad(rows[m], *shard, grouped)
                                for m, shard in enumerate(shards)])
    else:
        _batched_grad = torch.func.vmap(torch.func.grad(_row_loss))
        rows_per_pass = xs.shape[0] * xs.shape[1]

        def _grads(rows: torch.Tensor) -> torch.Tensor:
            return _batched_grad(rows, xs, ys)

    _batched_loss = torch.func.vmap(_row_loss)

    def _row_acc(row):
        return accuracy(apply_fn(_leaf_views(row), test_x), test_y)

    _batched_acc = torch.func.vmap(_row_acc)

    def local_train(rows: torch.Tensor, lr: float,
                    epochs: torch.Tensor | None = None) -> torch.Tensor:
        """``local_epochs`` full-batch steps per client (paper eq. 3).

        With a per-client ``epochs`` vector (N,) the loop still runs the
        static bound, but client m's row and optimizer moments freeze after
        its own count (values clip to the bound).  The optimizer's step
        count is shared: once frozen a client stays frozen, so it never
        reads the count again.
        """
        opt = None if opt_factory is None else opt_factory(lr)
        state = None if opt is None else opt.init(rows)
        for i in range(local_epochs):
            with span("dfl:local_train"):
                g = _grads(rows)
            if opt is None:
                new, new_state = rows - lr * g, None
            else:
                new, new_state = opt.update(rows, g, state)
            if epochs is not None:
                keep = (i < epochs).reshape(n, 1, 1)
                new = torch.where(keep, new, rows)
                if new_state is not None:
                    new_state = {k: v if k == "step" else
                                 torch.where(keep, v, state[k])
                                 for k, v in new_state.items()}
            rows, state = new, new_state
        return rows

    def full_rows(w_loc: torch.Tensor) -> torch.Tensor:
        """This shard's (..., N, L_local, K) window -> the full
        (..., N, S, K) rows, gathered inside the model group."""
        if model_shards == 1:
            return w_loc
        full = launch_mesh.gather_along(w_loc, -2, model_group, model_fiber)
        return full.narrow(-2, 0, s_total)

    def local_window(full: torch.Tensor) -> torch.Tensor:
        """Full (..., N, S, K) rows -> this shard's window (zero past S)."""
        if model_shards == 1:
            return full
        padded = torch.nn.functional.pad(
            full, (0, 0, 0, l_local * model_shards - s_total))
        return padded.narrow(-2, seg_start, l_local).contiguous()

    def _init_rows(seed: int) -> torch.Tensor:
        """The full (N, S, K) rows of the common init of ``seed``."""
        params0 = init_fn(torch.Generator().manual_seed(seed))
        stacked = {k: v.to(dev)[None].expand((n,) + tuple(v.shape))
                   for k, v in params0.items()}
        return protocols._to_segments(stacked, seg_len)[0].contiguous()

    def _count_passes(scenarios: int) -> None:
        """Count one round's local training of ``scenarios`` scenarios in
        `SAMPLE_PASSES`."""
        count_launch(SAMPLE_PASSES, "computed",
                     scenarios * local_epochs * rows_per_pass)
        count_launch(SAMPLE_PASSES, "own",
                     scenarios * local_epochs * own_samples)

    def _round_draws(scenario: Scenario, generator, u, u_codec):
        """The round's (u, u_codec), drawing the missing ones from
        ``generator`` in the round's order: the quantizer's (N, S, K)
        uniforms under ``quant``, then the protocol's (R&A (N, N, S), AaYG
        (J, N, N, S), C-FL (2, N, S); ideal C-FL and "none" draw
        nothing)."""
        if (u_codec is None and scenario.codec_id
                == compression.CODEC_IDS["quant"]):
            u_codec = torch.rand((n, s_total, seg_len), generator=generator,
                                 device=dev)
        shape = {protocols.PROTOCOL_IDS["ra"]: (n, n, s_total),
                 protocols.PROTOCOL_IDS["aayg"]: (aayg_mixes, n, n, s_total),
                 protocols.PROTOCOL_IDS["cfl"]: (2, n, s_total)}.get(
                     scenario.protocol_id)
        if u is None and shape is not None:
            u = torch.rand(shape, generator=generator, device=dev)
        return u, u_codec

    def _participation(scenario_t: Scenario):
        part = scenario_t.participation
        return None if part is None else part[:n]

    def _round_core(w: torch.Tensor, scenario: Scenario, part, u, u_codec,
                    generator, ratio_override=None):
        """Train -> keep non-participants -> encode -> exchange.

        ``w`` are the full (N, S, K) rows.  ``part`` is the realized (N,)
        participation mask (None: everyone).  Returns (new rows of this
        shard's window, trained full rows, bias).  The exchange sees the
        encoded rows under the codec's transmit mask; the exchange-free
        protocols and every sampled-out receiver keep the unencoded rows.
        ``ratio_override`` ((N,), optional) is the budget policy's
        per-client ratio.  Missing uniforms come from ``generator``
        (`_round_draws`); inside a batch's vmap both are given.
        """
        u, u_codec = _round_draws(scenario, generator, u, u_codec)
        trained = local_train(w, scenario.lr, scenario.local_epochs)
        if part is not None:
            trained = torch.where(part[:, None, None] > 0, trained, w)
        w_send, tx_mask, w_raw = trained, None, None
        if scenario.codec_id is not None:
            ratio = (scenario.compress_ratio if ratio_override is None
                     else ratio_override)
            w_send, tx_mask = compression.encode(
                scenario.codec_id, trained, ratio, u=u_codec,
                generator=generator, n_real=s_total,
                dtype_bits=bits_per_value)
            w_raw = local_window(trained)
        w_send = local_window(w_send)
        with span("dfl:exchange"):
            new, _e, bias = protocols.dispatch_round_seg(
                w_send, p, scenario.rho, scenario.link_eps,
                scenario.protocol_id, scenario.mode_id, scenario.aggregator,
                n_mixes=aayg_mixes, participation=part, tx_mask=tx_mask,
                w_raw=w_raw, u=u, generator=generator, agg_impl=agg_impl,
                track_bias=track_bias,
                seg_total=None if model_shards == 1 else s_total,
                seg_start=seg_start,
            )
        if scenario.codec_id is not None and part is not None:
            # dispatch restores sampled-out receivers to its input, the
            # encoded rows; a client that sat the round out keeps its
            # unencoded state instead.
            new = torch.where(part[:, None, None] > 0, new, w_raw)
        return new, trained, bias

    def _closed_round(w: torch.Tensor, scenario_t: Scenario,
                      signals: selection.SelectionSignals, u, u_codec,
                      generator):
        """Closed-loop round on the full rows: select -> train ->
        exchange.  Returns (new window rows, trained rows, mask, bias);
        `_refresh` then updates the signals."""
        base = _participation(scenario_t)
        base = (torch.ones(n, dtype=torch.float32, device=dev)
                if base is None else base)
        rho = scenario_t.rho[:n, :n]
        mask = selection.select_clients(
            scenario_t.policy_id, base, signals, p, rho,
            scenario_t.select_frac)
        ratio_override = None
        if scenario_t.codec_id is not None:
            # Under "budget" the waterfill also sets each client's ratio.
            ratio_override = selection.budget_ratio(
                scenario_t.policy_id, base, p, rho, scenario_t.select_frac,
                scenario_t.compress_ratio)
        new, trained, bias = _round_core(w, scenario_t, mask, u, u_codec,
                                         generator, ratio_override)
        return new, trained, mask, bias

    def _refresh(signals: selection.SelectionSignals, mask, trained, old,
                 new) -> selection.SelectionSignals:
        """The participants' signals after a round: update norms of the
        trained vs the previous full rows, loss of the new full rows."""
        upd = selection.update_norms(_stacked_views(trained),
                                     _stacked_views(old))
        chosen = mask > 0
        return selection.SelectionSignals(
            loss=torch.where(chosen, _batched_loss(new, xs, ys),
                             signals.loss),
            upd_norm=torch.where(chosen, upd, signals.upd_norm))

    def _advance_closed(w_loc: torch.Tensor, scenario_t: Scenario,
                        signals: selection.SelectionSignals, u, u_codec,
                        generator):
        """Closed-loop round of one scenario: select -> train -> exchange
        -> refresh the participants' signals.  Returns (window rows,
        signals, mask, bias)."""
        w = full_rows(w_loc)
        new, trained, mask, bias = _closed_round(w, scenario_t, signals, u,
                                                 u_codec, generator)
        signals = _refresh(signals, mask, trained, w, full_rows(new))
        return new, signals, mask, bias

    def _metrics(rows: torch.Tensor) -> dict:
        return {"acc": _batched_acc(rows), "loss": _batched_loss(rows, xs, ys)}

    @torch.no_grad()
    def round_step(state: dict, scenario: Scenario, *, u=None, u_codec=None,
                   generator: torch.Generator | None = None):
        """One D-FL round: local training + protocol exchange + metrics.

        state: {"params": client-stacked dict (leaves (N, ...))}.  ``u``:
        this round's protocol uniforms, ``u_codec`` the quantizer's (else
        both are drawn from ``generator``).  ``scenario`` must be a
        per-round view (slice a (T, N) schedule with `Scenario.at_round`)
        of an open-loop scenario.
        """
        if scenario.policy_id is not None:
            raise ValueError(
                "round_step cannot run a closed-loop scenario: the "
                "sampling policy needs the signal carry that only "
                "init_scan / advance_chunk thread"
            )
        if model_shards != 1:
            raise ValueError(
                "round_step exposes the unsharded pytree-state API; build "
                "the sim with model_shards=1 (run_scenario / advance_chunk "
                "are the model-sharded entry points)"
            )
        if scenario.link_eps.ndim == 3 or (
                scenario.participation is not None
                and scenario.participation.ndim == 2):
            raise ValueError(
                "round_step takes a per-round scenario; slice a dynamic "
                "scenario with scenario.at_round(t) (advance_chunk does "
                "this inside its loop)"
            )
        scenario = scenario.prepare().to(dev)
        stacked = {k: v.to(dev) for k, v in state["params"].items()}
        w_seg, spec, mp = protocols._to_segments(stacked, seg_len)
        with span("dfl:draws"):
            u, u_codec = _round_draws(scenario, generator, u, u_codec)
        _count_passes(1)
        new, _trained, bias = _round_core(
            w_seg, scenario, _participation(scenario), u, u_codec, generator)
        with span("dfl:eval"):
            metrics = {**_metrics(new), "bias": bias}
        return {"params": protocols._from_segments(new, spec, mp)}, metrics

    n_chunks = n_rounds // eval_every

    @torch.no_grad()
    @spanned("dfl:init")
    def init_scan(scenario: Scenario) -> dict:
        """The segment-native state at round 0 (before training); a
        closed-loop scenario's state also carries its signals."""
        gen = torch.Generator(device=dev).manual_seed(int(scenario.seed))
        full = _init_rows(int(scenario.seed))
        state = {"w": local_window(full), "gen": gen, "t": 0}
        if scenario.policy_id is not None:
            state["sig"] = selection.init_signals(
                _batched_loss(full, xs, ys))
        return state

    @torch.no_grad()
    def advance_chunk(state: dict, scenario: Scenario, *, u=None,
                      u_codec=None):
        """Advance ``eval_every`` rounds; returns (state, metrics row) with
        per-round ``bias`` (and ``selected`` masks for a closed-loop
        scenario) and chunk-end ``acc`` / ``loss``.  ``u`` / ``u_codec``:
        optional lists of one round's draws each (see `round_step`), else
        the state's generator draws."""
        scenario = scenario.prepare().to(dev)
        us = _per_round(u, eval_every, "u")
        ucs = _per_round(u_codec, eval_every, "u_codec")
        closed = scenario.policy_id is not None
        w, t, sig = state["w"], state["t"], state.get("sig")
        biases, chosen = [], []
        for i in range(eval_every):
            sc_t = scenario.at_round(t + i)
            with span("dfl:draws"):
                u_i, uc_i = _round_draws(sc_t, state["gen"], us[i], ucs[i])
            _count_passes(1)
            if closed:
                w, sig, mask, bias = _advance_closed(
                    w, sc_t, sig, u_i, uc_i, state["gen"])
                chosen.append(mask)
            else:
                w, _trained, bias = _round_core(
                    full_rows(w), sc_t, _participation(sc_t), u_i, uc_i,
                    state["gen"])
            biases.append(bias)
        new_state = {"w": w, "gen": state["gen"], "t": t + eval_every}
        with span("dfl:eval"):
            metrics = {**_metrics(full_rows(w)), "bias": torch.stack(biases)}
        if closed:
            new_state["sig"] = sig
            metrics["selected"] = torch.stack(chosen)
        return new_state, metrics

    @spanned("dfl:fetch")
    def _to_host(rows: list, dim: int, closed: bool) -> dict:
        """The chunks' metrics ``rows`` joined along ``dim`` (the chunk
        axis), as CPU tensors; ``selected`` too for a closed-loop run."""
        out = {"acc": torch.stack([m["acc"] for m in rows], dim=dim).cpu(),
               "loss": torch.stack([m["loss"] for m in rows], dim=dim).cpu(),
               "bias": torch.cat([m["bias"] for m in rows], dim=dim).cpu()}
        if closed:
            out["selected"] = torch.cat([m["selected"] for m in rows],
                                        dim=dim).cpu()
        return out

    def run_scenario(scenario: Scenario) -> dict:
        """Run ``n_rounds`` rounds; metrics as CPU tensors: acc / loss
        (n_chunks, N), bias (n_rounds,), and for a closed-loop scenario
        selected (n_rounds, N)."""
        scenario = scenario.prepare().to(dev)
        state = init_scan(scenario)
        rows = []
        for _ in range(n_chunks):
            state, m = advance_chunk(state, scenario)
            rows.append(m)
        return _to_host(rows, 0, scenario.policy_id is not None)

    # ------------------------------------------------------------------
    # The batched round: G scenarios under one torch.func.vmap.
    # ------------------------------------------------------------------
    @spanned("dfl:prepare")
    def prepare_batch(batch: Scenario, axes: Scenario) -> ScenarioBatch:
        """Route, type and move a batch of G scenarios (see SimPrograms).

        Each distinct link matrix (or schedule) of the batch is routed
        once, by `route`, the scalar path's own call; ``seed`` must be
        mapped.
        """
        for name in BATCH_IDS:
            if getattr(axes, name) is not None:
                raise ValueError(
                    f"a scenario batch must hold one {name}: the round "
                    f"branches on it in Python; split the batch by it "
                    f"(fl.scenarios.GridRunner does)")
        if axes.seed != 0:
            raise ValueError("a scenario batch maps its seed (axis 0)")
        seeds = tuple(int(x) for x in np.asarray(batch.seed))
        fields, mapped = {"seed": None}, []
        for name in Scenario._fields:
            if name == "seed":
                continue
            leaf = getattr(batch, name)
            if leaf is None or getattr(axes, name) is None:
                fields[name] = field_value(name, leaf)
            else:
                mapped.append(name)
                fields[name] = torch.tensor(np.asarray(leaf), dtype=(
                    _TENSOR_DTYPES.get(name, torch.float32)))
        if fields["rho"] is None and "link_eps" in mapped:
            routed = {}
            for row in fields["link_eps"]:
                key = row.numpy().tobytes()
                if key not in routed:
                    routed[key] = route(row)
            fields["rho"] = torch.stack([routed[row.numpy().tobytes()]
                                         for row in fields["link_eps"]])
            mapped.append("rho")
        elif fields["rho"] is None:
            fields["rho"] = route(fields["link_eps"])
        fields = {k: v.to(dev) if torch.is_tensor(v) else v
                  for k, v in fields.items()}
        return ScenarioBatch(Scenario(**fields), tuple(mapped), seeds)

    @torch.no_grad()
    @spanned("dfl:init")
    def init_scan_batch(sb: ScenarioBatch) -> dict:
        """`init_scan` for each scenario of the batch: (G, N, S, K) rows,
        one generator per scenario (each distinct seed's weights built
        once)."""
        rows = {seed: _init_rows(seed) for seed in dict.fromkeys(sb.seeds)}
        w = torch.stack([rows[seed] for seed in sb.seeds])
        state = {"w": local_window(w), "t": 0,
                 "gens": [torch.Generator(device=dev).manual_seed(seed)
                          for seed in sb.seeds]}
        if sb.scenario.policy_id is not None:
            state["sig"] = selection.init_signals(torch.func.vmap(
                lambda r: _batched_loss(r, xs, ys))(w))
        return state

    def _stack_draws(draws):
        if all(d is None for d in draws):
            return None
        return torch.stack([d.to(dev) for d in draws])

    def _batch_round(w_loc, sc_t: Scenario, mapped, sig, u, u_codec):
        """One round of every scenario of the batch, under one vmap (a
        closed loop refreshes its signals under a second one, after the
        new rows are gathered)."""
        closed = sc_t.policy_id is not None
        w = full_rows(w_loc)

        def one(w_i, sig_i, u_i, uc_i, *vals):
            sc_i = sc_t._replace(**dict(zip(mapped, vals)))
            if closed:
                return _closed_round(w_i, sc_i, sig_i, u_i, uc_i, None)
            new, _trained, bias = _round_core(
                w_i, sc_i, _participation(sc_i), u_i, uc_i, None)
            return new, bias

        dims = ((0, 0 if closed else None, None if u is None else 0,
                 None if u_codec is None else 0) + (0,) * len(mapped))
        out = torch.func.vmap(one, in_dims=dims)(
            w, sig, u, u_codec, *(getattr(sc_t, nm) for nm in mapped))
        if not closed:
            return out[0], None, None, out[1]
        new, trained, mask, bias = out
        sig = torch.func.vmap(_refresh)(sig, mask, trained, w,
                                        full_rows(new))
        return new, sig, mask, bias

    @torch.no_grad()
    def advance_chunk_batch(state: dict, sb: ScenarioBatch, *, u=None,
                            u_codec=None):
        """`advance_chunk` for every scenario of the batch: metrics with a
        leading G axis.  ``u`` / ``u_codec``: None, or one entry per
        scenario (None, or a per-round list as `advance_chunk` takes);
        what is missing each scenario draws from its own generator."""
        g = len(sb.seeds)
        us = [_per_round(x, eval_every, "u")
              for x in _per_round(u, g, "u (scenarios)")]
        ucs = [_per_round(x, eval_every, "u_codec")
               for x in _per_round(u_codec, g, "u_codec (scenarios)")]
        closed = sb.scenario.policy_id is not None
        w, t, sig, gens = state["w"], state["t"], state.get("sig"), \
            state["gens"]
        biases, chosen = [], []
        for i in range(eval_every):
            sc_t = sb.at_round(t + i)
            with span("dfl:draws"):
                draws = [_round_draws(sc_t, gens[j], us[j][i], ucs[j][i])
                         for j in range(g)]
                u_t = _stack_draws([d[0] for d in draws])
                uc_t = _stack_draws([d[1] for d in draws])
            _count_passes(g)
            w, sig_new, mask, bias = _batch_round(w, sc_t, sb.mapped, sig,
                                                  u_t, uc_t)
            if closed:
                sig = sig_new
                chosen.append(mask)
            biases.append(bias)
        new_state = {"w": w, "gens": gens, "t": t + eval_every}
        with span("dfl:eval"):
            metrics = {**torch.func.vmap(_metrics)(full_rows(w)),
                       "bias": torch.stack(biases, dim=1)}
        if closed:
            new_state["sig"] = sig
            metrics["selected"] = torch.stack(chosen, dim=1)
        return new_state, metrics

    def run_scenario_batch(sb: ScenarioBatch) -> dict:
        """`run_scenario` for every scenario of the batch: acc / loss
        (G, n_chunks, N), bias (G, n_rounds)[, selected (G, n_rounds, N)],
        as CPU tensors."""
        state = init_scan_batch(sb)
        rows = []
        for _ in range(n_chunks):
            state, m = advance_chunk_batch(state, sb)
            rows.append(m)
        return _to_host(rows, 1, sb.scenario.policy_id is not None)

    return SimPrograms(
        round_step=round_step,
        run_scenario=run_scenario,
        init_scan=init_scan,
        advance_chunk=advance_chunk,
        prepare_batch=prepare_batch,
        init_scan_batch=init_scan_batch,
        advance_chunk_batch=advance_chunk_batch,
        run_scenario_batch=run_scenario_batch,
        n_clients=n,
        n_rounds=n_rounds,
        n_chunks=n_chunks,
        eval_every=eval_every,
        n_segments=s_total,
        seg_len=seg_len,
        device=dev,
        bits_per_value=bits_per_value,
        model_shards=model_shards,
        local_segments=l_local,
        full_rows=full_rows,
        local_window=local_window,
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
        track_bias=cfg.track_bias, local_optimizer=cfg.local_optimizer,
        device=device,
    )
    return metrics_to_result(sim.run_scenario(make_scenario(net, cfg)))
