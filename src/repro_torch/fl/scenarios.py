"""Batched scenario engine: multi-seed / multi-PER / multi-protocol sweeps,
a whole group of scenarios per round under one `torch.func.vmap`.

Port of the single-device half of the reference package's
`fl/scenarios.py`.  The paper's headline results (Figs. 2, 3, 8, 9;
Table III) are sweeps over packet error rates, relay counts, protocols and
seeds:

    grid = ScenarioGrid.product(networks=[...], protocols=[...], seeds=[...])
    res = run_grid(init_fn, apply_fn, data, grid, cfg)   # (G, rounds, N)

Scenario axes, as in the reference:

  * seed            — model init + channel realizations,
  * link-PER        — any per-scenario `topology.Network` (packet length,
                      edge density, TX power... all collapse into link_eps),
  * relay count     — networks of different node counts are padded with
                      isolated zero-quality nodes (routing is unaffected),
  * protocol        — ra | aayg | cfl | ideal_cfl | none,
  * aggregation     — ra_normalized | substitution,
  * learning rate,
  * topology schedule — ``schedules=[(label, (T, V, V) link_eps stack)]``
                      (`topology.markov_link_schedule` /
                      `mobility_link_schedule` / `fading_per_schedule`);
                      round t uses entry t % T, each entry routed once,
  * client sampling — ``participation=[(label, (T, N) or (N,) mask)]``
                      (see `sampling_schedule`),
  * local epochs    — ``local_epochs=(N,)`` per-client vector,
  * sampling policy — ``sampling_policies=[(label, policy, frac)]``
                      (closed loop, `core.selection.POLICY_IDS`;
                      `GridResult.selected` records the realized masks),
  * exchange codec  — ``codecs=[(label, codec, ratio)]``
                      (`core.compression.CODEC_IDS`).

Grid leaves are kept host-side (numpy): grouping, padding and the
uniform-field test cost no device sync, and data moves to the device once
per dispatch.

How a grid runs.  `GridRunner.run` splits the grid into groups that share
every discrete id: protocol, mode, C-FL aggregator, codec and sampling
policy (and, grid-wide, whether participation or per-client epochs are
present).  The port's round branches on those ids in Python, so each must
be one value in a group; the reference can leave some of them batched
under `lax.switch` (its ``group_by_protocol=False``, which the port
therefore does not take).  Results are the same either way.  In a group, fields
equal across its rows are hoisted out of the vmap (`_hoist_uniform`) and
the rest are batched; each round of the group is one local-training pass
over G * N clients and, for R&A (AaYG: J), one K1 launch of B = G, the
vmap folding into the kernel through its vmap rule
(`kernels.ops._ra_vmap_rule`).  No random draw happens inside the vmap:
each scenario draws its round's uniforms from its own generator, seeded
with its seed, as `run_sequential` does (`simulator.ScenarioBatch`).
Under a profiler `run` names its host phases (`launch.tracker.span`):
``dfl:prepare`` around admission and around each group's batching and
program lookup, ``dfl:fetch`` around the rows' reassembly; the round's
own phases are `simulator`'s.

Multi-rank grids.  ``devices=`` / ``sharding=`` spread a grid over the
ranks of a `launch.mesh` mesh, one process per rank, every rank calling
`run` with the same grid (SPMD).  Each dispatch group is padded to a
multiple of the grid axis (a mesh wider than the group shrinks to it,
its other ranks sitting the group out), each grid row runs its share of
the group's scenarios, and the rows' metrics are gathered along the mesh
(`all_gather_object` on host arrays), so every rank's `GridResult` is the
single-device one.  On a ('grid', 'model') mesh each scenario's segment
axis is also split over the row's model shards (`simulator.build_sim`'s
``model_shards``): every shard launches K1 on its own window.  A call
that names one device (None, a device, 1) is the single-device engine and
needs no process group; one naming more ranks than an initialized default
process group holds raises ValueError.

Public API
----------
  ScenarioGrid.product(...)       build a cross-product grid
  ScenarioGrid.concat(*grids)     join heterogeneous grids (re-pads V and
                                  the time axis, drops rho)
  sampling_schedule(...)          (T, N) per-round client-sampling mask
  run_grid(...)                   one-shot batched run (devices= /
                                  sharding=: over a launch.mesh mesh)
  names_one_device(devices)       whether a devices= value is one device
  run_sequential(...)             per-scenario baseline
  GridRunner(...)                 warm-program runner for repeated grids
                                  (tracker= / max_cached_programs= /
                                  warmup() / validate())
  ProgramCache                    bounded LRU of built grid programs
  validate_grid / AdmissionError  admission-time request validation
  GridResult                      stacked trajectories + per-label access
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import Counter, OrderedDict
from typing import Any, Callable, Iterable, Sequence

import numpy as np
import torch

from .. import resolve_device
from ..core import compression, protocols, selection, topology
from ..data.synthetic import FederatedDataset
from ..kernels import ops
from ..launch import mesh as launch_mesh
from ..launch import tracker as launch_tracker
from ..launch.tracker import span
from . import simulator

# `GridRunner.run(devices=...)` default: inherit the runner's spec.
_INHERIT = object()

PROTOCOL_IDS = protocols.PROTOCOL_IDS
MODE_IDS = protocols.MODE_IDS


def _pad_link_eps(link_eps, v_max: int) -> np.ndarray:
    """Pad a (..., V, V) link matrix / stack to V = v_max with isolated
    nodes: zero link quality in and out, so every real route and the
    client block of rho are unchanged."""
    arr = np.asarray(link_eps, np.float32)
    v = arr.shape[-1]
    pad = [(0, 0)] * (arr.ndim - 2) + [(0, v_max - v), (0, v_max - v)]
    return np.pad(arr, pad)


def _tile_schedule(arr: np.ndarray, t_target: int, what: str) -> np.ndarray:
    """Cyclically tile a (T, ...) schedule to ``t_target`` entries.

    Round t reads entry t % T, so tiling to a multiple of T is exact; any
    other target would change the trajectory, so it raises.
    """
    t = arr.shape[0]
    if t == t_target:
        return arr
    if t_target % t:
        raise ValueError(
            f"cannot align {what} of length {t} to a common time axis of "
            f"{t_target} rounds: {t_target} is not a multiple of {t}"
        )
    return np.tile(arr, (t_target // t,) + (1,) * (arr.ndim - 1))


def _pad_scenario_batch(batch: simulator.Scenario,
                        g_target: int) -> simulator.Scenario:
    """Pad a (G, ...)-leaved scenario batch to ``g_target`` rows.

    Filler rows copy row 0 (so a group stays homogeneous in its discrete
    ids) except ``link_eps``, which is all zero: every node isolated,
    every segment falls back to the sender's own.  Their results are
    dropped; host-side numpy.
    """
    g = batch.link_eps.shape[0]
    if g_target < g:
        raise ValueError(f"cannot pad {g} scenarios down to {g_target}")
    if g_target == g:
        return batch
    n_pad = g_target - g

    def pad_leaf(name: str, leaf):
        if leaf is None:
            return None
        arr = np.asarray(leaf)
        filler = np.broadcast_to(arr[:1], (n_pad,) + arr.shape[1:])
        if name == "link_eps":
            filler = np.zeros_like(filler)
        return np.concatenate([arr, filler])

    return simulator.Scenario(
        **{name: pad_leaf(name, leaf)
           for name, leaf in batch._asdict().items()}
    )


def sampling_schedule(n_clients: int, n_rounds: int, fraction: float, *,
                      seed: int = 0) -> np.ndarray:
    """A (T, N) client-sampling mask: per round, a uniform random subset.

    Each round independently samples ``ceil(fraction * n_clients)`` clients
    without replacement (at least one).  ``fraction=1`` yields the all-ones
    mask.  Deterministic in ``seed`` (the reference's draws exactly).
    """
    if not 0.0 < fraction <= 1.0:
        raise ValueError(f"fraction must be in (0, 1], got {fraction}")
    k = min(n_clients, max(1, int(np.ceil(fraction * n_clients))))
    rng = np.random.default_rng(seed)
    out = np.zeros((n_rounds, n_clients), np.float32)
    for t in range(n_rounds):
        out[t, rng.choice(n_clients, size=k, replace=False)] = 1.0
    return out


def _dedupe_labels(labels: list[str]) -> list[str]:
    """Disambiguate colliding labels deterministically (``label#k``): every
    member of a colliding set gets an occurrence suffix; unique labels pass
    through."""
    counts = Counter(labels)
    if max(counts.values(), default=0) <= 1:
        return labels
    seen: dict[str, int] = {}
    out = []
    for lbl in labels:
        if counts[lbl] > 1:
            k = seen.get(lbl, 0)
            seen[lbl] = k + 1
            out.append(f"{lbl}#{k}")
        else:
            out.append(lbl)
    return out


def _normalize_participation(leaf, n_ref: int, t_target: int) -> np.ndarray:
    """Batch-leaf participation -> (G, T, N) float32, cyclically tiled."""
    arr = np.asarray(leaf, np.float32)
    if arr.ndim == 2:                       # (G, N) static mask per row
        arr = arr[:, None, :]
    if arr.ndim != 3 or arr.shape[-1] != n_ref:
        raise ValueError(
            f"participation leaves must be (G, N={n_ref}) or (G, T, N), "
            f"got shape {arr.shape}"
        )
    if arr.shape[1] != t_target:
        if t_target % arr.shape[1]:
            raise ValueError(
                f"cannot align participation schedule of length "
                f"{arr.shape[1]} to {t_target} (not a multiple)"
            )
        arr = np.tile(arr, (1, t_target // arr.shape[1], 1))
    return arr


def _stack_leaves(rows, combine) -> simulator.Scenario:
    """Field by field ``combine`` of the rows' numpy leaves (None stays)."""
    return simulator.Scenario(**{
        name: (None if getattr(rows[0], name) is None
               else combine([np.asarray(getattr(r, name)) for r in rows]))
        for name in simulator.Scenario._fields
    })


@dataclasses.dataclass
class ScenarioGrid:
    """A flat batch of scenarios: every Scenario leaf stacked on axis 0.

    Leaves are host-side numpy arrays.  ``packet_len_bits`` records the
    distinct PER packet lengths of the source networks (where known):
    `GridRunner.run` checks them against the codec's segment size
    (`simulator.check_packet_len`).
    """

    scenarios: simulator.Scenario   # leaves with leading G axis
    labels: list[str]
    packet_len_bits: tuple[int, ...] = ()

    def __len__(self) -> int:
        return len(self.labels)

    def scenario(self, i: int) -> simulator.Scenario:
        """The i-th scenario as the scalar path takes it (Python ids and
        floats, CPU tensors)."""
        return simulator.Scenario(**{
            name: simulator.field_value(
                name, None if leaf is None else np.asarray(leaf)[i])
            for name, leaf in self.scenarios._asdict().items()
        })

    def take(self, indices: Sequence[int]) -> "ScenarioGrid":
        """The sub-grid of the given rows (host-side fancy indexing);
        labels and packet lengths follow the selection."""
        idx = np.asarray(indices, np.intp)
        if idx.ndim != 1:
            raise ValueError(f"take() needs a 1-D index list, got {idx.shape}")
        return ScenarioGrid(
            scenarios=simulator.Scenario(**{
                name: None if leaf is None else np.asarray(leaf)[idx]
                for name, leaf in self.scenarios._asdict().items()
            }),
            labels=[self.labels[int(i)] for i in idx],
            packet_len_bits=self.packet_len_bits,
        )

    @staticmethod
    def concat(*grids: "ScenarioGrid") -> "ScenarioGrid":
        """Join grids into one batch, re-padding link matrices to a common V.

        Static and dynamic grids mix: static link matrices are promoted to
        T = 1 schedules and cyclically tiled to the longest time axis (a
        multiple of every grid's T); missing participation masks become
        all-ones, a missing policy the ``uniform`` one and a missing codec
        ``none`` at ratio 1 (each the exact neutral point).  Grids must
        agree on having per-client ``local_epochs``.  Any ``rho`` is
        dropped (routing reruns on the padded matrices); colliding labels
        get an occurrence suffix (`_dedupe_labels`).
        """
        v_max = max(g.scenarios.link_eps.shape[-1] for g in grids)
        ranks = {np.ndim(g.scenarios.link_eps) for g in grids}
        dynamic_t = 4 in ranks              # (G, T, V, V) present
        t_max = max(
            (g.scenarios.link_eps.shape[1] for g in grids
             if np.ndim(g.scenarios.link_eps) == 4),
            default=1,
        )
        has_part = [g.scenarios.participation is not None for g in grids]
        has_epochs = [g.scenarios.local_epochs is not None for g in grids]
        any_policy = any(g.scenarios.policy_id is not None for g in grids)
        any_codec = any(g.scenarios.codec_id is not None for g in grids)
        if any(has_epochs) and not all(has_epochs):
            raise ValueError(
                "cannot concat grids with and without per-client "
                "local_epochs: pass an explicit vector to every grid "
                "(there is no neutral stand-in for the static config value)"
            )
        part_n = None
        if any(has_part):
            ns = {g.scenarios.participation.shape[-1]
                  for g in grids if g.scenarios.participation is not None}
            if len(ns) != 1:
                raise ValueError(f"participation client counts differ: {ns}")
            (part_n,) = ns
            t_part = max(
                (g.scenarios.participation.shape[1] for g in grids
                 if g.scenarios.participation is not None
                 and np.ndim(g.scenarios.participation) == 3),
                default=1,
            )

        def normalize(g: ScenarioGrid) -> simulator.Scenario:
            s = g.scenarios
            le = np.asarray(s.link_eps, np.float32)
            if dynamic_t:
                if le.ndim == 3:
                    le = le[:, None]                    # (G, 1, V, V)
                if le.shape[1] != t_max:
                    if t_max % le.shape[1]:
                        raise ValueError(
                            f"cannot align topology schedule of length "
                            f"{le.shape[1]} to {t_max} (not a multiple)"
                        )
                    le = np.tile(le, (1, t_max // le.shape[1], 1, 1))
            le = _pad_link_eps(le, v_max)
            part = s.participation
            if part_n is not None:
                if part is None:
                    part = np.ones((len(g), 1, part_n), np.float32)
                part = _normalize_participation(part, part_n, t_part)
            pol, frac = s.policy_id, s.select_frac
            if any_policy and pol is None:
                pol = np.zeros((len(g),), np.int32)
                frac = np.ones((len(g),), np.float32)
            cod, ratio = s.codec_id, s.compress_ratio
            if any_codec and cod is None:
                cod = np.full((len(g),), compression.CODEC_IDS["none"],
                              np.int32)
                ratio = np.ones((len(g),), np.float32)
            return s._replace(link_eps=le, rho=None, participation=part,
                              policy_id=pol, select_frac=frac,
                              codec_id=cod, compress_ratio=ratio)

        stacked = _stack_leaves([normalize(g) for g in grids],
                                np.concatenate)
        labels = _dedupe_labels([lbl for g in grids for lbl in g.labels])
        pkt = tuple(sorted({b for g in grids for b in g.packet_len_bits}))
        return ScenarioGrid(scenarios=stacked, labels=labels,
                            packet_len_bits=pkt)

    @staticmethod
    def product(
        *,
        networks: Sequence[tuple[str, topology.Network]] = (),
        schedules: Sequence[tuple[str, Any]] = (),
        protocols: Sequence[tuple[str, str]] = (("ra", "ra_normalized"),),
        seeds: Iterable[int] = (0,),
        lrs: Iterable[float] = (0.05,),
        participation: Sequence[tuple[str, Any]] | None = None,
        sampling_policies: Sequence[tuple[str, str, float]] | None = None,
        codecs: Sequence[tuple[str, str, float]] | None = None,
        local_epochs: Any = None,
        aggregator: int = 6,
    ) -> "ScenarioGrid":
        """Cross topology x (protocol, mode) x seeds x lrs [x participation
        x sampling policy x codec] into one grid.

        Args:
          networks: (label, Network) pairs, one per static topology point.
          schedules: (label, schedule) pairs, one per time-varying point; a
            schedule is a (T, V, V) link_eps stack, a sequence of Networks
            or one Network (T = 1).  With any schedule present every
            topology point is promoted to the common time axis (the longest
            T, a multiple of each; tiling is exact).
          protocols: (protocol, mode) string pairs (PROTOCOL_IDS / MODE_IDS).
          seeds: model-init + channel seeds.
          lrs: local step sizes.
          participation: optional (label, mask) axis; a mask is (N,), (T, N)
            (see `sampling_schedule`) or None (all ones).
          sampling_policies: optional closed-loop (label, policy,
            select_frac) axis (`core.selection.POLICY_IDS`); a
            ``participation`` axis is then the availability base.
          codecs: optional (label, codec, ratio) axis
            (`core.compression.CODEC_IDS`, ratio in (0, 1]).
          local_epochs: optional (N,) per-client epoch vector shared by
            every grid point (values clip to the simulator's bound).
          aggregator: C-FL star center (shared; read by cfl scenarios only).

        Raises ValueError on duplicate labels: `GridResult.result(label)`
        must never be ambiguous.
        """
        seeds = list(seeds)
        lrs = list(lrs)
        if not networks and not schedules:
            raise ValueError("need at least one network or schedule")

        def schedule_links(sched) -> np.ndarray:
            if isinstance(sched, topology.Network):
                return np.asarray(sched.link_eps, np.float32)[None]
            if isinstance(sched, (list, tuple)):
                return np.stack(
                    [np.asarray(s.link_eps, np.float32) for s in sched]
                )
            arr = np.asarray(sched, np.float32)
            if arr.ndim == 2:
                arr = arr[None]
            if arr.ndim != 3 or arr.shape[-1] != arr.shape[-2]:
                raise ValueError(
                    f"schedule must be (T, V, V), got shape {arr.shape}"
                )
            return arr

        topo_axis: list[tuple[str, np.ndarray]] = [
            (lbl, np.asarray(net.link_eps, np.float32))
            for lbl, net in networks
        ] + [(lbl, schedule_links(sched)) for lbl, sched in schedules]
        pkt_bits = {net.packet_len_bits for _, net in networks
                    if net.packet_len_bits is not None}
        for _, sched in schedules:
            nets = ([sched] if isinstance(sched, topology.Network)
                    else sched if isinstance(sched, (list, tuple)) else ())
            pkt_bits |= {s.packet_len_bits for s in nets
                         if isinstance(s, topology.Network)
                         and s.packet_len_bits is not None}
        v_max = max(links.shape[-1] for _, links in topo_axis)
        if schedules:
            t_max = max(links.shape[0] for _, links in topo_axis
                        if links.ndim == 3)
            topo_axis = [
                (lbl,
                 _tile_schedule(links if links.ndim == 3 else links[None],
                                t_max, f"topology schedule {lbl!r}"))
                for lbl, links in topo_axis
            ]
        topo_axis = [(lbl, _pad_link_eps(links, v_max))
                     for lbl, links in topo_axis]

        if participation is not None:
            masks = [np.asarray(m, np.float32) for _, m in participation
                     if m is not None]
            if not masks:
                raise ValueError(
                    "participation axis needs at least one non-None mask"
                )
            n_ref = masks[0].shape[-1]
            t_part = 1
            for m in masks:
                if m.ndim == 2:
                    t_part = max(t_part, m.shape[0])
            part_axis = []
            for lbl, m in participation:
                if m is None:
                    m = np.ones((1, n_ref), np.float32)
                m = np.asarray(m, np.float32)
                if m.ndim == 1:
                    m = m[None]
                part_axis.append(
                    (lbl, _normalize_participation(m[None], n_ref,
                                                   t_part)[0])
                )
        else:
            part_axis = [(None, None)]

        if sampling_policies is not None:
            if not sampling_policies:
                raise ValueError(
                    "sampling_policies axis needs at least one point"
                )
            pol_axis = []
            for pol_label, policy, frac in sampling_policies:
                if policy not in selection.POLICY_IDS:
                    raise ValueError(
                        f"unknown sampling policy {policy!r}: choose from "
                        f"{sorted(selection.POLICY_IDS)}"
                    )
                if not 0.0 < float(frac) <= 1.0:
                    raise ValueError(
                        f"select_frac must be in (0, 1], got {frac}"
                    )
                pol_axis.append((
                    pol_label,
                    np.asarray(selection.POLICY_IDS[policy], np.int32),
                    np.asarray(frac, np.float32),
                ))
        else:
            pol_axis = [(None, None, None)]

        if codecs is not None:
            if not codecs:
                raise ValueError("codecs axis needs at least one point")
            cod_axis = []
            for cod_label, codec, ratio in codecs:
                if codec not in compression.CODEC_IDS:
                    raise ValueError(
                        f"unknown codec {codec!r}: choose from "
                        f"{sorted(compression.CODEC_IDS)}"
                    )
                if not 0.0 < float(ratio) <= 1.0:
                    raise ValueError(
                        f"compress ratio must be in (0, 1], got {ratio}"
                    )
                cod_axis.append((
                    cod_label,
                    np.asarray(compression.CODEC_IDS[codec], np.int32),
                    np.asarray(ratio, np.float32),
                ))
        else:
            cod_axis = [(None, None, None)]

        epochs_vec = (None if local_epochs is None
                      else np.asarray(local_epochs, np.int32))

        rows, labels = [], []
        for (net_label, links), (proto, mode), seed, lr, (part_label, mask), \
                (pol_label, pol_id, frac), (cod_label, cod_id, cod_ratio) \
                in itertools.product(topo_axis, protocols, seeds, lrs,
                                     part_axis, pol_axis, cod_axis):
            rows.append(simulator.Scenario(
                link_eps=links,
                seed=np.asarray(seed, np.int32),
                protocol_id=np.asarray(PROTOCOL_IDS[proto], np.int32),
                mode_id=np.asarray(MODE_IDS[mode], np.int32),
                aggregator=np.asarray(aggregator, np.int32),
                lr=np.asarray(lr, np.float32),
                participation=mask,
                local_epochs=epochs_vec,
                policy_id=pol_id,
                select_frac=frac,
                codec_id=cod_id,
                compress_ratio=cod_ratio,
            ))
            parts = [net_label, f"{proto}+{mode}"]
            if len(seeds) > 1:
                parts.append(f"s{seed}")
            if len(lrs) > 1:
                parts.append(f"lr{lr:g}")
            if part_label is not None and len(part_axis) > 1:
                parts.append(part_label)
            if pol_label is not None and len(pol_axis) > 1:
                parts.append(pol_label)
            if cod_label is not None and len(cod_axis) > 1:
                parts.append(cod_label)
            labels.append("/".join(parts))
        if len(set(labels)) != len(labels):
            dups = [l for l, c in Counter(labels).items() if c > 1]
            raise ValueError(
                f"duplicate scenario labels {dups}: give each axis point a "
                "distinct label"
            )
        return ScenarioGrid(scenarios=_stack_leaves(rows, np.stack),
                            labels=labels,
                            packet_len_bits=tuple(sorted(pkt_bits)))


@dataclasses.dataclass
class GridResult:
    """Stacked per-scenario trajectories of one grid run.

    With eval thinning (``SimConfig.eval_every=k``) acc/loss carry
    ``rounds // k`` rows (row j = round ``(j + 1) * k - 1``); ``bias``
    stays per-round.  Closed-loop grids also carry ``selected``, the
    realized per-round participation masks (None for open-loop grids).
    """

    acc: np.ndarray        # (G, evals, N)  test accuracy
    loss: np.ndarray       # (G, evals, N)  train loss
    bias: np.ndarray       # (G, rounds)    mean ||Lambda_l||_F^2 (ra only)
    labels: list[str]
    selected: np.ndarray | None = None   # (G, rounds, N) realized masks

    def __len__(self) -> int:
        return len(self.labels)

    @property
    def mean_acc(self) -> np.ndarray:
        """(G, rounds) accuracy averaged across clients."""
        return self.acc.mean(axis=2)

    @property
    def selected_frac(self) -> np.ndarray | None:
        """(G, rounds) realized participation fraction (closed loop only)."""
        return None if self.selected is None else self.selected.mean(axis=2)

    def result(self, key: int | str) -> simulator.SimResult:
        """One scenario's trajectory as a scalar SimResult.

        A string key must match exactly one label: a missing or an
        ambiguous label raises KeyError.
        """
        if isinstance(key, str):
            hits = [i for i, lbl in enumerate(self.labels) if lbl == key]
            if not hits:
                raise KeyError(f"no scenario labeled {key!r}")
            if len(hits) > 1:
                raise KeyError(
                    f"label {key!r} is ambiguous: {len(hits)} scenarios "
                    "carry it (index by position instead)"
                )
            i = hits[0]
        else:
            i = key
        return simulator.SimResult(
            acc_per_client=self.acc[i],
            loss_per_client=self.loss[i],
            bias_norms=self.bias[i],
        )

    def items(self):
        return ((lbl, self.result(i)) for i, lbl in enumerate(self.labels))


def _metrics_to_grid_result(metrics: dict, labels: list[str]) -> GridResult:
    return GridResult(
        acc=np.asarray(metrics["acc"]),
        loss=np.asarray(metrics["loss"]),
        bias=np.asarray(metrics["bias"]),
        labels=list(labels),
        selected=(np.asarray(metrics["selected"])
                  if "selected" in metrics else None),
    )


def _batch_uniform(arr: np.ndarray) -> bool:
    """True if every batch row equals row 0, NaN-tolerantly (NaN placed
    equally in every row counts as uniform)."""
    first = np.broadcast_to(arr[:1], arr.shape)
    if arr.dtype.kind in "fc":
        return bool(np.array_equal(arr, first, equal_nan=True))
    return bool(np.array_equal(arr, first))


def _hoist_uniform(batch: simulator.Scenario):
    """Split a scenario batch into (in_axes, args): a leaf constant across
    the batch is hoisted out of the vmap (axis None, its leaf row 0), the
    others stay batched (axis 0).  ``seed`` always stays batched.  Pure
    host work on the numpy leaves."""
    axes, args = {}, {}
    for name, leaf in batch._asdict().items():
        if leaf is None:
            axes[name], args[name] = None, None
            continue
        arr = np.asarray(leaf)
        if name != "seed" and _batch_uniform(arr):
            axes[name], args[name] = None, arr[0]
        else:
            axes[name], args[name] = 0, leaf
    return simulator.Scenario(**axes), simulator.Scenario(**args)


class AdmissionError(ValueError):
    """A scenario grid failed admission-time validation: raised by
    `validate_grid` / `GridRunner.validate` with a message naming the
    offending scenario labels."""


def _aval_sig(tree: simulator.Scenario) -> tuple:
    """Shape / dtype signature of a scenario batch (host metadata only):
    part of the program-cache key."""
    sig = []
    for name, leaf in tree._asdict().items():
        if leaf is None:
            sig.append((name, None))
        else:
            dt = getattr(leaf, "dtype", None)
            if dt is None:                          # plain python scalar
                dt = np.asarray(leaf).dtype
            sig.append((name, tuple(np.shape(leaf)), str(dt)))
    return tuple(sig)


def _bucket_target(g: int, pad_to) -> int:
    """The padded batch size for a ``g``-scenario group.

    ``pad_to`` declares warm batch buckets (an int or a sequence of
    ints): a group pads up to the smallest bucket >= g, and a group larger
    than every bucket to the next multiple of the largest.  ``None``
    disables padding.
    """
    if pad_to is None:
        return g
    buckets = sorted({int(b) for b in
                      ((pad_to,) if isinstance(pad_to, int) else pad_to)})
    if not buckets or buckets[0] < 1:
        raise ValueError(f"pad_to buckets must be positive ints, got {pad_to}")
    for b in buckets:
        if b >= g:
            return b
    top = buckets[-1]
    return -(-g // top) * top


class ProgramCache:
    """Bounded LRU cache of built grid programs.

    A program here is the batched callable for one (hoist signature,
    shapes) key: `SimPrograms.run_scenario_batch` bound to the group's
    axes, its kernel built (nvcc) on the card.  The least-recently-used
    entry beyond ``max_programs`` is evicted; hits / misses / evictions
    are counted on the attached tracker (``cache/hit`` / ``cache/miss`` /
    ``cache/evict``) and in `stats`.  ``max_programs=None`` means
    unbounded.  Not thread-safe: callers serialize dispatch on one thread.
    """

    def __init__(self, max_programs: int | None = None,
                 tracker: launch_tracker.Tracker | None = None):
        if max_programs is not None and max_programs < 1:
            raise ValueError(
                f"max_programs must be >= 1 or None, got {max_programs}"
            )
        self.max_programs = max_programs
        self._entries: OrderedDict = OrderedDict()
        self._tracker = tracker or launch_tracker.NullTracker()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def stats(self) -> dict[str, int]:
        return {"programs": len(self._entries), "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions}

    def lookup(self, key, build: Callable[[], Any]):
        """The cached program for ``key``, building (and possibly
        evicting) on a miss."""
        entry = self._entries.get(key)
        if entry is not None:
            self._entries.move_to_end(key)
            self.hits += 1
            self._tracker.count("cache/hit")
            return entry
        self.misses += 1
        self._tracker.count("cache/miss")
        entry = build()
        self._entries[key] = entry
        while (self.max_programs is not None
               and len(self._entries) > self.max_programs):
            self._entries.popitem(last=False)
            self.evictions += 1
            self._tracker.count("cache/evict")
        return entry

    def clear(self) -> None:
        self._entries.clear()


def validate_grid(grid: ScenarioGrid, *, n_clients: int | None = None,
                  seg_len: int | None = None,
                  strict_packet: bool = False) -> None:
    """Admission-time structural validation of a scenario grid.

    Checks leaf ranks and batch-axis consistency, link matrices square /
    finite / within [0, 1], protocol / mode / policy / codec ids in range,
    participation and epoch client counts against the bound dataset,
    fractions and ratios in (0, 1], unique labels, and with
    ``strict_packet`` the PER packet length against the codec segment
    (`simulator.check_packet_len`) as a hard error.  Raises
    `AdmissionError` naming the offending scenario labels, with the
    reference's messages; host-side numpy.
    """
    s = grid.scenarios
    g = len(grid.labels)

    def name_rows(mask) -> str:
        idx = np.nonzero(np.asarray(mask))[0]
        shown = ", ".join(f"{i}:{grid.labels[i]!r}" for i in idx[:3])
        more = f" (+{len(idx) - 3} more)" if len(idx) > 3 else ""
        return shown + more

    def fail(msg: str) -> None:
        raise AdmissionError(f"grid rejected: {msg}")

    le = np.asarray(s.link_eps)
    if le.ndim not in (3, 4):
        fail(f"link_eps must be (G, V, V) or (G, T, V, V), got {le.shape}")
    if le.shape[0] != g:
        fail(f"{g} labels but {le.shape[0]} link_eps rows")
    if le.shape[-1] != le.shape[-2]:
        fail(f"link matrices must be square, got {le.shape}")
    bad = ~np.isfinite(le).reshape(g, -1).all(axis=1)
    if bad.any():
        fail(f"non-finite link_eps in scenario(s) {name_rows(bad)}")
    bad = ((le < 0) | (le > 1)).reshape(g, -1).any(axis=1)
    if bad.any():
        fail(f"link_eps outside [0, 1] in scenario(s) {name_rows(bad)}")

    for field, n_ids, ids in (
        ("protocol_id", len(PROTOCOL_IDS), PROTOCOL_IDS),
        ("mode_id", len(MODE_IDS), MODE_IDS),
    ):
        arr = np.asarray(getattr(s, field))
        if arr.shape != (g,):
            fail(f"{field} must be ({g},), got {arr.shape}")
        bad = (arr < 0) | (arr >= n_ids)
        if bad.any():
            fail(f"{field} out of range [0, {n_ids}) in scenario(s) "
                 f"{name_rows(bad)} — known ids: {sorted(ids)}")

    lr = np.asarray(s.lr)
    bad = ~np.isfinite(lr).reshape(g, -1).all(axis=1)
    if bad.any():
        fail(f"non-finite lr in scenario(s) {name_rows(bad)}")

    if s.participation is not None:
        part = np.asarray(s.participation)
        if part.ndim not in (2, 3) or part.shape[0] != g:
            fail(f"participation must be (G, N) or (G, T, N) with G={g}, "
                 f"got {part.shape}")
        if n_clients is not None and part.shape[-1] != n_clients:
            fail(f"participation covers {part.shape[-1]} clients but the "
                 f"bound dataset has {n_clients}")
        flat = part.reshape(g, -1)
        bad = ~(np.isfinite(flat) & (flat >= 0) & (flat <= 1)).all(axis=1)
        if bad.any():
            fail(f"participation outside [0, 1] in scenario(s) "
                 f"{name_rows(bad)}")

    if s.local_epochs is not None:
        ep = np.asarray(s.local_epochs)
        if n_clients is not None and ep.shape[-1] != n_clients:
            fail(f"local_epochs covers {ep.shape[-1]} clients but the "
                 f"bound dataset has {n_clients}")
        bad = (ep.reshape(g, -1) < 0).any(axis=1)
        if bad.any():
            fail(f"negative local_epochs in scenario(s) {name_rows(bad)}")

    if s.policy_id is not None:
        pol = np.asarray(s.policy_id)
        n_pol = len(selection.POLICY_IDS)
        bad = (pol < 0) | (pol >= n_pol)
        if bad.any():
            fail(f"policy_id out of range [0, {n_pol}) in scenario(s) "
                 f"{name_rows(bad)} — known policies: "
                 f"{sorted(selection.POLICY_IDS)}")
        frac = np.asarray(s.select_frac)
        bad = ~(np.isfinite(frac) & (frac > 0) & (frac <= 1))
        if bad.any():
            fail(f"select_frac outside (0, 1] in scenario(s) "
                 f"{name_rows(bad)}")

    if s.codec_id is not None:
        cod = np.asarray(s.codec_id)
        n_cod = len(compression.CODEC_IDS)
        bad = (cod < 0) | (cod >= n_cod)
        if bad.any():
            fail(f"codec_id out of range [0, {n_cod}) in scenario(s) "
                 f"{name_rows(bad)} — known codecs: "
                 f"{sorted(compression.CODEC_IDS)}")
        ratio = np.asarray(s.compress_ratio)
        bad = ~(np.isfinite(ratio) & (ratio > 0) & (ratio <= 1))
        if bad.any():
            fail(f"compress_ratio outside (0, 1] in scenario(s) "
                 f"{name_rows(bad)}")

    dup = [lbl for lbl, c in Counter(grid.labels).items() if c > 1]
    if dup:
        fail(f"duplicate labels {dup[:3]} — results would be ambiguous")

    if strict_packet and seg_len is not None:
        for bits in getattr(grid, "packet_len_bits", ()):
            try:
                simulator.check_packet_len(bits, seg_len, strict=True)
            except ValueError as e:
                raise AdmissionError(f"grid rejected: {e}") from None


def names_one_device(devices) -> bool:
    """Whether a ``devices=`` value names one device: None, a device (or
    its name), the count 1, or a one-element sequence (of devices or of
    ranks).  Such a call runs the single-device engine."""
    if devices is None or isinstance(devices, (str, torch.device)):
        return True
    if isinstance(devices, int) and not isinstance(devices, bool):
        return devices == 1
    return (isinstance(devices, (list, tuple, range, np.ndarray))
            and len(devices) == 1)


def _resolve_grid_mesh(devices, sharding, device: torch.device, *,
                       private: bool = False) -> launch_mesh.Mesh | None:
    """Normalize the ``devices=`` / ``sharding=`` knobs into a mesh.

    ``sharding`` wins over ``devices``; it is a `launch.mesh.Mesh`, 1-D or
    2-D ``('grid', 'model')``, on this runner's device.  ``devices`` is
    anything `launch.mesh.grid_mesh` takes (an int count, a list of ranks,
    None), or a ``(spec, model_shards)`` tuple building a 2-D
    `launch.mesh.grid_model_mesh`; a value naming one device gives None
    (the single-device engine).  ``private`` builds the mesh from
    ``devices`` with groups of its own (`launch.mesh.grid_mesh`).
    """
    if sharding is not None:
        if not isinstance(sharding, launch_mesh.Mesh):
            raise TypeError(f"sharding= must be a launch.mesh.Mesh, got "
                            f"{type(sharding).__name__}")
        names = sharding.axis_names
        if len(names) == 2:
            if tuple(names) != (launch_mesh.GRID_AXIS,
                                launch_mesh.MODEL_AXIS):
                raise ValueError(
                    "2-D grid sharding needs axes "
                    f"('{launch_mesh.GRID_AXIS}', "
                    f"'{launch_mesh.MODEL_AXIS}'), got {names} "
                    "(see launch.mesh.grid_model_mesh)"
                )
        elif len(names) != 1:
            raise ValueError("grid sharding needs a 1-D or 2-D mesh, got "
                             f"axes {names}")
        d = sharding.device           # "cuda" names the current card
        if d.type != device.type or (
                None not in (d.index, device.index)
                and d.index != device.index):
            raise ValueError(f"the mesh's device {d} is not the runner's "
                             f"{device}")
        return sharding
    if (isinstance(devices, tuple) and len(devices) == 2
            and isinstance(devices[1], int)
            and not isinstance(devices[1], bool)):
        spec, model_shards = devices
        if model_shards == 1 and names_one_device(spec):
            return None
        return launch_mesh.grid_model_mesh(spec, model_shards=model_shards,
                                           device=device, private=private)
    if names_one_device(devices):
        return None
    if not isinstance(devices, int) and any(
            isinstance(d, (str, torch.device)) for d in devices):
        raise ValueError(
            f"devices={devices!r}: a multi-rank grid names ranks (one "
            "process each, launch.mesh.spawn), not devices")
    return launch_mesh.grid_mesh(devices, device=device, private=private)


def _take_rows(batch: simulator.Scenario, axes: simulator.Scenario,
               rows: slice) -> simulator.Scenario:
    """The rows ``rows`` of a hoisted batch: mapped leaves sliced, hoisted
    leaves kept."""
    return simulator.Scenario(**{
        name: leaf[rows] if getattr(axes, name) == 0 else leaf
        for name, leaf in batch._asdict().items()})


class GridRunner:
    """Scenario-grid runner: bind once, run many grids.

    Binds (init, apply, data, statics) into one `simulator.SimPrograms` on
    this rank's device (one more per model-sharded mesh) and caches a
    built program per (hoist signature, [mesh,] shapes) key in a bounded
    LRU (`ProgramCache`; ``max_cached_programs``), so
    repeated `run()` calls on same-shaped grids rebuild nothing.
    `warmup` builds the declared shapes' programs ahead of traffic;
    `validate` rejects malformed grids at admission (`AdmissionError`).

    Args:
      init_fn: model init, ``CPU generator -> params``; each scenario's
        generator is seeded with its seed.
      apply_fn: forward pass, ``(params, x) -> logits``.
      data: the shared `FederatedDataset`.
      cfg: the static knobs (seg_len, local_epochs, n_rounds, aayg_mixes,
        agg_impl, eval_every, track_bias, local_optimizer); its
        per-scenario fields are ignored.
      device: where the grids run, as `simulator.build_sim` takes it
        (default: the CUDA card); on a mesh, this rank's device.
      devices / sharding: the default spread of `run` over ranks (see
        `_resolve_grid_mesh`; None: one device).
      tracker: metrics sink for cache counters and batch fill ratios.
      max_cached_programs: LRU bound of the program cache (None:
        unbounded).
    """

    def __init__(
        self,
        init_fn: Callable[[torch.Generator], dict],
        apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
        data: FederatedDataset,
        cfg: simulator.SimConfig,
        *,
        device: str | torch.device | None = None,
        devices: Any = None,
        sharding: Any = None,
        tracker: launch_tracker.Tracker | None = None,
        max_cached_programs: int | None = None,
    ):
        dev = resolve_device(device)

        def build(model_shards=1, mesh=None):
            return simulator.build_sim(
                init_fn, apply_fn, data,
                seg_len=cfg.seg_len, local_epochs=cfg.local_epochs,
                n_rounds=cfg.n_rounds, aayg_mixes=cfg.aayg_mixes,
                agg_impl=cfg.agg_impl, eval_every=cfg.eval_every,
                track_bias=cfg.track_bias,
                local_optimizer=cfg.local_optimizer, device=dev,
                model_shards=model_shards, mesh=mesh)

        self._build_sim = build
        self.sim = build()
        # One sim per model-sharded mesh (its model group and window).
        self._sims: dict[tuple, simulator.SimPrograms] = {}
        self.devices = devices
        self.sharding = sharding
        self.tracker = tracker or launch_tracker.NullTracker()
        self._seg_len = cfg.seg_len
        self.programs = ProgramCache(max_cached_programs,
                                     tracker=self.tracker)

    def validate(self, grid: ScenarioGrid, *,
                 strict_packet: bool = False) -> None:
        """Admission-time validation against this runner's binding (client
        count, codec segment size); see `validate_grid`."""
        validate_grid(grid, n_clients=self.sim.n_clients,
                      seg_len=self._seg_len, strict_packet=strict_packet)

    def _sim_for(self, mesh: launch_mesh.Mesh) -> simulator.SimPrograms:
        """The sim of this rank's share on ``mesh``: the runner's own on a
        mesh without a model axis (or of model size 1), else one bound to
        the model group."""
        dm = mesh.shape.get(launch_mesh.MODEL_AXIS, 1)
        if dm == 1:
            return self.sim
        key = launch_mesh.mesh_fingerprint(mesh)
        sim = self._sims.get(key)
        if sim is None:
            sim = self._sims[key] = self._build_sim(dm, mesh)
        return sim

    def _mesh(self, devices, sharding) -> launch_mesh.Mesh | None:
        return _resolve_grid_mesh(
            self.devices if devices is _INHERIT else devices,
            self.sharding if sharding is None else sharding,
            self.sim.device)

    def _index_groups(self, grid: ScenarioGrid) -> list[list[int]]:
        """The dispatch partition: rows that share every discrete id
        (protocol, mode, aggregator, codec, policy)."""
        s = grid.scenarios
        keys = [np.asarray(getattr(s, name)) for name in simulator.BATCH_IDS
                if getattr(s, name) is not None]
        groups: dict[tuple, list[int]] = {}
        for i in range(len(grid)):
            groups.setdefault(tuple(int(k[i]) for k in keys), []).append(i)
        return list(groups.values())

    def _groups(self, grid: ScenarioGrid, pad_to):
        """(row indices, padded sub-batch) per dispatch group."""
        for idx in self._index_groups(grid):
            with span("dfl:prepare"):
                sub = grid.take(idx).scenarios
                target = _bucket_target(len(idx), pad_to)
                if target != len(idx):
                    sub = _pad_scenario_batch(sub, target)
            yield idx, sub

    def run(self, grid: ScenarioGrid, *,
            devices: Any = _INHERIT,
            sharding: Any = None,
            pad_to: int | Sequence[int] | None = None,
            validate: bool = True) -> GridResult:
        """Run the whole grid, one batched program per group.

        Each group (`_index_groups`) runs `SimPrograms.run_scenario_batch`:
        every round of it one local-training pass over the group's G * N
        clients and one K1 launch of B = G (R&A; J for AaYG).  ``pad_to``
        declares warm batch buckets: a group is padded with
        routing-neutral filler rows (`_pad_scenario_batch`) up to the
        smallest bucket that fits (`_bucket_target`), and the filler rows
        are dropped.  ``validate=False`` skips admission validation.

        ``devices`` / ``sharding`` (default: the runner's) spread the grid
        over a mesh of ranks (module docstring): every rank of the mesh
        calls `run` with the same grid and gets the whole result; a rank
        of the default group outside the mesh builds it with the others
        and returns None.  When a rank's share raises, every rank of the
        mesh raises `launch.mesh.RankFailed` naming that rank, and the
        mesh stays usable, unless a collective of a model group failed
        there: then the mesh is broken and later runs on it raise
        `launch.mesh.MeshBroken`.
        """
        with span("dfl:prepare"):
            mesh = self._mesh(devices, sharding)
            if mesh is not None:
                mesh.check()
            for bits in getattr(grid, "packet_len_bits", ()):
                simulator.check_packet_len(
                    bits, self._seg_len,
                    bits_per_value=self.sim.bits_per_value)
            if validate:
                self.validate(grid)
        if mesh is not None and mesh.coords is None:
            return None
        rows: list[dict | None] = [None] * len(grid)
        for idx, sub in self._groups(grid, pad_to):
            with span("dfl:prepare"):
                self.tracker.observe("grid/batch_fill",
                                     len(idx) / sub.link_eps.shape[0])
                if mesh is None:
                    program, args = self._program_vmap(sub)
                else:
                    program, args = self._program_sharded(sub, mesh)
            metrics = program(args)
            with span("dfl:fetch"):
                for j, i in enumerate(idx):   # filler rows dropped
                    rows[i] = {k: v[j] for k, v in metrics.items()}
        with span("dfl:fetch"):
            stacked = {k: torch.stack([r[k] for r in rows])
                       for k in rows[0]}
            return _metrics_to_grid_result(stacked, grid.labels)

    def warmup(self, grid: ScenarioGrid, *,
               devices: Any = _INHERIT,
               sharding: Any = None,
               pad_to: int | Sequence[int] | None = None) -> int:
        """Build every program `run()` would need for this grid without
        running it (on the card this builds K1 too); returns the number of
        programs built (0 when everything was warm)."""
        mesh = self._mesh(devices, sharding)
        misses0 = self.programs.misses
        for _idx, sub in self._groups(grid, pad_to):
            if mesh is None:
                self._program_vmap(sub)
            elif mesh.coords is not None:
                self._program_sharded(sub, mesh)
        return self.programs.misses - misses0

    def _program_vmap(self, sub: simulator.Scenario):
        """The program for this sub-batch's hoist signature and shapes,
        and its arguments."""
        axes, args = _hoist_uniform(sub)
        sig = ("vmap", tuple(axes._asdict().items()), _aval_sig(args))
        sim = self.sim

        def build():
            if sim.device.type == "cuda":
                ops.load_library("ra_aggregate")
            return lambda batch: sim.run_scenario_batch(
                sim.prepare_batch(batch, axes))

        return self.programs.lookup(sig, build), args

    def _program_sharded(self, sub: simulator.Scenario,
                         mesh: launch_mesh.Mesh):
        """The multi-rank program for this sub-batch on ``mesh``, and its
        arguments.

        The sub-batch is padded to a multiple of the grid axis (a mesh
        wider than it shrinks to its first g grid rows, every model shard
        of each kept); grid row r runs rows ``[r * per, (r + 1) * per)``
        with its sim (`_sim_for`: model-sharded on a 2-D mesh), and every
        rank of the mesh gets every row's metrics (model shard 0 of each
        grid row hands them in; the shards' metrics are the same), or
        every rank raises `launch.mesh.RankFailed` when a rank's share
        raised (`launch.mesh.gather_or_raise`, its model group's
        collectives guarded).  The program is cached per
        hoist signature, shrunk mesh and shapes; every rank of the mesh
        must call it.
        """
        sim = self._sim_for(mesh)
        g = sub.link_eps.shape[0]
        shrunk = mesh.first_rows(g)
        d = shrunk.shape[launch_mesh.GRID_AXIS]
        sub = _pad_scenario_batch(sub, -(-g // d) * d)
        axes, args = _hoist_uniform(sub)
        sig = ("shard", tuple(axes._asdict().items()),
               launch_mesh.mesh_fingerprint(shrunk), _aval_sig(args))
        # The model group a share's collectives run on, guarded so that a
        # shard failing alone releases its peers (`gather_or_raise`).
        peers = (shrunk.axis_group(launch_mesh.MODEL_AXIS)[0]
                 if shrunk.coords is not None
                 and shrunk.shape.get(launch_mesh.MODEL_AXIS, 1) > 1
                 else None)

        def build():
            if sim.device.type == "cuda":
                ops.load_library("ra_aggregate")

            def program(batch):
                per = len(batch.seed) // d        # the seed is mapped

                def share():
                    if shrunk.coords is None:
                        return None
                    r = shrunk.coords[launch_mesh.GRID_AXIS]
                    out = sim.run_scenario_batch(sim.prepare_batch(
                        _take_rows(batch, axes, slice(r * per,
                                                      (r + 1) * per)),
                        axes))
                    if shrunk.coords.get(launch_mesh.MODEL_AXIS, 0) != 0:
                        return None
                    return (r, {k: v.numpy() for k, v in out.items()})

                parts = dict(p for p in launch_mesh.gather_or_raise(
                    share, mesh.group, peers=peers, mesh=mesh)
                    if p is not None)
                return {k: torch.cat([torch.from_numpy(parts[r][k])
                                      for r in range(d)])
                        for k in parts[0]}

            return program

        return self.programs.lookup(sig, build), args

    def run_sequential(self, grid: ScenarioGrid) -> GridResult:
        """Per-scenario baseline: `SimPrograms.run_scenario` once per grid
        row, the same round with the same draws (the timing baseline and
        the equivalence check of `run`)."""
        metrics = [self.sim.run_scenario(grid.scenario(i))
                   for i in range(len(grid))]
        stacked = {k: torch.stack([m[k] for m in metrics])
                   for k in metrics[0]}
        return _metrics_to_grid_result(stacked, grid.labels)


def run_grid(
    init_fn: Callable[[torch.Generator], dict],
    apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    data: FederatedDataset,
    grid: ScenarioGrid,
    cfg: simulator.SimConfig,
    *,
    device: str | torch.device | None = None,
    devices: Any = None,
    sharding: Any = None,
) -> GridResult:
    """One-shot batched grid run (see `GridRunner.run`) on ``device``
    (default: the card), over the ranks ``devices`` / ``sharding`` name
    (None: one device).  ``cfg`` supplies the static knobs."""
    runner = GridRunner(init_fn, apply_fn, data, cfg, device=device,
                        devices=devices, sharding=sharding)
    return runner.run(grid)


def run_sequential(
    init_fn: Callable[[torch.Generator], dict],
    apply_fn: Callable[[dict, torch.Tensor], torch.Tensor],
    data: FederatedDataset,
    grid: ScenarioGrid,
    cfg: simulator.SimConfig,
    *,
    device: str | torch.device | None = None,
) -> GridResult:
    """One-shot per-scenario baseline (see `GridRunner.run_sequential`)."""
    runner = GridRunner(init_fn, apply_fn, data, cfg, device=device)
    return runner.run_sequential(grid)
