"""Meshes of `torch.distributed` ranks: the scenario grid's ('grid',) and
('grid', 'model') meshes, the collectives the multi-rank path runs,
`spawn`, which starts one process per rank, and the production mesh of
the dry run with the card's roofline constants.

Port of the reference package's `launch/mesh.py`.  `make_production_mesh`
builds the (16, 16) / (2, 16, 16) mesh as a `DeviceMesh` over a fake
process group (`launch.dryrun`); the rest is the grid half.  JAX
drives a mesh from one controller; `torch.distributed` runs one process
per rank, so the port is SPMD: every rank calls the same entry point
(`fl.scenarios.run_grid`, `checkpoint.run_resumable`,
`core.dfl_step.ra_exchange`), computes its share and returns the result
the reference's single controller returns.

  * `grid_mesh` — a 1-D ``('grid',)`` mesh: each rank runs its slice of a
    batched scenario sweep, with no collective in the round loop.
  * `grid_model_mesh` — the 2-D ``('grid', 'model')`` mesh: the model axis
    also splits each scenario's segment axis over the ranks of one
    model-sharding group, whose collectives (the all-gather of the full
    segment rows before local training) stay inside that group.

A `Mesh` holds the ranks laid out on its axes, this rank's device and
coordinates, a process group over all its ranks and one along the model
axis through this rank.  Building one creates process groups, which is
collective: every rank of the default group calls the builder, with the
same arguments, in the same order (ranks outside the mesh get a `Mesh`
whose ``coords`` is None).  Meshes are cached by (axes, ranks), so
building the same mesh again creates nothing.

A private mesh (``private=True``) is built anew each time, with groups of
its own and a command group (`broadcast_command`) that its first rank,
the leader, sends on.  A `launch.serving.ScenarioServer` over ranks takes
one, so two servers over the same ranks (a router's replicas, which
dispatch from two threads at once) never share a group: collectives on
one group must come in the same order on every rank, which two threads
of one process cannot promise, while two groups run side by side.  (One
channel that serialized every dispatch of the process would also keep the
order, but it would serialize the replicas too.)

`gather_or_raise` is the mesh's fault containment: each rank hands in its
share's result or its error, so every rank finishes the collective, and
then every rank raises the same `RankFailed`, naming the rank it came
from, instead of the others waiting out the group's timeout.  Given the
share's ``peers`` (a grid row's model group), it also guards the
collectives the share runs on that group: each is preceded by a one-int
status all-reduce, which a rank whose share raised joins once with its
failure, so a model shard that fails alone releases the peer that waits
for it (`PeerFailed`) instead of leaving it in their all-gather.  A
collective that fails on one rank while its peers are inside it holds
them until the group's timeout, which a private mesh bounds for its model
groups (`MODEL_GROUP_TIMEOUT`); then every rank raises `RankFailed` naming
the rank that failed, and the mesh, whose broken group is never used
again, refuses later steps (`Mesh.check`, `MeshBroken`).

Collectives: `all_to_all`, `reduce_scatter`, `all_reduce`, `all_gather`
and `gather_along` wrap `torch.distributed` and count the bytes each rank
hands to them (`WIRE_BYTES`).  The backend is the caller's: NCCL needs one
card per rank; ranks that share a card (the one H100) or run on the CPU
use gloo.  gloo in torch 2.11 runs all four on CUDA tensors (it copies
them through host memory itself; chip_smoke.py's phase 24 checks each on
the card), so no collective here stages its operands, and none switches
route on failure.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .. import resolve_device

# Roofline constants of the card, per GPU: NVIDIA's published figures for
# the H100 SXM 80GB (HBM3, 700 W), the card of every chip run so far; not
# measured here.  Named as the reference's TPU constants are, for
# `launch.dryrun`'s roofline terms.
PEAK_FLOPS_BF16 = 989e12       # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12               # bytes/s, HBM3
# The link rate (the reference's ICI_BW): the production mesh's 16- and
# 32-wide groups span more than one 8-GPU NVLink node, so their bound is
# the inter-node rate, one 400 Gb/s NDR InfiniBand NIC a GPU.
LINK_BW = 50e9                 # bytes/s per GPU, between nodes
# Within one node: NVLink 4, 900 GB/s a GPU both ways together.
NVLINK_BW = 450e9              # bytes/s per GPU, each direction

# The production meshes' shapes and axes (the reference's, on host devices).
_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False):
    """The multi-pod dry-run mesh as a `torch.distributed` `DeviceMesh`:
    (16, 16) = 256 ranks with axes ('data', 'model'), or (2, 16, 16) = 512
    ranks with axes ('pod', 'data', 'model').

    No 256 cards exist here, so the mesh runs over a fake process group
    (backend ``"fake"``, torch's testing `FakeStore`) in which this process
    is rank 0: collectives return at once and move nothing, and DTensor
    sharding propagation over it plays the part of GSPMD
    (`launch.dryrun`).  The fake default group is process-global state,
    created here on the first call, never on import; a call for the other
    mesh size replaces it.  A real default group that is already set up is
    never replaced: that raises.  So does a torch without the private
    ``fake_pg`` module (no fallback).
    """
    shape, axes = _PRODUCTION[bool(multi_pod)]
    world = int(np.prod(shape))
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError(
            f"make_production_mesh needs torch's fake process group "
            f"(torch.testing._internal.distributed.fake_pg), which torch "
            f"{torch.__version__} does not have") from e
    from torch.distributed.device_mesh import DeviceMesh

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"make_production_mesh: a real {dist.get_backend()!r} default "
                f"process group of {dist.get_world_size()} ranks is set up; "
                f"the production mesh runs over a fake one of {world} ranks "
                f"and will not replace it")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    return DeviceMesh("cpu", torch.arange(world).reshape(shape),
                      mesh_dim_names=axes)


def data_axes(*, multi_pod: bool = False):
    return ("pod", "data") if multi_pod else ("data",)


GRID_AXIS = "grid"
# Axis name for model-axis (segment) sharding inside each scenario: the
# axis `fl.simulator.build_sim(model_shards=)` splits the segments along.
MODEL_AXIS = "model"

# Bytes each rank handed to each collective (its input) since the last
# `reset_counters`.
WIRE_BYTES: dict[str, int] = {"all_to_all": 0, "reduce_scatter": 0,
                              "all_reduce": 0, "all_gather": 0}
_COUNT_LOCK = threading.Lock()

_NO_GROUP = ("{what} names {count} ranks, but {why}; start one process per "
             "rank with repro_torch.launch.mesh.spawn (or call "
             "torch.distributed.init_process_group in each) first")

# The device `spawn` gave this process's rank (None outside spawned ranks).
_RANK_DEVICE: torch.device | None = None


def reset_counters() -> None:
    """Zero `WIRE_BYTES`."""
    with _COUNT_LOCK:
        for k in WIRE_BYTES:
            WIRE_BYTES[k] = 0


def rank_device() -> torch.device | None:
    """The device `spawn` assigned to this rank, or None."""
    return _RANK_DEVICE


def _require_world(count: int, what: str) -> None:
    """Raise ValueError unless a default process group of at least
    ``count`` ranks is initialized."""
    if not dist.is_available() or not dist.is_initialized():
        raise ValueError(_NO_GROUP.format(
            what=what, count=count,
            why="no torch.distributed process group is initialized"))
    world = dist.get_world_size()
    if count > world:
        raise ValueError(_NO_GROUP.format(
            what=what, count=count,
            why=f"the default process group has {world}"))


def _resolve_ranks(devices: Sequence[int] | int | None, *,
                   what: str) -> list[int]:
    """Normalize a rank spec (None = every rank, int = the first k, or a
    sequence of ranks)."""
    if devices is None:
        _require_world(1, what)
        return list(range(dist.get_world_size()))
    if isinstance(devices, int) and not isinstance(devices, bool):
        if devices < 1:
            raise ValueError(f"{what}: asked for {devices} ranks")
        _require_world(devices, what)
        return list(range(devices))
    ranks = [int(r) for r in devices]
    if len(set(ranks)) != len(ranks):
        raise ValueError(f"{what}: ranks {ranks} repeat")
    _require_world(max(ranks) + 1 if ranks else 1, what)
    if not ranks or min(ranks) < 0:
        raise ValueError(f"{what}: invalid ranks {ranks}")
    return ranks


class Mesh:
    """Ranks laid out on named axes, seen from one rank.

    Attributes:
      axis_names: ``('grid',)`` or ``('grid', 'model')``.
      ranks: int array of global ranks, one axis per name.
      shape: ``{axis: size}``.
      device: this rank's device (where its tensors live).
      rank: this process's global rank.
      coords: ``{axis: index}`` of this rank, or None outside the mesh.
      group: a process group over every rank of the mesh (None outside).
      leader: the mesh's first rank (grid row 0, model shard 0).
      control: a private mesh's command group (None outside it, and on a
        shared mesh).
    """

    def __init__(self, ranks: np.ndarray, axis_names: tuple[str, ...],
                 device: torch.device, *, groups: dict, group,
                 world, control=None) -> None:
        self.ranks = ranks
        self.axis_names = axis_names
        self.shape = {nm: int(s) for nm, s in zip(axis_names, ranks.shape)}
        self.device = device
        self.rank = dist.get_rank()
        where = np.argwhere(ranks == self.rank)
        self.coords = (None if len(where) == 0 else
                       {nm: int(i) for nm, i in zip(axis_names, where[0])})
        self.group = group
        self.leader = int(ranks.flat[0])
        self.control = control
        self.broken: str | None = None   # why its model groups broke
        self._groups = groups     # axis -> (group, fiber ranks) through me
        self._world = world

    def check(self) -> None:
        """Raise `MeshBroken` if a collective of one of the mesh's model
        groups failed in an earlier step (`gather_or_raise`): that gloo
        group's ranks no longer agree on its sequence of collectives, so
        it is never used again."""
        if self.broken is not None:
            raise MeshBroken(
                f"mesh {self.ranks.tolist()} is broken: {self.broken}; "
                f"its model groups are not reused (build a new mesh)")

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        if self.coords is None:
            raise ValueError(f"rank {self.rank} is not in the mesh "
                             f"{self.ranks.tolist()}")
        return self.coords[axis]

    def axis_group(self, axis: str):
        """The process group along ``axis`` (not the grid axis, which runs
        no collective) through this rank, and the ranks of that fiber in
        coordinate order."""
        self.axis_index(axis)
        return self._groups[axis]

    def first_rows(self, rows: int) -> "Mesh":
        """The mesh of the first ``rows`` grid rows (every model shard of
        each), sharing this mesh's process groups: a mesh wider than a
        sub-batch shrinks to it, and its other ranks sit the batch out."""
        if rows >= self.shape[GRID_AXIS]:
            return self
        out = Mesh.__new__(Mesh)
        out.__dict__.update(self.__dict__)
        out.ranks = self.ranks[:rows]
        out.shape = dict(self.shape, **{GRID_AXIS: rows})
        if self.coords is not None and self.coords[GRID_AXIS] >= rows:
            out.coords = None
        return out


_MESHES: dict[tuple, Mesh] = {}

# A command group's timeout: a follower waits on it between requests, for
# as long as its server is idle.  A leader that exits closes its
# connections, which fails the wait at once.
COMMAND_TIMEOUT = datetime.timedelta(days=7)

# A private mesh's model-group timeout: the longest a rank waits inside a
# collective (or the status exchange before one, `_Guard`) of its model
# group before that collective fails.  A peer waits in the status exchange
# while its own shard trains, so the bound sits far above the longest gap
# between two guarded collectives seen on the card (27.03 s over a whole
# router run, NVIDIA H100 80GB HBM3, 700 W).  `grid_model_mesh(
# model_timeout=)` overrides it for one mesh.
MODEL_GROUP_TIMEOUT = datetime.timedelta(minutes=5)


def _new_group(ranks: list[int], *, fresh: bool = False, timeout=None):
    """A process group over ``ranks`` (collective over the default group;
    the whole world reuses the default group unless ``fresh``)."""
    if not fresh and sorted(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(sorted(ranks), timeout=timeout)


def _build(ranks: np.ndarray, axis_names: tuple[str, ...],
           device: str | torch.device | None, private: bool = False,
           model_timeout: datetime.timedelta | None = None) -> Mesh:
    dev = resolve_device(device if device is not None else _RANK_DEVICE)
    key = (axis_names, ranks.shape, tuple(ranks.flat), str(dev))
    mesh = None if private else _MESHES.get(key)
    if (mesh is not None and mesh._world is dist.group.WORLD
            and mesh.broken is None):
        return mesh
    me = dist.get_rank()
    flat = ranks.reshape(-1).tolist()
    whole = _new_group(flat, fresh=private)
    groups = {}
    for ax, name in enumerate(axis_names):
        if name == GRID_AXIS:        # scenarios: no collective along it
            continue
        moved = np.moveaxis(ranks, ax, -1).reshape(-1, ranks.shape[ax])
        for fiber in moved:          # every rank creates every fiber's group
            fiber = fiber.tolist()
            if private:              # bounded: see MODEL_GROUP_TIMEOUT
                g = _new_group(fiber, fresh=True, timeout=(
                    model_timeout or MODEL_GROUP_TIMEOUT))
            elif len(fiber) == ranks.size:
                g = whole
            else:
                g = _new_group(fiber)
            if me in fiber:
                groups[name] = (g, fiber)
    control = (_new_group(flat, fresh=True, timeout=COMMAND_TIMEOUT)
               if private else None)
    mesh = Mesh(ranks, axis_names, dev, groups=groups,
                group=whole if me in ranks else None,
                world=dist.group.WORLD,
                control=control if me in ranks else None)
    if not private:
        _MESHES[key] = mesh
    return mesh


def grid_mesh(devices: Sequence[int] | int | None = None, *,
              device: str | torch.device | None = None,
              private: bool = False) -> Mesh:
    """1-D ``('grid',)`` mesh for sharding a scenario batch over ranks.

    Args:
      devices: the ranks — a sequence of global ranks, an int (the first
        k), or None for every rank of the default group.
      device: this rank's device; default the one `spawn` gave it, else
        the card (raises without one).
      private: build fresh groups and a command group (module docstring)
        instead of the cached mesh's.

    Scenarios are independent, so the grid axis needs no collective in
    the round loop.
    """
    ranks = _resolve_ranks(devices, what="grid_mesh")
    return _build(np.asarray(ranks, np.int64), (GRID_AXIS,), device,
                  private)


def grid_model_mesh(devices: Sequence[int] | int | None = None, *,
                    model_shards: int = 1,
                    device: str | torch.device | None = None,
                    private: bool = False,
                    model_timeout: datetime.timedelta | None = None
                    ) -> Mesh:
    """2-D ``(GRID_AXIS, MODEL_AXIS)`` mesh: scenario-parallel x
    model-shard.

    Every group of ``model_shards`` consecutive ranks forms one
    model-sharding group (a grid row) whose collectives stay inside it.
    ``model_shards=1`` is a degenerate (g, 1) mesh.  ``private`` as
    `grid_mesh` takes it; a private mesh's model groups time out after
    ``model_timeout`` (default `MODEL_GROUP_TIMEOUT`).

    Returns:
      A mesh of shape ``(len(ranks) // model_shards, model_shards)``.
    """
    ranks = _resolve_ranks(devices, what="grid_model_mesh")
    if model_shards < 1:
        raise ValueError(f"model_shards={model_shards} must be >= 1")
    if len(ranks) % model_shards:
        raise ValueError(
            f"grid_model_mesh: {len(ranks)} devices do not factor into "
            f"model_shards={model_shards} groups"
        )
    arr = np.asarray(ranks, np.int64).reshape(-1, model_shards)
    return _build(arr, (GRID_AXIS, MODEL_AXIS), device, private,
                  model_timeout)


def mesh_fingerprint(mesh: Mesh) -> tuple:
    """A hashable identity for a mesh: axis names, shape, ranks and device
    type — the program-cache key component (`fl.scenarios.ProgramCache`),
    so a runner that switches rank subsets keeps one program per subset."""
    return (tuple(mesh.axis_names), tuple(mesh.ranks.shape),
            tuple(int(r) for r in mesh.ranks.flat), mesh.device.type)


# ---------------------------------------------------------------------------
# Collectives.
# ---------------------------------------------------------------------------
def _run(name: str, group, out: torch.Tensor, inp: torch.Tensor,
         call: Callable) -> torch.Tensor:
    """``call(out, inp)`` over ``group``, counting ``inp``'s bytes."""
    with _COUNT_LOCK:
        WIRE_BYTES[name] += inp.numel() * inp.element_size()
    guard = getattr(_GUARDS, "active", None)
    if guard is None or group is not guard.group:
        call(out, inp)
        return out
    guard.exchange(failed=False)
    try:
        call(out, inp)
    except Exception:
        guard.broken = True
        raise
    return out


def all_to_all(inp: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_to_all_single``: slice j of ``inp`` (dim 0 split in group
    size parts) goes to group rank j; returns what every rank sent here,
    stacked in group-rank order."""
    inp = inp.contiguous()
    return _run("all_to_all", group, torch.empty_like(inp), inp,
                lambda o, i: dist.all_to_all_single(o, i, group=group))


def reduce_scatter(inp: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.reduce_scatter_tensor``: the sum over ranks of ``inp``'s slice
    j (dim 0 split in group size parts) lands on group rank j."""
    inp = inp.contiguous()
    w = dist.get_world_size(group)
    out = torch.empty((inp.shape[0] // w,) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    return _run("reduce_scatter", group, out, inp,
                lambda o, i: dist.reduce_scatter_tensor(o, i, group=group))


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_reduce`` (sum) of a copy of ``t``."""
    out = t.contiguous().clone()
    return _run("all_reduce", group, out, out,
                lambda o, _i: dist.all_reduce(o, group=group))


def all_gather(inp: torch.Tensor, group=None) -> torch.Tensor:
    """``dist.all_gather_into_tensor``: every rank's ``inp`` concatenated
    along dim 0 in group-rank order."""
    inp = inp.contiguous()
    w = dist.get_world_size(group)
    out = torch.empty((w * inp.shape[0],) + tuple(inp.shape[1:]),
                      dtype=inp.dtype, device=inp.device)
    return _run("all_gather", group, out, inp,
                lambda o, i: dist.all_gather_into_tensor(o, i, group=group))


def gather_along(t: torch.Tensor, dim: int, group, fiber: list[int]
                 ) -> torch.Tensor:
    """Concatenate every fiber rank's ``t`` along ``dim`` in coordinate
    order (``fiber`` lists the ranks by coordinate; the group orders them
    by rank)."""
    moved = t.movedim(dim, 0)
    gathered = all_gather(moved, group)
    parts = gathered.chunk(len(fiber))
    by_rank = sorted(fiber)
    ordered = torch.cat([parts[by_rank.index(r)] for r in fiber])
    return ordered.movedim(0, dim)


def all_gather_objects(obj: Any, group=None) -> list:
    """``dist.all_gather_object``: every group rank's picklable ``obj``, in
    group-rank order (gloo moves them through host memory)."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


class RankFailed(RuntimeError):
    """A rank's share of a collective step raised (`gather_or_raise`).

    Every rank of the group raises it with the same message, which names
    the failing rank (the lowest, if several failed; a rank whose own
    share raised before one that a failed peer released), the error's
    type and its text; ``remote_traceback`` holds that rank's
    traceback; ``group_broken`` is True when a collective of a model
    group failed, which breaks the mesh (`Mesh.check`)."""

    def __init__(self, rank: int, kind: str, message: str,
                 remote_traceback: str = ""):
        super().__init__(f"rank {rank} failed: {kind}: {message}")
        self.rank = rank
        self.remote_traceback = remote_traceback
        self.group_broken = False


class MeshBroken(RuntimeError):
    """A step on a mesh whose model group broke earlier (`Mesh.check`)."""


class PeerFailed(RuntimeError):
    """A guarded share's peer failed (`gather_or_raise` with ``peers``):
    raised on the ranks that were waiting for it, in place of their
    collective."""


# The guard of the share this thread runs, if any (`gather_or_raise`).
_GUARDS = threading.local()


class _Guard:
    """The status exchange of a share's ``peers`` group: before every
    collective the share runs on that group (`_run`), and once at its
    end, the peers all-reduce one int, 1 when a peer's share failed.  A
    rank whose share raised outside a collective owes its peers one
    exchange, which meets the one they wait in, so every peer runs the
    same number of collectives on the group and it stays usable."""

    def __init__(self, group):
        self.group = group
        self.broken = False          # a collective itself failed here
        self.device = (torch.device("cpu")
                       if dist.get_backend(group) == "gloo" else
                       torch.device("cuda", torch.cuda.current_device()))

    def exchange(self, *, failed: bool) -> None:
        flag = torch.tensor([int(failed)], dtype=torch.int32,
                            device=self.device)
        try:
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
        except Exception:
            self.broken = True
            raise
        if not failed and int(flag.item()):
            raise PeerFailed("a peer's share failed")

    def settle(self, error: Exception) -> None:
        """After ``error`` left the share: the one exchange this rank owes
        its peers (none when a peer failed first or a collective broke)."""
        if isinstance(error, PeerFailed) or self.broken:
            return
        try:
            self.exchange(failed=True)
        except Exception:
            pass


def gather_or_raise(share: Callable[[], Any], group, *, peers=None,
                    mesh: Mesh | None = None) -> list:
    """Every group rank's ``share()``, in group-rank order, or `RankFailed`
    on every rank when any rank's ``share()`` raised.

    A rank whose share raises hands in its error in place of its result,
    so every rank reaches the gather: none waits for a peer that left.
    ``peers``: the group (of more than one rank) whose ranks run
    collectives together inside their shares; those collectives are
    guarded (`_Guard`), so a peer whose share raises between them
    releases the others.  A collective that fails on one rank while its
    peers are inside it (its rank raised there, or left) holds them until
    the group's timeout (a private mesh's `MODEL_GROUP_TIMEOUT`), after
    which they fail too and every rank raises `RankFailed` naming the
    first; such a group no longer agrees with itself, so ``mesh`` (the
    mesh the share runs on) is marked broken on every rank and refuses
    later steps (`Mesh.check`)."""
    guard = (None if peers is None or dist.get_world_size(peers) < 2
             else _Guard(peers))
    outer = getattr(_GUARDS, "active", None)
    _GUARDS.active = guard
    try:
        result = share()
        if guard is not None:
            guard.exchange(failed=False)
        mine = ("ok", result)
    except Exception as e:
        if guard is not None:
            guard.settle(e)
        mine = ("error", dist.get_rank(), type(e).__name__, str(e),
                traceback.format_exc(), not isinstance(e, PeerFailed))
        error = e
    finally:
        _GUARDS.active = outer
    broke = guard is not None and guard.broken
    parts = all_gather_objects((mine, broke), group)
    broken = any(b for _, b in parts)
    parts = [p for p, _ in parts]
    failed = [p for p in parts if p[0] == "error"]
    if failed:
        first = [p for p in failed if p[5]] or failed
        _, rank, kind, message, tb, _own = min(first, key=lambda p: p[1])
        exc = RankFailed(rank, kind, message, tb)
        exc.group_broken = broken
        if broken and mesh is not None:
            mesh.broken = (f"a model group's collective failed when rank "
                           f"{rank} failed ({kind}: {message})")
        if rank == dist.get_rank():
            raise exc from error
        raise exc
    return [p[1] for p in parts]


def broadcast_command(mesh: Mesh, command: Any = None) -> Any:
    """The leader's ``command`` on every rank of a private ``mesh``: the
    leader passes it, the others receive it (one `broadcast_object_list`
    on the mesh's command group)."""
    box = [command]
    dist.broadcast_object_list(box, src=mesh.leader, group=mesh.control)
    return box[0]


# ---------------------------------------------------------------------------
# One process per rank.
# ---------------------------------------------------------------------------
def _rank_main(rank: int, fn: Callable, world_size: int, backend: str,
               device: str, init_method: str, out_dir: str, timeout: float,
               threads: int | None, args: tuple) -> None:
    global _RANK_DEVICE
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        resolve_device(dev)            # TF32 off, as every entry point
    _RANK_DEVICE = dev
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        try:
            result = fn(rank, *args)
        except BaseException:
            # When one rank fails the others fail too (their peer is gone);
            # the time lets the parent report the first failure.
            with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
                f.write(f"{time.time()!r}\n{traceback.format_exc()}")
            raise
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
        # No rank tears its groups down while another may still use them
        # (a failed rank skips this: the parent then stops the others).
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _join(procs, tmp: str, timeout: float) -> bool:
    """``procs.join(timeout)``, a rank's failure raised as the first
    failure that any rank recorded."""
    try:
        return procs.join(timeout=timeout)
    except (torch.multiprocessing.ProcessRaisedException,
            torch.multiprocessing.ProcessExitedException) as e:
        failures = []
        for name in os.listdir(tmp):
            if name.endswith(".err"):
                with open(os.path.join(tmp, name)) as f:
                    when, _, tb = f.read().partition("\n")
                failures.append((float(when), name[4:-4], tb))
        if not failures:
            raise
        _when, rank, tb = min(failures)
        raise RuntimeError(f"spawn: rank {rank} failed first:\n{tb}") from e


def spawn(fn: Callable, world_size: int, *, backend: str = "gloo",
          device: str | torch.device | None = None, args: tuple = (),
          timeout: float = 600.0,
          threads: int | None = 1) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` fresh processes, one per
    rank of a new default process group, and return their results by rank.

    Args:
      fn: a picklable (module-level) function; what it returns must
        pickle too.
      backend: ``"gloo"`` (CPU ranks, or ranks sharing a card) or
        ``"nccl"`` (one card per rank).  Never switched.
      device: ``"cuda"`` (the default; raises without a card) or
        ``"cpu"``; on CUDA rank r uses card ``r % device_count`` (every
        rank on the one card of a one-card machine).
      timeout: seconds for the whole run and for each collective.
      threads: `torch.set_num_threads` in each rank (None keeps torch's).

    The processes start by the spawn method (never fork: CUDA may already
    be initialized here) and meet through a ``file://`` rendezvous in a
    fresh temporary directory, so concurrent calls never share a port.
    A rank's failure is raised here as a RuntimeError carrying the
    traceback of the rank that failed first (the others then fail on the
    lost peer); past ``timeout`` every rank is killed and TimeoutError
    raised.
    """
    device = resolve_device(device).type
    ctx = torch.multiprocessing
    tmp = tempfile.mkdtemp(prefix="repro-torch-spawn-")
    try:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = ctx.start_processes(
            _rank_main, nprocs=world_size, join=False, start_method="spawn",
            args=(fn, world_size, backend, device, init, tmp, timeout,
                  threads, args))
        deadline = time.monotonic() + timeout
        while not _join(procs, tmp, max(0.0, min(
                5.0, deadline - time.monotonic()))):
            if time.monotonic() >= deadline:
                for p in procs.processes:
                    if p.is_alive():
                        p.kill()
                for p in procs.processes:
                    p.join()
                raise TimeoutError(f"spawn: {world_size} ranks of "
                                   f"{getattr(fn, '__name__', fn)} did not "
                                   f"finish in {timeout} s")
        out = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
