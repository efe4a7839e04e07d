"""Multi-pod dry run: trace every (arch x input-shape x mesh) combination
over the production mesh of 256 or 512 ranks, and derive the roofline terms.

Port of the reference package's `launch/dryrun.py`.  The reference lowers
and compiles each combination against 512 host devices and reads XLA's
memory and cost analyses.  Here each step function of the bundle
(`train_step`, `prefill_step`, `serve_step`) runs once, on the CPU, on
DTensor parameters, caches and batches placed by `launch.shardings` on
`mesh.make_production_mesh` (a fake process group: this process is rank 0
of 256 or 512), with every local shard a fake tensor (`FakeTensorMode`:
shapes and dtypes, no storage).  DTensor's sharding propagation plays the
part of GSPMD: it redistributes operands as each op needs, through the
functional collectives, which move nothing over the fake group.  A
dispatch mode (`_Trace`) watches the ops that run on the local shards and
counts, per device:

  * flops — the formulas torch's `FlopCounterMode` uses
    (`torch.utils.flop_counter`), applied to each local op.  A mode that
    sees the DTensor-level op would count the global product instead;
  * bytes — operand plus result bytes of every local aten op (views and
    allocations excepted).  This stands in for XLA's "bytes accessed";
    nothing fuses here, so it reads higher;
  * collective wire bytes by kind — from records (kind, result shape,
    dtype, group size) of the functional collectives DTensor issues,
    summed as the reference's HLO parser sums them (`collective_bytes`).

Where DTensor has no sharding rule for an op as its inputs are placed,
the trace redistributes them, as GSPMD inserts collectives: a view that
cannot split a sharded dim (GQA's 16 heads into (2, 8)) first moves that
shard to another dim; otherwise the inputs go replicated along the
innermost mesh dims, as few as it takes, and at worst the op runs on
whole inputs with replicated results.  The collectives this costs are
counted, and the ops are recorded under ``replicated_ops``.  Two more
departures from DTensor's own choices keep the batch sharded as GSPMD
keeps it: the weights are gathered over the data axes at the step's start
(`_gather_data`, ZeRO-3), and a ``new_*`` factory keeps the shards of
the dims it shares with its source.  No model code changes for DTensor.

Fake CPU tensors take every kernel's plain branch (`kernels.ops`), which
is what the reference's dry run lowers too.  On a CPU mesh DTensor turns a
shard-to-shard all-to-all into an all-gather and a local chunk, so such a
move is recorded as the all-gather it runs.

Roofline terms divide by the H100 SXM's published figures
(`mesh.PEAK_FLOPS_BF16`, `HBM_BW`, `LINK_BW`): they are dry-run estimates,
not measurements.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref
from typing import NamedTuple

import numpy as np
import torch

from ..configs import base as cfgbase
from ..models import registry
from ..models import transformer as T
from . import mesh as meshlib
from . import shardings

DEFAULT_OUT = os.path.join("results", "dryrun_torch")


# ---------------------------------------------------------------------------
# Input specs: shape-and-dtype stand-ins for every model input.
# ---------------------------------------------------------------------------
class ShapeDtype(NamedTuple):
    """A tensor's shape and dtype (the reference's ShapeDtypeStruct)."""
    shape: tuple
    dtype: torch.dtype


def sds(shape, dtype) -> ShapeDtype:
    return ShapeDtype(tuple(shape), dtype)


def input_specs(cfg: T.ModelCfg, shape: cfgbase.InputShape) -> dict:
    """Shapes and dtypes for one (arch, input-shape) combination.

    Returns a dict with keys depending on shape.kind:
      train/prefill: {"batch": {tokens[, modal_embeds]}}
      decode:        {"token", "pos"}
    """
    b, s = shape.global_batch, shape.seq_len
    out: dict = {}
    if shape.kind in ("train", "prefill"):
        batch = {"tokens": sds((b, s), torch.int32)}
        if cfg.family == "enc_dec":
            batch["modal_embeds"] = sds((b, cfg.enc_seq, cfg.d_model),
                                        cfg.dtype)
        elif cfg.family == "vlm":
            batch["modal_embeds"] = sds((b, cfg.n_modal_tokens, cfg.d_model),
                                        cfg.dtype)
        out["batch"] = batch
    else:
        out["token"] = sds((b, 1), torch.int32)
        out["pos"] = sds((), torch.int32)
    return out


def decode_plan(cfg: T.ModelCfg, shape: cfgbase.InputShape):
    """(cache_len, window, full_cache) for a decode shape.

    long_500k: SSM decodes natively (state only); attention families use the
    sliding-window cache — cache length = window, wrapped.
    """
    if shape.name == "long_500k":
        if cfg.family == "ssm":
            return 1, None, False  # no kv cache at all (state only)
        w = cfgbase.LONG_CONTEXT_WINDOW
        return w, w, True
    return shape.seq_len, None, False


# ---------------------------------------------------------------------------
# Collective bytes.
# ---------------------------------------------------------------------------
class Collective(NamedTuple):
    """One collective as the trace saw it: kind ("all-gather",
    "all-reduce", "reduce-scatter", "all-to-all", "collective-permute"),
    its result's shape and dtype, and its group's size."""
    kind: str
    shape: tuple
    dtype: torch.dtype
    group_size: int


def _wire_factor(kind: str, group_size: int) -> float:
    """Ring wire bytes per chip / RESULT-shape bytes.

    all-gather: result = gathered (N x input), wire = (N-1)/N x result ~ 1.
    reduce-scatter: result = input/N, wire = (N-1)/N x input ~ N x result.
    all-reduce: result = buffer, wire = 2(N-1)/N x buffer ~ 2.
    all-to-all / permute: wire ~ result.
    """
    g = max(group_size, 1)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind == "reduce-scatter":
        return float(g - 1)
    if kind == "all-gather":
        return (g - 1) / g
    return (g - 1) / g if kind == "all-to-all" else 1.0


def collective_bytes(records) -> dict[str, float]:
    """Sum estimated WIRE bytes of every collective, by kind: result bytes x
    the group-aware ring factor (`_wire_factor`)."""
    out: dict[str, float] = {}
    for r in records:
        n = math.prod(r.shape) * torch.empty((), dtype=r.dtype).element_size()
        out[r.kind] = out.get(r.kind, 0.0) + n * _wire_factor(r.kind,
                                                              r.group_size)
    return out


# ---------------------------------------------------------------------------
# Model FLOPs.
# ---------------------------------------------------------------------------
def param_shapes(cfg: T.ModelCfg) -> dict[str, torch.Tensor]:
    """The full model's parameters as fake tensors (shapes and dtypes,
    nothing allocated), in leaf order."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return T.init_params(torch.Generator().manual_seed(0), cfg)


def model_flops(cfg: T.ModelCfg, n_tokens: float, *, train: bool) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); 2*N*D for
    inference.  An expert weight (w_up / w_down / w_gate under moe) counts
    top_k / n_experts of its size."""
    total = 0.0
    active = 0.0
    for name, leaf in param_shapes(cfg).items():
        n = float(np.prod(leaf.shape))
        total += n
        path = name.split(".")
        if "moe" in path and any(k in ("w_up", "w_down", "w_gate")
                                 for k in path):
            n = n * cfg.top_k / cfg.n_experts
        active += n
    mult = 6.0 if train else 2.0
    return mult * active * n_tokens


# ---------------------------------------------------------------------------
# The trace.
# ---------------------------------------------------------------------------
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_to_all_single": "all-to-all",
}
# Ops that move no tensor bytes: allocations, metadata, and the functional
# collectives' identity wrappers.
_NO_BYTES = {"empty", "empty_strided", "empty_like", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "wait_tensor",
             "_wrap_tensor_autograd", "_local_scalar_dense", "device",
             "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
             "dim", "is_same_size"}
_DTENSOR_CODE = os.path.join("torch", "distributed", "")


def _in_dtensor() -> bool:
    """Whether the running op was issued by torch.distributed's own code
    (DTensor's dispatch, redistribution or autograd functions)."""
    f = sys._getframe(2)
    while f is not None:
        if _DTENSOR_CODE in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


_NEW_FACTORIES = {torch.ops.aten.new_zeros.default,
                  torch.ops.aten.new_empty.default,
                  torch.ops.aten.new_ones.default,
                  torch.ops.aten.new_full.default}
_VIEWS = {torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default,
          torch.ops.aten.reshape.default}


def _mutates(func) -> bool:
    """Whether ``func`` writes to one of its arguments (in-place or out=):
    such an op must run on the tensors given, so it takes no fallback."""
    return func._schema.is_mutable


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(func, args) -> int:
    """The group size of a functional collective: its ``group_size``
    argument, or the size of the group it names."""
    names = [a.name for a in func._schema.arguments]
    if "group_size" in names:
        return int(args[names.index("group_size")])
    from torch.distributed import distributed_c10d as c10d

    group = args[names.index("group_name")]
    return c10d._resolve_process_group(group).size()


class _Trace:
    """Per-device counts of one traced step (see the module docstring)."""

    def __init__(self, fake_mode, mesh):
        self.fake_mode = fake_mode
        self.mesh = mesh
        self.flops = 0.0
        self.bytes = 0.0
        self.records: list[Collective] = []
        self.replicated: dict[str, int] = {}
        self.live = 0
        self.peak = 0

    def costs(self) -> dict:
        coll = collective_bytes(self.records)
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "coll": float(sum(coll.values())), "coll_by_kind": coll,
                "replicated_ops": dict(self.replicated)}

    def _hold(self, out) -> None:
        """Count ``out``'s tensors as live until they are freed."""
        for t in _tensors(out):
            n = _nbytes(t)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def local(self, func, args, kwargs, out) -> None:
        """Count one op that ran on local shards."""
        from torch.utils.flop_counter import flop_registry

        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional" and name in _COLLECTIVES:
            res = _tensors(out)[0]
            self.records.append(Collective(
                _COLLECTIVES[name], tuple(res.shape), res.dtype,
                _group_size(func, args)))
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if name in _NO_BYTES or _is_view(func):
            return
        self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        self._hold(out)


def _make_mode():
    """The dispatch mode class (built on first use: importing this module
    imports no DTensor machinery)."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    class _Mode(TorchDispatchMode):
        def __init__(self, trace: _Trace):
            super().__init__()
            self.trace = trace
            self._pass = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            first = next((a for a in args if isinstance(a, torch.Tensor)),
                         None)
            if type(first) is torch.Tensor:
                # a real tensor: DTensor's own bookkeeping (mesh
                # coordinates, shard offsets), never the model's
                return func(*args, **kwargs)
            leaves = _tensors((args, kwargs))
            if any(isinstance(t, DTensor) for t in leaves):
                return self._dtensor(func, args, kwargs)
            fake = self.trace.fake_mode
            active = torch._C._get_dispatch_mode(
                torch._C._TorchDispatchModeKey.FAKE)
            if active is not None and active is not fake:
                # DTensor's shape inference on global fakes of its own.
                return func(*args, **kwargs)
            if not any(getattr(t, "fake_mode", None) is fake
                       for t in leaves):
                return self._unfaked(func, args, kwargs)
            out = func(*args, **kwargs)
            self.trace.local(func, args, kwargs, out)
            return out

        def _unfaked(self, func, args, kwargs):
            """An op on real tensors or none: inside DTensor's machinery
            (mesh coordinates, shard offsets, which it reads back) it runs
            real; a factory or constant of the model's becomes a fake of
            the trace's, counted as any local op."""
            if _in_dtensor():
                return func(*args, **kwargs)
            with self.trace.fake_mode:
                out = func(*args, **kwargs)
            self.trace.local(func, args, kwargs, out)
            return out

        def _dtensor(self, func, args, kwargs):
            if self._pass:            # hand the op to DTensor's dispatch
                self._pass = False
                return NotImplemented
            if func in _NEW_FACTORIES and isinstance(args[0], DTensor):
                return self._new(func, args, kwargs)
            mesh = self.trace.mesh
            # Without a rule for the op as placed: a view that cannot split
            # a sharded dim first moves that shard to another dim; then the
            # inputs go replicated along the innermost mesh dims ('model',
            # then the data axes), as few as it takes.
            tries = [lambda: (args, kwargs)]
            if func in _VIEWS and isinstance(args[0], DTensor):
                tries += [lambda pl=pl: ((self._move(args[0], pl),)
                                         + tuple(args[1:]), kwargs)
                          for pl in _moves(args[0])]
            tries += [lambda k=keep: tree_map(lambda a: self._gather(a, k),
                                              (args, kwargs))
                      for keep in range(mesh.ndim - 1, -1, -1)]
            trace = self.trace
            for n, make in enumerate(tries):
                mark = (trace.flops, trace.bytes, len(trace.records))
                try:
                    call = make()
                    self._pass = True
                    with self:
                        out = func(*call[0], **call[1])
                except Exception:     # DTensor raises what it may
                    if _mutates(func):
                        raise
                    # a failed try's partial work is not counted
                    trace.flops, trace.bytes = mark[:2]
                    del trace.records[mark[2]:]
                    continue
                finally:
                    self._pass = False
                out = _unmask(out)
                if n:
                    name = str(func)
                    trace.replicated[name] = trace.replicated.get(name, 0) + 1
                return out
            return self._local(func, args, kwargs)

        def _new(self, func, args, kwargs):
            """A ``new_*`` factory on a DTensor: DTensor makes it
            replicated; here it keeps the shards of every dim it shares
            with its source (a gradient's zeros stay split by batch, as
            GSPMD keeps them), the rest replicated."""
            src, size = args[0], list(args[1])
            keep = [p if (p.is_shard() and len(size) == src.ndim
                          and size[p.dim] == src.shape[p.dim])
                    else Replicate() for p in src.placements]
            local = list(size)
            for i, p in enumerate(keep):
                if p.is_shard():
                    local[p.dim] //= src.device_mesh.size(i)
            with self:
                out = func(src.to_local(), local, *args[2:], **kwargs)
            return DTensor.from_local(out, src.device_mesh, keep,
                                      run_check=False, shape=torch.Size(size),
                                      stride=_contiguous(size))

        def _move(self, a, placements):
            with self:
                return a.redistribute(self.trace.mesh, placements)

        def _gather(self, a, keep: int):
            """``a`` replicated along the mesh dims from ``keep`` on."""
            if not isinstance(a, DTensor):
                return a
            placements = [p if i < keep else Replicate()
                          for i, p in enumerate(a.placements)]
            with self:
                return a.redistribute(self.trace.mesh, placements)

        def _local(self, func, args, kwargs):
            """``func`` run on the whole (replicated) inputs, its results
            replicated over the mesh: the ops DTensor takes in no
            placement."""
            mesh = self.trace.mesh
            rep = [Replicate()] * mesh.ndim
            name = str(func)
            self.trace.replicated[name] = self.trace.replicated.get(name,
                                                                    0) + 1
            whole = tree_map(lambda a: (self._gather(a, 0).to_local()
                                        if isinstance(a, DTensor) else a),
                             (args, kwargs))
            with self:
                out = func(*whole[0], **whole[1])
                return tree_map(
                    lambda o: (DTensor.from_local(o, mesh, rep,
                                                  run_check=False)
                               if isinstance(o, torch.Tensor) else o), out)

    return _Mode


def _moves(a) -> list:
    """Placements of DTensor ``a`` with one mesh dim's shard moved to
    another tensor dim that mesh dim divides (innermost mesh dim first,
    then tensor dims in order): where a view cannot split a dim sharded
    16 ways (GQA's 16 heads into (2, 8)), a shard on another dim still
    splits the work."""
    mesh = a.device_mesh
    out = []
    for i in reversed(range(mesh.ndim)):
        p = a.placements[i]
        if not p.is_shard():
            continue
        taken = {q.dim for j, q in enumerate(a.placements)
                 if j != i and q.is_shard()}
        for d in range(a.ndim):
            if (d != p.dim and d not in taken
                    and a.shape[d] % mesh.size(i) == 0):
                pl = list(a.placements)
                pl[i] = type(p)(d)
                out.append(pl)
    return out


def _unmask(out):
    """DTensor's masked partial (a gather over a sharded dim) as the plain
    partial sum it reduces like.  Its own reduction zeroes the masked rows
    with an index that fails for `gather`'s layout; the values are fake, so
    only the placement matters."""
    from torch.distributed.tensor import DTensor, Partial
    from torch.utils._pytree import tree_map

    def fix(o):
        if not isinstance(o, DTensor) or not any(
                type(p).__name__ == "_MaskPartial" for p in o.placements):
            return o
        placements = [Partial("sum") if type(p).__name__ == "_MaskPartial"
                      else p for p in o.placements]
        return DTensor.from_local(o.to_local(), o.device_mesh, placements,
                                  run_check=False, shape=o.shape,
                                  stride=o.stride())

    return tree_map(fix, out)


def _contiguous(shape) -> tuple:
    """The contiguous strides of ``shape``."""
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(out))


def _trace_mesh(mesh):
    """The mesh a step is traced on: the production mesh, with the
    multi-pod mesh's ('pod', 'data') flattened into one dim of 32,
    'pod_data' (pod major, data minor: the ranks in the order GSPMD splits
    a dim over both).  The data axes always shard a dim together, and XLA
    runs their collectives as one over 32 ranks; DTensor would run two in
    a row, and plans moves between placements on three mesh dims by a
    search that takes minutes an op."""
    from torch.distributed.device_mesh import DeviceMesh

    names = tuple(mesh.mesh_dim_names)
    if names != ("pod", "data", "model"):
        return mesh
    p, d, m = mesh.mesh.shape
    return DeviceMesh(mesh.device_type, mesh.mesh.reshape(p * d, m),
                      mesh_dim_names=("pod_data", "model"))


def _on_mesh(mesh, spec):
    """``spec`` with an entry of several axes that ``mesh`` flattened into
    one dim (`_trace_mesh`) naming that dim."""
    names = mesh.mesh_dim_names

    def entry(e):
        if isinstance(e, (tuple, list)) and "_".join(e) in names:
            return "_".join(e)
        return e

    return shardings.P(*(entry(e) for e in spec))


def _fake_dtensor(fake_mode, mesh, shape, dtype, spec):
    """A DTensor of global ``shape`` placed by ``spec`` on ``mesh``, its
    local shard a fake tensor."""
    from torch.distributed.tensor import DTensor

    placements = shardings.to_placements(mesh, _on_mesh(mesh, spec))
    local = list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    with fake_mode:
        t = torch.empty(local, dtype=dtype)
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def _place(fake_mode, mesh, tree, specs):
    """A tree of fake DTensors matching ``tree``'s shapes and dtypes."""
    if isinstance(tree, dict):
        return {k: _place(fake_mode, mesh, v, specs[k])
                for k, v in tree.items()}
    return _fake_dtensor(fake_mode, mesh, tuple(tree.shape), tree.dtype,
                         specs)


def _constrain(tree, mesh, specs):
    """Redistribute every DTensor of ``tree`` to ``specs`` (the reference's
    out_shardings); None specs leave a leaf as it is."""
    if isinstance(tree, dict):
        return {k: _constrain(v, mesh, specs[k]) for k, v in tree.items()}
    if specs is None or not hasattr(tree, "redistribute"):
        return tree                   # left alone, or a plain (replicated)
    return tree.redistribute(mesh, shardings.to_placements(
        mesh, _on_mesh(mesh, specs)))


_STACKED = ("layers.", "enc_layers.", "cross_layers.")


def _gather_data(params: dict, dax) -> dict:
    """The weights gathered over the data axes (ZeRO-3 / FSDP: a weight
    sharded over them is whole on each data rank while the step uses it;
    its gradient comes back partial over them and is reduce-scattered into
    the sharded optimizer state).  GSPMD gathers them the same way; DTensor
    propagating op by op would instead trade the batch's shard for a
    weight's where the two meet on one mesh dim.  A layer-stacked leaf is
    gathered unit by unit along its leading axis, so the cost is the same
    for every unit (`extrapolated_costs`)."""
    from torch.distributed.tensor import Replicate

    def whole(t):
        names = t.device_mesh.mesh_dim_names
        return [Replicate() if names[i] in dax else p
                for i, p in enumerate(t.placements)]

    out = {}
    for name, t in params.items():
        if whole(t) == list(t.placements):
            out[name] = t
        elif name.startswith(_STACKED):
            out[name] = torch.stack([u.redistribute(u.device_mesh, whole(u))
                                     for u in t.unbind(0)])
        else:
            out[name] = t.redistribute(t.device_mesh, whole(t))
    return out


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in _tensors(tree))


def _shapes(tree):
    """Fake tensors (or ShapeDtypes) -> ShapeDtypes, keeping the layout."""
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return ShapeDtype(tuple(tree.shape), tree.dtype)


def _trace(cfg, shape, mesh, dax, n_chips, profile="fsdp", kv_shard="heads"):
    """Run one (cfg, shape) step on ``mesh`` under the trace.  Returns
    (`_Trace`, {"argument", "output", "temp"} local bytes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    bundle = registry.build(cfg)
    specs = input_specs(cfg, shape)
    fake = FakeTensorMode(allow_non_fake_inputs=True)
    mesh = _trace_mesh(mesh)
    trace = _Trace(fake, mesh)
    gdax = _on_mesh(mesh, [dax])[0]     # the data axes as mesh dims
    gdax = (gdax,) if isinstance(gdax, str) else gdax
    params_shape = _shapes(param_shapes(cfg))

    def place(tree, spec):
        return _place(fake, mesh, tree, spec)

    if shape.kind == "train":
        f32 = {k: ShapeDtype(v.shape, torch.float32)
               for k, v in params_shape.items()}
        opt_shape = {"step": ShapeDtype((), torch.int32), "m": f32, "v": f32}
        state_spec = {
            "params": shardings.param_specs(params_shape, data_axes=dax),
            "opt": shardings.param_specs(opt_shape, data_axes=dax),
        }
        batch_spec = shardings.batch_specs(specs["batch"], data_axes=dax,
                                           shard_batch=True)
        args = (place({"params": params_shape, "opt": opt_shape}, state_spec),
                place(specs["batch"], batch_spec))
        out_spec = (state_spec, {"loss": shardings.P(),
                                 "aux": shardings.P()})

        def step(state, batch):
            state = dict(state, params=_gather_data(state["params"], gdax))
            return bundle.train_step(state, batch, device="cpu")
    elif shape.kind == "prefill":
        param_spec = shardings.param_specs(params_shape, data_axes=dax,
                                           profile=profile)
        batch_spec = shardings.batch_specs(specs["batch"], data_axes=dax,
                                           shard_batch=True)
        args = (place(params_shape, param_spec),
                place(specs["batch"], batch_spec))
        out_spec = None
        window = cfg.sliding_window

        def step(params, batch):
            return bundle.prefill_step(_gather_data(params, gdax), batch,
                                       window=window, device="cpu")
    else:  # decode
        cache_len, window, full_cache = decode_plan(cfg, shape)
        param_spec = shardings.param_specs(params_shape, data_axes=dax,
                                           profile=profile)
        b = shape.global_batch
        with FakeTensorMode():
            cache_shape = _shapes(bundle.init_cache(b, cache_len,
                                                    window=window,
                                                    device="cpu"))
        shard_batch = b >= n_chips // 16 and b > 1
        cache_spec = shardings.cache_specs(cache_shape, data_axes=dax,
                                           shard_batch=shard_batch,
                                           kv_shard=kv_shard)
        token_spec = shardings.P(dax, None) if shard_batch else shardings.P()
        args = (place(params_shape, param_spec),
                place(cache_shape, cache_spec),
                place(specs["token"], token_spec))
        out_spec = (None, cache_spec)

        def step(params, cache, token):
            return bundle.serve_step(_gather_data(params, gdax), cache, token,
                                     0, window=window,
                                     abs_pos=None, full_cache=full_cache,
                                     device="cpu")

    argument = _local_bytes(args)
    with implicit_replication(), _make_mode()(trace):
        out = step(*args)
        if out_spec is not None:
            out = tuple(o if s is None else _constrain(o, mesh, s)
                        for o, s in zip(out, out_spec))
    mem = {"argument": argument, "output": _local_bytes(out),
           "temp": trace.peak}
    return trace, mem


def _extract_costs(trace: _Trace) -> dict:
    """Per-device flops / bytes / collective bytes of one traced step."""
    return trace.costs()


def extrapolated_costs(cfg, shape, mesh, dax, n_chips, profile="fsdp",
                       kv_shard="heads") -> dict:
    """Roofline costs via layer-count extrapolation, as the reference
    computes them: trace variants at 1 and 2 repeating units and
    extrapolate linearly,
        total(U units) = f(1) + (U - 1) * (f(2) - f(1)),
    exact for homogeneous stacks (the port counts every layer it runs, so
    the full-depth trace gives the same counts; the variants keep a sweep
    fast).  enc-dec solves a 3-point system for encoder and decoder layer
    costs separately; the vlm's unit is cross_attn_every layers; the ssm
    family's prefill and training above 8,192 tokens trace seq / 8 and
    scale (its chunked scan does identical per-chunk work)."""
    rep = dataclasses.replace

    def costs_for(c, shp=shape):
        return _extract_costs(
            _trace(c, shp, mesh, dax, n_chips, profile, kv_shard)[0])

    def lin(f1, f2, units):
        # Per-layer deltas clamp at >= 0, as the reference's do.
        out = {}
        for k in ("flops", "bytes", "coll"):
            out[k] = f1[k] + (units - 1) * max(f2[k] - f1[k], 0.0)
        kinds = set(f1["coll_by_kind"]) | set(f2["coll_by_kind"])
        out["coll_by_kind"] = {
            k: f1["coll_by_kind"].get(k, 0.0)
            + (units - 1) * max(f2["coll_by_kind"].get(k, 0.0)
                                - f1["coll_by_kind"].get(k, 0.0), 0.0)
            for k in kinds
        }
        return out

    base = cfg
    if cfg.family == "ssm" and shape.kind != "decode" and shape.seq_len > 8192:
        scale = 8
        small = dataclasses.replace(shape, seq_len=shape.seq_len // scale)
        f1 = costs_for(rep(base, n_layers=1), small)
        f2 = costs_for(rep(base, n_layers=2), small)
        out = lin(f1, f2, cfg.n_layers)
        for k in ("flops", "bytes", "coll"):
            out[k] *= scale
        out["coll_by_kind"] = {k: v * scale
                               for k, v in out["coll_by_kind"].items()}
        return out
    if cfg.family == "vlm":
        ce = cfg.cross_attn_every
        units = cfg.n_layers // ce
        f1 = costs_for(rep(base, n_layers=ce))
        f2 = costs_for(rep(base, n_layers=2 * ce))
        return lin(f1, f2, units)
    if cfg.family == "enc_dec":
        f11 = costs_for(rep(base, n_layers=1, n_enc_layers=1))
        f21 = costs_for(rep(base, n_layers=1, n_enc_layers=2))
        f12 = costs_for(rep(base, n_layers=2, n_enc_layers=1))
        out = {}
        for k in ("flops", "bytes", "coll"):
            enc_c = f21[k] - f11[k]
            dec_c = f12[k] - f11[k]
            const = f11[k] - enc_c - dec_c
            out[k] = const + cfg.n_enc_layers * enc_c + cfg.n_layers * dec_c
        kinds = (set(f11["coll_by_kind"]) | set(f21["coll_by_kind"])
                 | set(f12["coll_by_kind"]))
        out["coll_by_kind"] = {}
        for k in kinds:
            a = f11["coll_by_kind"].get(k, 0.0)
            e = f21["coll_by_kind"].get(k, 0.0) - a
            d = f12["coll_by_kind"].get(k, 0.0) - a
            out["coll_by_kind"][k] = ((a - e - d) + cfg.n_enc_layers * e
                                      + cfg.n_layers * d)
        return out
    f1 = costs_for(rep(base, n_layers=1))
    f2 = costs_for(rep(base, n_layers=2))
    return lin(f1, f2, cfg.n_layers)


def run_one(arch: str, shape_name: str, *, multi_pod: bool,
            cfg_override=None, profile: str = "fsdp",
            kv_shard: str = "heads") -> dict:
    """One combination: the full-depth trace (its seconds are
    ``compile_s``; it gives ``bytes_per_device``: the local shards'
    ``argument`` and ``output`` bytes and, as ``temp``, the peak of live
    local bytes the step's ops produced; ``generated_code`` is null, since
    nothing is compiled), then the layer-extrapolated costs and the
    roofline terms over the H100 SXM's published figures."""
    cfg = cfg_override or cfgbase.get(arch)
    shape = cfgbase.INPUT_SHAPES[shape_name]
    mesh = meshlib.make_production_mesh(multi_pod=multi_pod)
    dax = meshlib.data_axes(multi_pod=multi_pod)
    n_chips = int(mesh.size())
    t0 = time.time()

    result: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "family": cfg.family, "kind": shape.kind,
    }

    # 1) Full depth: proves the step runs sharded, and gives the bytes.
    full, mem = _trace(cfg, shape, mesh, dax, n_chips, profile, kv_shard)
    t_full = time.time() - t0

    # 2) Roofline costs: layer-extrapolated from shallow variants.
    costs = extrapolated_costs(cfg, shape, mesh, dax, n_chips, profile,
                               kv_shard)
    t_cost = time.time() - t0 - t_full

    flops, bytes_accessed, coll_total = (costs["flops"], costs["bytes"],
                                         costs["coll"])
    compute_s = flops / meshlib.PEAK_FLOPS_BF16
    memory_s = bytes_accessed / meshlib.HBM_BW
    collective_s = coll_total / meshlib.LINK_BW

    n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
    mf = model_flops(cfg, n_tokens, train=shape.kind == "train")

    result.update(
        ok=True,
        compile_s=round(t_full, 1),
        cost_extrapolation_s=round(t_cost, 1),
        n_chips=n_chips,
        hlo_flops=flops,
        hlo_bytes=bytes_accessed,
        collective_bytes=coll_total,
        collectives=costs["coll_by_kind"],
        compute_term_s=compute_s,
        memory_term_s=memory_s,
        collective_term_s=collective_s,
        dominant=max(
            [("compute", compute_s), ("memory", memory_s),
             ("collective", collective_s)], key=lambda kv: kv[1])[0],
        model_flops=mf,
        useful_flops_ratio=(mf / (flops * n_chips) if flops else 0.0),
        bytes_per_device={
            "output": mem["output"],
            "temp": mem["temp"],
            "argument": mem["argument"],
            "generated_code": None,
        },
        replicated_ops=full.costs()["replicated_ops"],
    )
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-cached", action="store_true")
    ap.add_argument("--profile", default="fsdp", choices=["fsdp", "tp_only"],
                    help="param sharding profile (tp_only: serving)")
    ap.add_argument("--kv-shard", default="heads", choices=["heads", "seq"],
                    help="decode cache sharding over 'model'")
    ap.add_argument("--perf", default=None,
                    help="comma list of cfg overrides, e.g. "
                         "attn_impl=chunked,loss_vocab_chunk=16384")
    args = ap.parse_args(argv)

    overrides = {}
    if args.perf:
        for kv in args.perf.split(","):
            k, v = kv.split("=")
            overrides[k] = int(v) if v.isdigit() else v

    os.makedirs(args.out, exist_ok=True)
    combos: list[tuple[str, str, bool]] = []
    archs = cfgbase.ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = (list(cfgbase.INPUT_SHAPES) if (args.all or not args.shape)
              else [args.shape])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for a in archs:
        for s in shapes:
            for mp in meshes:
                combos.append((a, s, mp))

    n_ok = 0
    for arch, shape, mp in combos:
        suffix = ""
        if args.profile != "fsdp":
            suffix += f"__{args.profile}"
        if args.kv_shard != "heads":
            suffix += f"__kv-{args.kv_shard}"
        if overrides:
            suffix += "__" + "_".join(f"{k}-{v}" for k, v in overrides.items())
        tag = f"{arch}__{shape}__{'2x16x16' if mp else '16x16'}{suffix}"
        path = os.path.join(args.out, tag + ".json")
        if args.skip_cached and os.path.exists(path):
            with open(path) as f:
                if json.load(f).get("ok"):
                    print(f"[cached] {tag}")
                    n_ok += 1
                    continue
        print(f"[run] {tag} ...", flush=True)
        try:
            cfg_override = None
            if overrides:
                cfg_override = dataclasses.replace(cfgbase.get(arch),
                                                   **overrides)
            res = run_one(arch, shape, multi_pod=mp, profile=args.profile,
                          cfg_override=cfg_override, kv_shard=args.kv_shard)
            res["profile"] = args.profile
            res["overrides"] = overrides
            n_ok += 1
        except Exception as e:  # record failures — they are bugs to fix
            res = {"arch": arch, "shape": shape,
                   "mesh": "2x16x16" if mp else "16x16",
                   "ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-4000:]}
            print(f"  FAILED: {res['error']}", flush=True)
        with open(path, "w") as f:
            json.dump(res, f, indent=1, default=str)
        if res.get("ok"):
            print(
                f"  ok compile={res['compile_s']}s "
                f"cost_x={res['cost_extrapolation_s']}s "
                f"dominant={res['dominant']} "
                f"terms(ms)=[{1e3*res['compute_term_s']:.2f} c / "
                f"{1e3*res['memory_term_s']:.2f} m / "
                f"{1e3*res['collective_term_s']:.2f} coll] "
                f"useful={res['useful_flops_ratio']:.2f}",
                flush=True,
            )
    print(f"done: {n_ok}/{len(combos)} ok")
    if n_ok < len(combos):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
