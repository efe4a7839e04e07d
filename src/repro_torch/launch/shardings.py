"""Sharding rules: parameter / cache / batch specs per (arch, shape, mesh).

Port of the reference package's `launch/shardings.py`, over the port's
trees: flat dotted parameter dicts in `interop`'s leaf order ("embed.table",
"layers.attn.wq", ...), the AdamW state ``{"step", "m": {...}, "v":
{...}}``, decode caches ``{"k", "v", ...}`` and batches ``{"tokens",
"modal_embeds"}``.  A leaf's name is the last dotted component of its path;
it sits under a ``moe`` ancestor when any component of the path is
``moe``.

FSDP-style scheme: every weight shards its natural parallel dim over
'model' (heads / experts / ff / vocab) and the other large dim over the data
axes (ZeRO-3 analogue).  Under multi-pod the data axes are ('pod', 'data').
Layer-stacked leaves carry 1-2 leading scan dims which are never sharded.
An entry whose mesh extent does not divide its dim is dropped (`_fit`:
whisper's vocabulary of 51,865 stays whole over 16 model shards).

A spec is a `PartitionSpec`: per tensor dim None, an axis name, or a tuple
of axis names (major to minor).  `to_placements` turns one into DTensor
placements on a `DeviceMesh`.
"""
from __future__ import annotations

from typing import Any

import numpy as np

Tree = Any

# leaf name -> (spec for the trailing dims), expressed with placeholders
# 'D' = data axes, 'M' = 'model'.
_RULES: dict[str, tuple] = {
    # embedding / unembedding
    "table": ("M", "D"),
    # attention
    "wq": ("D", "M"),
    "wk": ("D", "M"),
    "wv": ("D", "M"),
    "wo": ("M", "D"),
    "bq": ("M",),
    "bk": ("M",),
    "bv": ("M",),
    # mlp
    "w_up": ("D", "M"),
    "w_gate": ("D", "M"),
    "w_down": ("M", "D"),
    # moe (leading expert dim -> model axis)
    "router": ("D", None),
    # ssm
    "w_in": ("D", "M"),
    "w_bc": ("M", None),
    "w_dt": ("M", None),
    "log_a": ("M", None),
    "d_skip": ("M",),
    "w_out": ("M", "D"),
    "dt_bias": (None,),
    # rwkv6
    "w_r": ("D", "M"),
    "w_k": ("D", "M"),
    "w_v": ("D", "M"),
    "w_g": ("D", "M"),
    "w_decay": ("D", "M"),
    "decay_bias": ("M",),
    "bonus_u": ("M", None),
    # norms / misc
    "scale": (None,),
    "bias": (None,),
    "gate": (None,),
    "step": (),
}

# MoE expert-stacked weights (under a "moe" ancestor): (E, D, F) / (E, F, D).
_MOE_3D = {"w_up": ("M", "D", None), "w_gate": ("M", "D", None),
           "w_down": ("M", None, "D")}

# mesh axis sizes of the production meshes (`mesh.make_production_mesh`)
AXIS_SIZES = {"pod": 2, "data": 16, "model": 16}


class PartitionSpec(tuple):
    """Per tensor dim: None (replicated), an axis name, or a tuple of axis
    names sharding that dim major to minor.  Trailing dims left out are
    replicated.  Equal to the plain tuple of its entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


P = PartitionSpec


def _path(keys: tuple[str, ...]) -> tuple[str, ...]:
    """A leaf's path components: every dict key along the way, dotted keys
    split at their dots."""
    return tuple(part for k in keys for part in str(k).split("."))


def _leaf_name(path: tuple[str, ...]) -> str:
    return path[-1] if path else ""


def _map_with_path(fn, tree: Tree, keys: tuple = ()) -> Tree:
    """``fn(path, leaf)`` over a nested dict of tensors (or shaped leaves),
    keeping its layout."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, keys + (k,)) for k, v in tree.items()}
    return fn(_path(keys), tree)


def _axis_prod(entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return int(np.prod([AXIS_SIZES[a] for a in entry]))
    return AXIS_SIZES[entry]


def _fit(spec_entries, shape) -> PartitionSpec:
    """Drop spec entries whose mesh extent does not divide the dim
    (explicit shardings require divisibility; the reference's GSPMD pads
    only propagated shardings)."""
    fitted = []
    for entry, dim in zip(spec_entries, shape):
        fitted.append(entry if dim % _axis_prod(entry) == 0 else None)
    return P(*fitted)


def param_specs(params_shape: Tree, *, data_axes,
                profile: str = "fsdp") -> Tree:
    """Spec tree matching a params (or AdamW state) tree.

    data_axes: 'data', ('data',) or ('pod', 'data').
    profile:
      'fsdp'    — weights sharded over BOTH model and data axes (ZeRO-3;
                  training default: optimizer states dominate memory).
      'tp_only' — weights sharded over 'model' only, replicated across data
                  (serving: no per-step weight all-gather).
    """

    def resolve(sym):
        if sym == "D":
            return None if profile == "tp_only" else data_axes
        if sym == "M":
            return "model"
        return sym

    def spec_for(path, leaf):
        name = _leaf_name(path)
        ndim = len(leaf.shape)
        rule = _RULES.get(name)
        if rule is None:
            return P()  # replicate unknowns
        if "moe" in path and name in _MOE_3D:
            rule = _MOE_3D[name]
        n_scan = ndim - len(rule)
        if n_scan < 0:  # e.g. scalar variants
            return P()
        entries = [None] * n_scan + [resolve(s) for s in rule]
        return _fit(entries, leaf.shape)

    return _map_with_path(spec_for, params_shape)


def batch_specs(batch_shape: Tree, *, data_axes, shard_batch: bool) -> Tree:
    """Token / modal batches: batch dim over the data axes (or
    replicated)."""
    dp = data_axes if shard_batch else None

    def spec_for(_path, leaf):
        return _fit([dp] + [None] * (len(leaf.shape) - 1), leaf.shape)

    return _map_with_path(spec_for, batch_shape)


def cache_specs(cache_shape: Tree, *, data_axes, shard_batch: bool,
                kv_shard: str = "heads") -> Tree:
    """Decode caches.

    Layout per leaf (see `transformer.init_cache`):
      k/v        (NL[, NS], B, T, KV, Dh)
      xk/xv      (NL/G, B, T_src, KV, Dh)
      rwkv_state (NL, B, H, Dh, Dh)
      ssm_state  (NL, B, Di, N)

    shard_batch=True (decode_32k): batch over data, kv-heads over model.
    shard_batch=False (long_500k, batch=1): SEQUENCE over data (context
    parallelism), kv-heads over model.
    """

    def spec_for(path, leaf):
        name = _leaf_name(path)
        nd = len(leaf.shape)
        b_ax = data_axes if shard_batch else None
        if name in ("k", "v", "xk", "xv"):
            lead = nd - 4  # scan dims before (B, T, KV, Dh)
            t_ax = None if shard_batch else data_axes
            kv = leaf.shape[-2]
            # kv_shard='seq': 'model' on the SEQUENCE dim — attention
            # reduces over T locally (context parallel).  kv_shard='heads':
            # 'model' on kv-heads when divisible, else on head_dim.
            if kv_shard == "seq" and shard_batch:
                entries = [None] * lead + [b_ax, "model", None, None]
            elif kv % AXIS_SIZES["model"] == 0:
                entries = [None] * lead + [b_ax, t_ax, "model", None]
            else:
                entries = [None] * lead + [b_ax, t_ax, None, "model"]
            return _fit(entries, leaf.shape)
        if name == "rwkv_state":
            h = leaf.shape[2]
            if h % AXIS_SIZES["model"] == 0:
                return _fit([None, b_ax, "model", None, None], leaf.shape)
            return _fit([None, b_ax, None, None, "model"], leaf.shape)
        if name == "ssm_state":
            return _fit([None, b_ax, "model", None], leaf.shape)
        return P()

    return _map_with_path(spec_for, cache_shape)


def to_placements(mesh, spec) -> list:
    """DTensor placements of ``spec`` on ``mesh`` (a `DeviceMesh` with named
    dims): `Shard(d)` on each mesh dim named for tensor dim d, `Replicate()`
    on the others.

    A tensor dim sharded over several mesh dims (('pod', 'data')) is split
    major to minor in mesh-dim order, which must be the spec's order, so
    each rank's local rows are the ones GSPMD gives it; a spec that names
    them the other way round raises.
    """
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} orders its axes unlike "
                             f"the mesh {tuple(names)}")
        for i in dims:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]!r} shards two dims "
                                 f"in {spec!r}")
            out[i] = Shard(d)
    return out
