"""Crossing parameters between the reference package and the port.

The reference keeps parameters as nested dicts of arrays; `jax.tree_util`
flattens them by sorted key at every level, and the concatenation of those
leaves is what the simulator cuts into segments.  The port keeps a flat
``dict[str, Tensor]`` whose iteration order is that same leaf order, with
dotted names ("fc1.b", "fc1.w", "layers.mix.w_r", ...).  Nothing here
imports the reference: it takes trees of numpy arrays
(``jax.tree.map(np.asarray, params)``).  A bfloat16 leaf arrives as numpy's
``ml_dtypes`` bfloat16, which `torch.from_numpy` refuses; it crosses
through float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import protocols


def _tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(arr)


def tree_from_params(params: dict[str, torch.Tensor]) -> dict:
    """Flat dotted dict -> nested dict of numpy arrays (the reverse of
    `params_from_jax` for dict trees).  bfloat16 tensors come out as
    float32 arrays holding the same values; the caller casts them back."""
    tree: dict = {}
    for name, t in params.items():
        *path, leaf = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        t = t.detach().cpu()
        node[leaf] = (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree


def params_from_jax(tree, *, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dict (or list) of numpy arrays -> flat dict of CPU tensors in
    leaf order."""
    out: dict[str, torch.Tensor] = {}
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {prefix: _tensor(np.array(tree))}
    for key, sub in items:
        out.update(params_from_jax(
            sub, prefix=f"{prefix}.{key}" if prefix else key))
    return out


def rows_from_params(stacked: dict[str, torch.Tensor],
                     seg_len: int) -> torch.Tensor:
    """Client-stacked params (leaves (N, ...)) -> (N, L, K) segment rows."""
    return protocols._to_segments(stacked, seg_len)[0]


def params_from_rows(rows: torch.Tensor,
                     like: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """(N, L, K) segment rows -> client-stacked params shaped like ``like``
    (per-client leaf shapes, in leaf order)."""
    spec = [(name, tuple(t.shape[1:])) for name, t in like.items()]
    m_params = sum(int(np.prod(shape)) for _, shape in spec)
    return protocols._from_segments(rows, spec, m_params)
