"""Tree and scan-state checkpointing: npz payload + JSON manifest.

Port of the reference package's `checkpoint/checkpoint.py`.
Two layers:

  * Generic tree save/restore: a tree is nested dicts (keys in sorted
    order), lists, tuples and NamedTuples whose leaves are tensors, numpy
    arrays or Python / numpy scalars.  `save` copies every leaf to the host
    (a CUDA tensor syncs its device once); `restore` fills the structure of
    a ``like`` tree, checking leaf count, shapes AND dtypes (the manifest
    records dtypes; a mismatch raises unless ``cast=True``) and placing
    each tensor leaf on the device of ``like``'s leaf.  A bfloat16 tensor
    is stored as its 16-bit pattern (numpy has no bfloat16) and recorded
    as ``bfloat16``.
  * `run_resumable`: a host loop over `SimPrograms.init_scan` /
    `advance_chunk`, the two functions `SimPrograms.run_scenario` loops, that
    checkpoints the round state ``{"w", "gen", "t"[, "sig"]}`` every
    ``save_every`` chunks and resumes it.  The generator ``gen`` is saved as
    its state (``get_state()``, uint8) and restored with ``set_state`` into
    a fresh generator on the sim's device, so a resumed run draws the
    numbers the uninterrupted run would have drawn and replays the same
    rounds: on the CPU the result equals `run_scenario`'s bit for bit.

The layout and the crash safety are the reference's: both files are
staged in a temporary directory beside them and `os.replace`d into place,
arrays first and the manifest last (the commit point); a ``save_id``
stamped into both files exposes the one torn window that order leaves.

Model-sharded runs (``mesh=``, a sim built with ``model_shards > 1``):
every rank of the mesh calls `run_resumable` alike.  A checkpoint holds
the full (N, S, K) rows, gathered from the model group, and the mesh's
first rank writes it (the others wait at a barrier), so a checkpoint
written by W ranks restores in a single-process run and the other way
round: on restore each rank takes its window of the rows.
"""
from __future__ import annotations

import json
import os
import tempfile
import uuid
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..launch import mesh as launch_mesh

Tree = Any


class CorruptCheckpoint(RuntimeError):
    """The checkpoint at a path is internally inconsistent — a torn
    write (manifest and arrays from different `save` calls), a missing
    payload file, or an array count that disagrees with the manifest.
    `run_resumable` treats such a checkpoint as absent and restarts from
    round 0 rather than resuming from torn state."""


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree: Tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key path, leaf)`` pairs in a fixed order, keys spelled as the
    reference's ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for name in tree._fields
                for kv in _flatten(getattr(tree, name), f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in _flatten(x, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(like: Tree, leaves) -> Tree:
    """``like``'s structure with its leaves taken from ``leaves`` (an
    iterator) in `_flatten`'s order."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, n), leaves)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _structure(tree: Tree) -> str:
    """The tree's structure with every leaf as ``*`` (the manifest's
    ``treedef``)."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if _is_namedtuple(tree):
        return (type(tree).__name__ + "(" + ", ".join(
            f"{n}={_structure(getattr(tree, n))}" for n in tree._fields)
            + ")")
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_structure(x) for x in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _dtype_name(leaf) -> str:
    """A leaf's dtype as the manifest records it (numpy's names;
    ``bfloat16`` for a bfloat16 tensor)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return np.asarray(leaf)


def save(path: str, tree: Tree, *, step: int | None = None) -> None:
    """Write ``tree`` to ``path`` (a directory), overwriting any previous
    checkpoint there.

    Every leaf is copied to the host first (a tensor on the card is
    copied back, which waits for the device).

    Crash-safe: both files are staged in a temp dir on the same
    filesystem, then atomically `os.replace`d into place — arrays first,
    manifest last, so the manifest is the commit point (a crash leaves
    either the previous checkpoint or the new one, never a half-written
    file).  A per-save ``save_id`` is stamped into BOTH files; `restore`
    rejects the one torn window the ordering leaves open (new arrays
    with the old manifest) as `CorruptCheckpoint`.
    """
    os.makedirs(path, exist_ok=True)
    leaves = _flatten(tree)
    save_id = uuid.uuid4().hex
    arrays = {f"leaf_{i}": _to_host(leaf)
              for i, (_, leaf) in enumerate(leaves)}
    manifest = {
        "keys": [k for k, _ in leaves],
        "treedef": _structure(tree),
        "step": step,
        "dtypes": [_dtype_name(leaf) for _, leaf in leaves],
        "shapes": [list(a.shape) for a in arrays.values()],
        "save_id": save_id,
    }
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-", dir=path)
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), __save_id__=save_id,
                 **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(os.path.join(tmp, "arrays.npz"),
                   os.path.join(path, "arrays.npz"))
        os.replace(os.path.join(tmp, "manifest.json"),
                   os.path.join(path, "manifest.json"))
    finally:
        for name in ("arrays.npz", "manifest.json"):
            try:
                os.unlink(os.path.join(tmp, name))
            except FileNotFoundError:
                pass
        os.rmdir(tmp)


def _place(got: np.ndarray, stored: str, want) -> Any:
    """A stored array as ``want``'s kind of leaf: a tensor of its dtype on
    its device, a numpy array, or a Python scalar."""
    if isinstance(want, torch.Tensor):
        if stored == "bfloat16":
            t = torch.from_numpy(got.view(np.int16).copy()).view(
                torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(got))
        return t.to(device=want.device, dtype=want.dtype)
    if stored == "bfloat16":     # only a tensor leaf can hold bfloat16
        raise ValueError("a bfloat16 checkpoint leaf needs a tensor target")
    if isinstance(want, (bool, int, float)):
        return type(want)(got)
    return got.astype(np.asarray(want).dtype, copy=False)


def restore(path: str, like: Tree, *, cast: bool = False) -> Tree:
    """Restore into the structure of ``like`` (leaf count, shapes and
    dtypes checked).

    Args:
      path: checkpoint directory written by `save`.
      like: a tree giving the target structure.  A tensor leaf gets the
        restored value as a tensor on that leaf's device; a numpy leaf a
        numpy array; a Python scalar a scalar of its type.
      cast: a stored dtype that differs from ``like``'s raises
        ValueError unless ``cast=True``, in which case the leaf is cast
        to the target dtype (the manifest records the stored dtypes, so
        the mismatch message names both sides).

    Returns:
      ``like``'s structure filled with the stored values.

    Raises:
      FileNotFoundError: no manifest at ``path`` (no checkpoint).
      CorruptCheckpoint: the manifest exists but the payload is missing,
        from a different `save` call (torn write), or holds the wrong
        number of arrays.
    """
    manifest, data = _load_consistent(path)
    leaves_like = [leaf for _, leaf in _flatten(like)]
    stored = [data[f"leaf_{i}"] for i in range(len(manifest["keys"]))]
    if len(stored) != len(leaves_like):
        raise ValueError(
            f"checkpoint has {len(stored)} leaves, target has {len(leaves_like)}"
        )
    out = []
    for i, (got, want) in enumerate(zip(stored, leaves_like)):
        want_shape = (tuple(want.shape) if isinstance(want, torch.Tensor)
                      else tuple(np.shape(want)))
        if tuple(got.shape) != want_shape:
            raise ValueError(
                f"shape mismatch at {manifest['keys'][i]}: "
                f"{tuple(got.shape)} vs {want_shape}"
            )
        want_dtype = _dtype_name(want)
        have = manifest["dtypes"][i]
        if want_dtype != have:
            if not cast:
                raise ValueError(
                    f"dtype mismatch at {manifest['keys'][i]}: checkpoint "
                    f"holds {have}, target wants "
                    f"{want_dtype}; pass cast=True to convert explicitly"
                )
        out.append(_place(got, have, want))
    return _unflatten(like, iter(out))


def _load_consistent(path: str) -> tuple[dict, Any]:
    """Load ``(manifest, npz)`` from ``path``, proving they belong to
    the SAME `save` call.

    FileNotFoundError when there is no manifest (no checkpoint at all);
    `CorruptCheckpoint` when the manifest exists but the payload is
    missing, carries a different ``save_id`` (torn write), or its leaf
    keys disagree with the manifest's count.  Checkpoints written before
    ``save_id`` existed (no id in either file) pass the pairing check.
    """
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    try:
        data = np.load(os.path.join(path, "arrays.npz"))
    except FileNotFoundError:
        raise CorruptCheckpoint(
            f"checkpoint at {path!r} has a manifest but no arrays.npz "
            f"(torn write — treat as absent)"
        ) from None
    man_id = manifest.get("save_id")
    npz_id = (str(data["__save_id__"]) if "__save_id__" in data.files
              else None)
    if man_id != npz_id:
        raise CorruptCheckpoint(
            f"checkpoint at {path!r} is torn: manifest save_id "
            f"{man_id!r} != arrays save_id {npz_id!r}"
        )
    want = {f"leaf_{i}" for i in range(len(manifest["keys"]))}
    got = {k for k in data.files if k.startswith("leaf_")}
    if want != got:
        raise CorruptCheckpoint(
            f"checkpoint at {path!r}: manifest lists "
            f"{len(manifest['keys'])} arrays, payload holds {len(got)}"
        )
    return manifest, data


def latest_step(path: str) -> int | None:
    """The ``step`` recorded by the checkpoint at ``path``.

    Distinguishes the previously-conflated cases:

      * no checkpoint at ``path`` at all → raises FileNotFoundError;
      * an incomplete/torn checkpoint → raises `CorruptCheckpoint`
        (callers that can restart should treat it like absent —
        `run_resumable` does);
      * a checkpoint exists but `save` was called without ``step`` →
        returns None.
    """
    manifest, _ = _load_consistent(path)
    return manifest.get("step")


# ----------------------------------------------------------------------
# Resumable round loop.
# ----------------------------------------------------------------------

def _stack_rows(prev: dict | None, rows: list) -> dict | None:
    """Stack per-chunk metric rows (host side) and append to ``prev``."""
    if rows:
        new = {k: np.stack([_to_host(r[k]) for r in rows]) for k in rows[0]}
        if prev is None:
            return new
        return {k: np.concatenate([prev[k], new[k]]) for k in prev}
    return prev


def _saved_state(state: dict, full_rows=None) -> dict:
    """The round state as a tree of arrays: the full rows (``full_rows``
    gathers them from a sharded sim's window), the generator as its
    state."""
    w = state["w"] if full_rows is None else full_rows(state["w"])
    out = {"w": w, "gen": state["gen"].get_state(),
           "t": np.int64(state["t"])}
    if "sig" in state:
        out["sig"] = state["sig"]
    return out


def _live_state(saved: dict, device: torch.device,
                local_window=None) -> dict:
    """`_saved_state` undone: a fresh generator on ``device`` set to the
    saved state, and the rows (``local_window`` takes a sharded sim's
    window of them)."""
    gen = torch.Generator(device=device)
    gen.set_state(saved["gen"])
    w = saved["w"] if local_window is None else local_window(saved["w"])
    state = {"w": w, "gen": gen, "t": int(saved["t"])}
    if "sig" in saved:
        state["sig"] = saved["sig"]
    return state


def _row_like(sim, closed: bool) -> dict:
    """Zeros shaped as one chunk's metrics row, as `_stack_rows` keeps it:
    ``acc`` / ``loss`` (N,), ``bias`` (eval_every,)[, ``selected``
    (eval_every, N)], float32."""
    n, k = sim.n_clients, sim.eval_every
    row = {"acc": np.zeros((n,), np.float32),
           "loss": np.zeros((n,), np.float32),
           "bias": np.zeros((k,), np.float32)}
    if closed:
        row["selected"] = np.zeros((k, n), np.float32)
    return row


def _check_mesh(sim, mesh) -> None:
    """The reference's checks: a sharded sim needs a mesh that carries its
    model axis at its size."""
    if sim.model_shards == 1:
        return
    if mesh is None:
        raise ValueError(
            f"model_shards={sim.model_shards} needs a mesh with a "
            f"'{launch_mesh.MODEL_AXIS}' axis (e.g. "
            "launch.mesh.grid_model_mesh)"
        )
    if (launch_mesh.MODEL_AXIS not in mesh.axis_names
            or mesh.shape[launch_mesh.MODEL_AXIS] != sim.model_shards):
        raise ValueError(
            f"mesh axes {dict(mesh.shape)} do not provide "
            f"{launch_mesh.MODEL_AXIS}={sim.model_shards}"
        )


def run_resumable(
    sim,
    scenario,
    *,
    ckpt_dir: str,
    save_every: int = 1,
    resume: bool = True,
    stop_after: int | None = None,
    mesh=None,
) -> dict | None:
    """Run ``sim`` on ``scenario`` chunk-by-chunk with checkpointing.

    The host loop calls `sim.init_scan` once and `sim.advance_chunk` for
    chunks ``0 .. sim.n_chunks - 1``, the loop `sim.run_scenario` runs, so
    a run interrupted at any chunk and resumed from its checkpoint replays
    the same rounds with the same draws.  Each checkpoint records the round
    state (the generator as its state), the metric rows accumulated so far
    and the round index.

    Args:
      sim: a `repro_torch.fl.simulator.SimPrograms`.
      scenario: the scenario to run (any class — static, dynamic,
        chunked, closed-loop).
      ckpt_dir: checkpoint directory; overwritten at each save.
      save_every: checkpoint every k-th chunk (the final chunk always
        saves).
      resume: pick up from an existing checkpoint in ``ckpt_dir``; with
        ``resume=False`` the run restarts from round 0 (the old
        checkpoint is overwritten at the first save).
      stop_after: advance at most this many chunks in THIS call, then
        return None (simulated preemption — chunks past the last save
        cadence are recomputed on resume, identically).
      mesh: required iff ``sim.model_shards > 1``: a `launch.mesh` mesh
        providing the sim's model axis at size ``model_shards`` (other
        axes replicate).  Every rank of the mesh calls `run_resumable`;
        its first rank writes the checkpoints.

    Returns:
      The metrics `sim.run_scenario` returns, as numpy arrays: acc / loss
      (n_chunks, N), bias (n_rounds,)[, selected (n_rounds, N)]; or None
      when ``stop_after`` interrupted the run before completion.
    """
    if mesh is not None and not isinstance(mesh, launch_mesh.Mesh):
        raise TypeError(f"mesh= must be a launch.mesh.Mesh, got "
                        f"{type(mesh).__name__}")
    _check_mesh(sim, mesh)
    if mesh is not None and mesh.coords is None:
        raise ValueError(f"rank {mesh.rank} is not in the mesh "
                         f"{mesh.ranks.tolist()}")
    writer = mesh is None or mesh.rank == int(mesh.ranks.flat[0])
    scenario = scenario.prepare().to(sim.device)
    closed = scenario.policy_id is not None

    start = 0
    prev_rows = None
    state = None
    if resume:
        try:
            step = latest_step(ckpt_dir)
        except (FileNotFoundError, CorruptCheckpoint):
            # Absent or torn: restart from round 0 (the first save
            # overwrites whatever is there) rather than resume from
            # half-written state.
            step = None
        if step is not None:
            fresh = sim.init_scan(scenario)
            fresh["w"] = torch.zeros(
                (sim.n_clients, sim.n_segments, sim.seg_len),
                dtype=fresh["w"].dtype, device=sim.device)
            row = _row_like(sim, closed)
            like = {
                "state": _saved_state(fresh),
                "metrics": {k: np.zeros((step + 1,) + v.shape, v.dtype)
                            for k, v in row.items()},
                "round_idx": np.int32(0),
            }
            payload = restore(ckpt_dir, like)
            state = _live_state(payload["state"], sim.device,
                                sim.local_window)
            prev_rows = payload["metrics"]
            start = step + 1
    if start == 0:
        prev_rows = None
        state = sim.init_scan(scenario)

    rows: list = []
    advanced = 0
    for c in range(start, sim.n_chunks):
        if stop_after is not None and advanced >= stop_after:
            return None
        state, row = sim.advance_chunk(state, scenario)
        rows.append(row)
        advanced += 1
        if (c + 1) % save_every == 0 or c == sim.n_chunks - 1:
            prev_rows = _stack_rows(prev_rows, rows)
            rows = []
            saved = _saved_state(state, sim.full_rows)
            if writer:
                save(
                    ckpt_dir,
                    {
                        "state": saved,
                        "metrics": prev_rows,
                        "round_idx": np.int32((c + 1) * sim.eval_every),
                    },
                    step=c,
                )
            if mesh is not None:
                dist.barrier(group=mesh.group)

    metrics = _stack_rows(prev_rows, rows)
    if metrics is None:
        raise ValueError("run_resumable: sim has zero chunks to run")
    # A row holds eval_every rounds of bias (and selected masks): flatten
    # them to one entry a round, as run_scenario returns them.
    metrics["bias"] = metrics["bias"].reshape(-1)
    if "selected" in metrics:
        metrics["selected"] = metrics["selected"].reshape(-1, sim.n_clients)
    return metrics
