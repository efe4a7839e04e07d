"""Public entry points for the port's kernels: build, dispatch, count.

  * Build at first use: each ``csrc/<name>.cu`` is compiled by ``nvcc`` for
    ``sm_90a`` into a shared library with a plain C interface, named by a
    hash of its source, under ``kernels/build/`` (listed in .gitignore), and
    loaded with ctypes.  `build_all` starts one ``nvcc`` per source, all at
    once.
  * Dispatch by tensor device: a tensor on the CPU goes to the kernel's
    plain version (`kernels.ref`); a CUDA tensor goes to the kernel, or the
    call raises.  There is no fallback from one to the other.
  * `LAUNCHES` counts kernel launches by name, incremented where the kernel
    is launched and nowhere else, so a run can show that its main path went
    through the kernel.
  * Threads and processes: a scenario server's dispatcher and a router's
    replicas launch K1 outside the main thread, and the ranks of a
    multi-rank run (`launch.mesh.spawn`) each load it.  `load_library`
    builds and binds a kernel once under one lock, `build_all` holds a
    file lock per kernel in the build directory while it checks for and
    builds that kernel (so ranks starting at once compile each source
    once, the others waiting and then loading the library), stages each
    build in a file of its own process and thread, and every launch
    counter is incremented under a lock (`kernels.count_launch`).
  * K2 and K3 have no backward kernel (nor has the reference): on the card
    `flash_attention` and `rwkv6_scan` raise where a gradient would flow
    through them (`refuse_autograd`), instead of returning an output that
    autograd cannot see past.  Training callers run the plain forward.
  * K1 is the custom operator ``repro_torch::ra_aggregate``
    (`torch.library.custom_op`) with a fake (meta) version and a
    `torch.func.vmap` rule, the counterpart of the reference's
    ``custom_vmap`` rules: any vmap over a scenario grid, nested or not,
    folds into one rank-4 launch (`_ra_vmap_rule`).
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .. import grad_tracking, resolve_device
from . import count_launch
from . import flash_attention as _fa
from . import ra_aggregate as _ra
from . import ref
from . import rwkv6_scan as _rwkv

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: dict[str, int] = {"ra_aggregate": 0, "rwkv6_scan": 0,
                             "flash_attention": 0}

_BINDERS = {"ra_aggregate": _ra.bind, "rwkv6_scan": _rwkv.bind,
            "flash_attention": _fa.bind}
_LIBS: dict[str, ctypes.CDLL] = {}
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def lib_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build_all(names=None) -> dict[str, str]:
    """Compile every named kernel (default: all of ``csrc/``) that is not
    built yet, one ``nvcc`` process per source, all started together.

    Returns ``{name: compiler output}`` (``-Xptxas -v``: registers, shared
    memory and spills per instantiation).  Raises if any build fails.
    Each kernel's file lock (``build/<name>.lock``) is held from the check
    to the end of its build, taken in name order, so processes building at
    once compile each source once.
    """
    names = sorted(p.stem for p in CSRC.glob("*.cu")) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with contextlib.ExitStack() as locks:
        for name in sorted(set(names)):
            lock = locks.enter_context(open(BUILD_DIR / f"{name}.lock", "w"))
            fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(names)


def _build_locked(names) -> dict[str, str]:
    """`build_all`'s body, under the kernels' file locks."""
    procs = {}
    for name in names:
        target = lib_path(name)
        if target.exists():
            continue
        tmp = target.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    logs, failed = {}, []
    for name, (proc, tmp, target) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(name)
        else:
            os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load_library(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built on first use (once, whichever
    thread gets here first; the others wait for it)."""
    with _LIB_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all([name])
            lib = _BINDERS[name](ctypes.CDLL(str(lib_path(name))))
            _LIBS[name] = lib
        return lib


def refuse_autograd(name: str, tensors) -> None:
    """Raise if a gradient would flow through kernel ``name``: grad mode is
    on and an input requires grad, or an input is a `torch.func`
    grad-tracking tensor.  The kernel writes into a fresh output that no
    autograd graph records, so the gradient upstream of it would be lost."""
    if any((torch.is_grad_enabled() and t.requires_grad) or grad_tracking(t)
           for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and a gradient would "
            f"flow through this call; run the plain forward (impl='torch') "
            f"to differentiate, or call it under torch.no_grad(); a backward "
            f"kernel is in ROADMAP.md Queue 2")


_REFS = {"ra_normalized": ref.ra_aggregate_ref,
         "substitution": ref.ra_substitution_ref}


@torch.library.custom_op("repro_torch::ra_aggregate", mutates_args=())
def _ra_aggregate_op(w_seg: torch.Tensor, p: torch.Tensor, e: torch.Tensor,
                     tx: torch.Tensor | None, mode: str) -> torch.Tensor:
    """K1 on tensors of one device: the plain version on the CPU, the CUDA
    kernel on the card (one launch, counted here)."""
    w4, p2, e4, tx3 = _ra.broadcast_batch(w_seg, p, e, tx, mode=mode)
    if w4.device.type == "cpu":
        out = _REFS[mode](w4, p2, e4, tx3)
    else:
        out = _ra.launch(load_library("ra_aggregate"), w4, p2, e4, tx3,
                         mode=mode)
        count_launch(LAUNCHES, "ra_aggregate")
    return out if w_seg.ndim == 4 else out[0]


@_ra_aggregate_op.register_fake
def _ra_aggregate_fake(w_seg, p, e, tx, mode):
    return torch.empty_like(w_seg)


def _kernel_batch(t: torch.Tensor) -> torch.Tensor:
    """A batched (B, ...) operand laid out as the kernel reads it: trailing
    axes contiguous and the batch stride one entry.  A vmapped ``e`` or
    ``tx`` can arrive as a strided view (a vmap over a non-leading axis);
    that costs one copy of the operand here, once per folded launch."""
    ok = t[0].is_contiguous() and (t.shape[0] == 1
                                   or t.stride(0) == t[0].numel())
    return t if ok else t.contiguous()


def _fold(t, dim, shared_rank: int, b: int, g: int):
    """``p`` / ``e`` / ``tx`` for the launch of a vmapped call.

    ``dim`` is the operand's vmapped axis (None: not vmapped at this
    level); ``shared_rank`` its rank when shared across the call's own
    batch (1, 3, 2).  ``g`` is None for a rank-3 call, which becomes one
    rank-4 launch of B = ``b``: an unvmapped operand stays shared, at batch
    stride 0, with no copy.  For a rank-4 call of G = ``g`` entries the
    launch has B = b * g entries and one batch stride, so an operand
    shared along only one of the two axes is expanded and copied (N floats
    for ``p``; a whole mask for ``e`` or ``tx``, which no caller of the
    port passes).
    """
    if t is None:
        return None
    if dim is not None:
        t = t.movedim(dim, 0)
    if g is None:
        return t.contiguous() if dim is None else _kernel_batch(t)
    per_rank = t.ndim - (0 if dim is None else 1)
    if dim is None:
        if per_rank == shared_rank:
            return t.contiguous()
        t = t[None].expand((b,) + tuple(t.shape))
    elif per_rank == shared_rank:
        t = t[:, None].expand((b, g) + tuple(t.shape[1:]))
    return _kernel_batch(t.reshape((b * g,) + tuple(t.shape[2:])))


def _ra_vmap_rule(info, in_dims, w_seg, p, e, tx, mode):
    """Fold a vmapped K1 call into one launch.

    Each vmapped axis moves to the front.  A vmapped rank-3 call becomes
    one rank-4 call of B = batch size; a vmapped rank-4 call of G entries
    becomes one rank-4 call of B * G.  Nested vmaps reach this rule one
    level at a time, innermost first: the inner level's rank-4 call is
    folded again by the outer level, so they too end in one launch.  The
    call below goes to the next vmap level or, at the last one, to the
    operator itself (the kernel on the card, the plain version on the
    CPU).
    """
    b = info.batch_size
    w_dim, p_dim, e_dim, tx_dim = in_dims[:4]
    if w_dim is None:          # one model, many masks: w is copied B times
        w = w_seg[None].expand((b,) + tuple(w_seg.shape))
    else:
        w = w_seg.movedim(w_dim, 0)
    g = None if w.ndim == 4 else w.shape[1]
    if g is not None:
        w = w.reshape((b * g,) + tuple(w.shape[2:]))
    out = torch.ops.repro_torch.ra_aggregate(
        w.contiguous(), _fold(p, p_dim, 1, b, g), _fold(e, e_dim, 3, b, g),
        _fold(tx, tx_dim, 2, b, g), mode)
    if g is not None:
        out = out.reshape((b, g) + tuple(out.shape[1:]))
    return out, 0


_ra_aggregate_op.register_vmap(_ra_vmap_rule)


def ra_aggregate(w_seg: torch.Tensor, p: torch.Tensor, e: torch.Tensor, *,
                 tx: torch.Tensor | None = None, mode: str = "ra_normalized",
                 device: str | torch.device | None = None) -> torch.Tensor:
    """Fused R&A aggregation (paper eq. 6 / fused substitution baseline).

    w_seg: (N, L, K) or batched (B, N, L, K), float32 or bfloat16;
    p: (N,)/(B, N); e: (N, N, L)/(B, N, N, L) in bool/uint8/float32;
    ``tx`` ((N, L)/(B, N, L), optional) selects the transmit-mask variant.
    Returns the receiver-major aggregate in ``w_seg``'s shape and dtype.

    ``device`` (default: the CUDA card) is where the call runs; every
    input must already lie there.  Without a card, pass ``device="cpu"``.

    Under `torch.func.vmap` (a scenario grid) the call folds into one
    rank-4 launch per call site, however many vmap levels wrap it
    (`_ra_vmap_rule`).
    """
    dev = resolve_device(device)
    for name, t in (("w_seg", w_seg), ("p", p), ("e", e), ("tx", tx)):
        if t is not None and t.device.type != dev.type:
            raise ValueError(f"ra_aggregate: {name} is on {t.device}, the "
                             f"call runs on {dev}")
    _ra.broadcast_batch(w_seg, p, e, tx, mode=mode)    # the shape checks
    return torch.ops.repro_torch.ra_aggregate(w_seg, p, e, tx, mode)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
               return_state: bool = False,
               device: str | torch.device | None = None):
    """The rwkv6 time-mix scan (see `kernels.ref.rwkv6_scan_ref`).

    r, k, v: (B, S, H, D) float32 or bfloat16; w: (B, S, H, D) float32 log
    decay, any value <= 0; u: (H, D) bonus.  Returns out (B, S, H, D) in
    r's dtype and, with ``return_state``, the final state (B, H, D, D) in
    float32.

    On the card the body is chosen by dtype and D (`rwkv6_scan.body`):
    bf16 at D = 64 runs the chunked body (steps of 16 tokens on the tensor
    cores, fed by a ``cp.async`` ring), which copies 16-byte pieces, so each
    input's address and its B, S and H strides in bytes must be multiples
    of 16; float32, and bf16 at D = 16 / 32, run the token body (the
    recurrence token by token), which stages ``min(S, rwkv6_scan.TILE)``
    tokens per step.  ``chunk`` is the reference's chunk length, kept so
    that calls read as the reference's; no path's result depends on it.
    ``device`` (default: the CUDA card) is where the call runs; every input
    must already lie there.  On the card it raises where a gradient would
    flow through it (`refuse_autograd`).
    """
    dev = resolve_device(device)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device.type != dev.type:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}, the "
                             f"call runs on {dev}")
    _rwkv.check_shapes(r, k, v, w, u)
    if chunk < 1:
        raise ValueError(f"rwkv6_scan: chunk must be positive, got {chunk}")
    if dev.type == "cpu":
        return ref.rwkv6_scan_ref(r, k, v, w, u, return_state=return_state)
    refuse_autograd("rwkv6_scan", (r, k, v, w, u))
    tile = max(1, min(r.shape[1], _rwkv.TILE))
    out, state = _rwkv.launch(load_library("rwkv6_scan"), r, k, v, w, u,
                              tile=tile, return_state=return_state)
    count_launch(LAUNCHES, "rwkv6_scan")
    return (out, state) if return_state else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True,
                    window: int | None = None,
                    device: str | torch.device | None = None) -> torch.Tensor:
    """Causal (or full) grouped-query attention forward, optionally with a
    sliding window (see `kernels.ref.flash_attention_ref`).

    q: (B, S, H, D); k, v: (B, S, KV, D) with H a multiple of KV, one dtype
    (float32 or bfloat16).  Query head h reads kv head h // (H // KV).
    Returns (B, S, H, D) in q's dtype.  On the card each tensor's last axis
    must be contiguous and its rows start on 16 bytes; in bfloat16 at
    D = 64, 128 or 256 (read by TMA) the byte strides of the B, S and head
    axes must also be nonzero, so a broadcast (stride-0) k or v is refused.

    ``device`` (default: the CUDA card) is where the call runs; every input
    must already lie there.  On the card it raises where a gradient would
    flow through it (`refuse_autograd`).
    """
    dev = resolve_device(device)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != dev.type:
            raise ValueError(f"flash_attention: {name} is on {t.device}, the "
                             f"call runs on {dev}")
    _fa.check_shapes(q, k, v)
    _fa.check_window(window)
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window)
    refuse_autograd("flash_attention", (q, k, v))
    out = _fa.launch(load_library("flash_attention"), q, k, v, scale=scale,
                     causal=causal, window=window)
    count_launch(LAUNCHES, "flash_attention")
    count_launch(_fa.MASK_LAUNCHES, "causal" if causal else "full")
    return out
