"""R&A segment aggregation (eq. 6), both modes, batched: the CUDA launch.

Port of the reference package's Pallas kernel `kernels/ra_aggregate.py`;
the kernel itself is `csrc/ra_aggregate.cu` (its header says what bounds
it and how it is laid out).  This module holds what surrounds the launch:

  * `broadcast_batch` checks shapes as the reference's `ra_aggregate` does
    (same messages) and lifts rank-3 inputs, and ``p`` / ``e`` / ``tx``
    shared across a batch, to rank-4 views without copying;
  * `launch` checks dtype, device and layout, allocates the output with
    `torch.empty`, and calls the compiled kernel on the current stream;
  * `plan` reports the launch the kernel would make for a shape (body,
    block, shared memory, grid, tiles, resident blocks an SM).

The mask ``e`` and the transmit mask ``tx`` reach the kernel as they come
(bool/uint8 or float32); only ``p`` (N floats) is cast to float32.
Dispatch between the kernel and its plain version, the build and the
launch counter live in `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import count_launch

MODES = ("ra_normalized", "substitution")

_W_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK_CODES = {torch.bool: 0, torch.uint8: 0, torch.float32: 1}
BODIES = ("register", "shared")   # N <= 16, N > 16
PLAN_KEYS = ("body", "threads", "smem_bytes", "blocks", "tiles",
             "blocks_per_sm", "receivers_per_warp", "slabs")
# Launches by variant (without / with a transmit mask), by batch size B,
# and by shape (B, N, L, K), counted where `launch` starts one.
VARIANT_LAUNCHES = {"plain": 0, "tx": 0}
BATCH_LAUNCHES: dict[int, int] = {}
SHAPE_LAUNCHES: dict[tuple[int, int, int, int], int] = {}


def broadcast_batch(w_seg, p, e, tx=None, *, mode):
    """Validate and lift the inputs to (B, N, L, K), (B, N), (B, N, N, L),
    (B, N, L) views.  Shared (unbatched) ``p``/``e``/``tx`` are expanded
    with a zero batch stride, never copied."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if w_seg.ndim == 4:
        b, n, l, _ = w_seg.shape
        if p.ndim == 1:   # shared weights across the batch
            p = p[None].expand((b,) + tuple(p.shape))
        if e.ndim == 3:   # shared mask across the batch
            e = e[None].expand((b,) + tuple(e.shape))
        if tuple(p.shape) != (b, n) or tuple(e.shape) != (b, n, n, l):
            raise ValueError(
                f"batched ra_aggregate: w_seg {tuple(w_seg.shape)} needs p "
                f"(N,)/(B, N) and e (N, N, L)/(B, N, N, L); got p "
                f"{tuple(p.shape)}, e {tuple(e.shape)}"
            )
        if tx is not None:
            if tx.ndim == 2:  # shared transmit mask across the batch
                tx = tx[None].expand((b,) + tuple(tx.shape))
            if tuple(tx.shape) != (b, n, l):
                raise ValueError(
                    f"batched ra_aggregate: tx must be (N, L)/(B, N, L), got "
                    f"{tuple(tx.shape)} for w_seg {tuple(w_seg.shape)}"
                )
        return w_seg, p, e, tx
    if w_seg.ndim != 3:
        raise ValueError(
            f"ra_aggregate: w_seg must be (N, L, K) or (B, N, L, K), got "
            f"{tuple(w_seg.shape)}"
        )
    n, l, _ = w_seg.shape
    if tuple(p.shape) != (n,) or tuple(e.shape) != (n, n, l):
        raise ValueError(
            f"ra_aggregate: w_seg {tuple(w_seg.shape)} needs p (N,) and e "
            f"(N, N, L); got p {tuple(p.shape)}, e {tuple(e.shape)}"
        )
    if tx is not None and tuple(tx.shape) != (n, l):
        raise ValueError(
            f"ra_aggregate: tx must be (N, L) = ({n}, {l}), got "
            f"{tuple(tx.shape)}"
        )
    return (w_seg[None], p[None], e[None],
            None if tx is None else tx[None])


def _batch_stride(t: torch.Tensor, name: str) -> int:
    """Elements between batch entries: 0 when shared, else the entry size.
    The trailing axes must be contiguous (the kernel computes offsets)."""
    if not t[0].is_contiguous():
        raise ValueError(f"ra_aggregate: {name} must be contiguous in its "
                         f"trailing axes, got strides {t.stride()}")
    if t.shape[0] == 1 or t.stride(0) == 0:
        return 0
    if t.stride(0) != t[0].numel():
        raise ValueError(f"ra_aggregate: {name} batch stride {t.stride(0)} "
                         f"is neither 0 nor {t[0].numel()}")
    return t.stride(0)


def _mask_code(t: torch.Tensor, name: str) -> int:
    if t.dtype not in _MASK_CODES:
        raise TypeError(f"ra_aggregate: {name} must be bool, uint8 or "
                        f"float32, got {t.dtype}")
    return _MASK_CODES[t.dtype]


def launch(lib: ctypes.CDLL, w4: torch.Tensor, p2: torch.Tensor,
           e4: torch.Tensor, tx3: torch.Tensor | None, *,
           mode: str) -> torch.Tensor:
    """Run the CUDA kernel on rank-4 views from `broadcast_batch`.

    Raises on anything the kernel does not take, and if the launch is
    refused (the C function returns ``cudaGetLastError()``).
    """
    dev = w4.device
    tensors = [("w_seg", w4), ("p", p2), ("e", e4)]
    if tx3 is not None:
        tensors.append(("tx", tx3))
    for name, t in tensors:
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"ra_aggregate: {name} is on {t.device}; every "
                             f"input must lie on one CUDA device")
    if w4.dtype not in _W_CODES:
        raise TypeError(f"ra_aggregate: w_seg must be float32 or bfloat16, "
                        f"got {w4.dtype}")
    if not w4.is_contiguous():
        raise ValueError("ra_aggregate: w_seg must be contiguous")
    b, n, l, k = w4.shape
    p2 = p2.to(torch.float32)
    e_code = _mask_code(e4, "e")
    tx_code = 0 if tx3 is None else _mask_code(tx3, "tx")
    out = torch.empty_like(w4)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.ra_aggregate_launch(
            w4.data_ptr(), p2.data_ptr(), e4.data_ptr(),
            None if tx3 is None else tx3.data_ptr(), out.data_ptr(),
            b, n, l, k,
            _batch_stride(p2, "p"), _batch_stride(e4, "e"),
            0 if tx3 is None else _batch_stride(tx3, "tx"),
            MODES.index(mode), _W_CODES[w4.dtype], e_code, tx_code, stream,
        )
    if err != 0:
        raise RuntimeError(f"ra_aggregate kernel launch failed for w_seg "
                           f"{tuple(w4.shape)}: CUDA error {err} (a refused "
                           f"launch: e.g. N too large for shared memory)")
    count_launch(VARIANT_LAUNCHES, "plain" if tx3 is None else "tx")
    count_launch(BATCH_LAUNCHES, b)
    count_launch(SHAPE_LAUNCHES, (b, n, l, k))
    return out


def plan(lib: ctypes.CDLL, b: int, n: int, l: int, k: int,
         dtype: torch.dtype) -> dict:
    """The launch the kernel makes for w_seg (B, N, L, K) of ``dtype``
    (16-byte aligned): `PLAN_KEYS`, with ``body`` named from `BODIES`."""
    info = (ctypes.c_longlong * len(PLAN_KEYS))()
    err = lib.ra_aggregate_plan(b, n, l, k, _W_CODES[dtype], info)
    if err != 0:
        raise RuntimeError(f"ra_aggregate plan for {(b, n, l, k)}: CUDA "
                           f"error {err}")
    out = dict(zip(PLAN_KEYS, info))
    out["body"] = BODIES[out["body"]]
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures (pointers and the stream as c_void_p)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.ra_aggregate_launch.argtypes = (
        [vp] * 5 + [i32] * 4 + [i64] * 3 + [i32] * 4 + [vp])
    lib.ra_aggregate_launch.restype = i32
    lib.ra_aggregate_plan.argtypes = [i32] * 5 + [ctypes.POINTER(i64)]
    lib.ra_aggregate_plan.restype = i32
    return lib
