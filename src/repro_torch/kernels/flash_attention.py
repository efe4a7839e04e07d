"""Flash-attention forward (K2): the CUDA launch.

Port of the reference package's Pallas kernel `kernels/flash_attention.py`;
the kernel itself is `csrc/flash_attention.cu` (its header says what bounds
it and how it is laid out).  This module holds what surrounds the launch:

  * `check_shapes` checks the (B, S, H, D) / (B, S, KV, D) shapes for both
    paths;
  * `launch` checks dtype, device and layout, allocates the output with
    `torch.empty`, and calls the compiled kernel on the current stream.  q,
    k and v reach the kernel through their strides, with no transposed or
    cast copy; the kernel picks its own tile (64 query rows by 64 keys), so
    the reference's ``block_q`` / ``block_k`` are not taken.

Dispatch between the kernel and its plain version, the build and the
launch counter live in `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = 2**31 - 1   # one block per (64-row query tile, batch, head)


def check_shapes(q, k, v) -> None:
    if q.ndim != 4:
        raise ValueError(f"flash_attention: q must be (B, S, H, D), got "
                         f"{tuple(q.shape)}")
    b, s, h, d = q.shape
    if k.ndim != 4 or (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d):
        raise ValueError(f"flash_attention: k must be (B, S, KV, D) = "
                         f"({b}, {s}, KV, {d}), got {tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"flash_attention: v {tuple(v.shape)} must match k "
                         f"{tuple(k.shape)}")
    if k.shape[2] < 1 or h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} query heads are not a "
                         f"multiple of {k.shape[2]} kv heads")


def launch(lib: ctypes.CDLL, q, k, v, *, scale: float, causal: bool):
    """Run the CUDA kernel.  Returns out (B, S, H, D) in q's dtype.

    Raises on anything the kernel does not take, and if the launch is
    refused (the C function returns ``cudaGetLastError()``).
    """
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}; "
                             f"every input must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, s, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()     # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous in "
                             f"its last axis, got strides {t.stride()}")
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:3]):
            raise ValueError(f"flash_attention: every row of {name} must "
                             f"start on 16 bytes (strides {t.stride()})")
    if -(-s // 64) * b * h > _MAX_BLOCKS:
        raise ValueError(f"flash_attention: {tuple(q.shape)} exceeds the "
                         f"grid limit")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if b * s * h == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        *(st for t in (q, k, v) for st in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], d, strides, float(scale), int(causal),
            _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed for q "
                           f"{tuple(q.shape)}: CUDA error {err}")
    return out


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as c_void_p)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [i32] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, i32, vp])
    lib.flash_attention_launch.restype = i32
    return lib
