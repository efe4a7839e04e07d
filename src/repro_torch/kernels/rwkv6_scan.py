"""rwkv6 time-mix scan (K3): the CUDA launch.

Port of the reference package's Pallas kernel `kernels/rwkv6_scan.py`; the
kernel itself is `csrc/rwkv6_scan.cu` (its header says what bounds it and
how it is laid out).  This module holds what surrounds the launch:

  * `check_shapes` checks the (B, S, H, D) / (H, D) shapes for both paths;
  * `launch` checks dtype, device and layout, allocates the output (and the
    float32 final state) with `torch.empty`, and calls the compiled kernel
    on the current stream.  r, k, v and w reach the kernel through their
    strides, with no transposed or cast copy; only ``u`` (H·D values) is
    made float32 and contiguous.

Dispatch between the kernel and its plain version, the build and the
launch counter live in `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 64)
MAX_TILE = 64             # most tokens the kernel stages in shared memory
# Tokens staged per step on the serving path.  At B=8, S=2048, H=32, D=64
# (bf16) tiles of 64 need 131 KB of shared memory, one block per SM, and
# took 991 us against 710 us for tiles of 32 (66 KB, every block resident)
# on an H100 SXM at 700 W (chip_smoke.py phase 7).
TILE = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = 2**31 - 1   # one block per (batch, head): grid x limit


def check_shapes(r, k, v, w, u) -> None:
    if r.ndim != 4:
        raise ValueError(f"rwkv6_scan: r must be (B, S, H, D), got "
                         f"{tuple(r.shape)}")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"rwkv6_scan: {name} {tuple(t.shape)} must match "
                             f"r {tuple(r.shape)}")
    if tuple(u.shape) != tuple(r.shape[2:]):
        raise ValueError(f"rwkv6_scan: u must be (H, D) = "
                         f"{tuple(r.shape[2:])}, got {tuple(u.shape)}")


def launch(lib: ctypes.CDLL, r, k, v, w, u, *, tile: int,
           return_state: bool):
    """Run the CUDA kernel.  Returns (out, state or None).

    Raises on anything the kernel does not take, and if the launch is
    refused (the C function returns ``cudaGetLastError()``).
    """
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}; every "
                             f"input must lie on one CUDA device")
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r, k, v must share one dtype, float32 "
                        f"or bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: w (log decay) must be float32, got "
                        f"{w.dtype}")
    b, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {d} not in {HEAD_DIMS}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"rwkv6_scan: {name} must be contiguous in its "
                             f"last axis, got strides {t.stride()}")
    if b * h > _MAX_BLOCKS:
        raise ValueError(f"rwkv6_scan: B*H = {b * h} exceeds the grid limit")
    if not 1 <= tile <= MAX_TILE:
        raise ValueError(f"rwkv6_scan: tile must be in [1, {MAX_TILE}], got "
                         f"{tile}")
    u = u.to(torch.float32).contiguous()
    out = torch.empty((b, s, h, d), dtype=r.dtype, device=dev)
    state = (torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
             if return_state else None)
    if b * h == 0:
        return out, state
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (r, k, v, w) for st in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(),
            None if state is None else state.data_ptr(),
            b, s, h, d, tile, strides,
            _DTYPE_CODES[r.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed for r "
                           f"{tuple(r.shape)}: CUDA error {err}")
    return out, state


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature (pointers and the stream as c_void_p)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = (
        [vp] * 7 + [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong), i32, vp])
    lib.rwkv6_scan_launch.restype = i32
    return lib
