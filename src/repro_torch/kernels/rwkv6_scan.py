"""rwkv6 time-mix scan (K3): the CUDA launch.

Port of the reference package's Pallas kernel `kernels/rwkv6_scan.py`; the
kernel itself is `csrc/rwkv6_scan.cu` (its header says what bounds each
body and how it is laid out).  This module holds what surrounds the
launch, in plain Python that the CPU tests reach:

  * `check_shapes` checks the (B, S, H, D) / (H, D) shapes for both paths;
  * `body` names the kernel body that serves a dtype and head dim:
    "chunked" (bf16 r/k/v at D = 64, the rwkv6-1.6b serving path: steps of
    16 tokens on the tensor cores, fed by a `cp.async` copy ring) or
    "token" (float32, and bf16 at D = 16 / 32: the recurrence token by
    token on the CUDA cores).  Both take any log decay w <= 0;
  * `kernel_strides` and `check_launch` give the element strides the kernel
    reads and refuse what a body does not take: the chunked body copies
    16-byte pieces, so each input's address and its B, S and H strides in
    bytes must be multiples of 16;
  * `launch` checks the device, allocates the output (and the float32
    final state) with `torch.empty`, and calls the compiled kernel on the
    current stream.  r, k, v and w reach the kernel through their strides,
    with no transposed or cast copy; only ``u`` (H·D values) is made
    float32 and contiguous.  ``tile`` (tokens staged per step) concerns
    the token body only.

Dispatch between the kernel and its plain version, the build and the
launch counter live in `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

from . import count_launch

HEAD_DIMS = (16, 32, 64)
BODIES = ("token", "chunked")
MAX_TILE = 64             # most tokens the token body stages in shared memory
# Tokens the token body stages per step.  At B=8, S=2048, H=32, D=64 (bf16)
# tiles of 64 need 131 KB of shared memory, one block per SM, and took
# 991 us against 710 us for tiles of 32 (66 KB, every block resident) on an
# H100 SXM at 700 W (an earlier chip_smoke.py phase 7, which timed both).
TILE = 32
COPY_BYTES = 16           # the chunked body's cp.async pieces
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BLOCKS = 2**31 - 1   # one block per (batch, head): grid x limit
# Launches by body, counted where `launch` starts one.
BODY_LAUNCHES = {name: 0 for name in BODIES}


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


def body(dtype: torch.dtype, d: int) -> str:
    """The body that serves r/k/v of ``dtype`` at head dim ``d``."""
    return "chunked" if dtype == torch.bfloat16 and d == 64 else "token"


def kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of the B, S and H axes as the kernel reads them.  An
    axis of size 1 is never stepped along, so its stride is replaced by D
    (a value both bodies take)."""
    return tuple(t.shape[3] if t.shape[i] == 1 else t.stride(i)
                 for i in range(3))


def check_launch(r, k, v, w, u, *, tile: int, which: str | None = None) -> str:
    """Everything `launch` checks but the device: raises on what the named
    body (default: `body` of r's dtype and D) does not take, and returns
    that body's name."""
    if r.dtype not in _DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r, k, v must share one dtype, float32 "
                        f"or bfloat16; got {r.dtype}, {k.dtype}, {v.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"rwkv6_scan: w (log decay) must be float32, got "
                        f"{w.dtype}")
    b, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head dim {d} not in {HEAD_DIMS}")
    which = body(r.dtype, d) if which is None else which
    if which not in BODIES:
        raise ValueError(f"rwkv6_scan: body must be one of {BODIES}, got "
                         f"{which!r}")
    if which == "chunked" and body(r.dtype, d) != "chunked":
        raise ValueError(f"rwkv6_scan: the chunked body takes bfloat16 at "
                         f"D = 64, got {r.dtype} at D = {d}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(3) != 1:
            raise ValueError(f"rwkv6_scan: {name} must be contiguous in its "
                             f"last axis, got strides {t.stride()}")
        if which == "chunked":
            steps = [st * t.element_size() for st in kernel_strides(t)]
            if t.data_ptr() % COPY_BYTES or any(st % COPY_BYTES
                                                for st in steps):
                raise ValueError(
                    f"rwkv6_scan: the chunked body copies {COPY_BYTES}-byte "
                    f"pieces; {name}'s address and its B, S, H strides in "
                    f"bytes {tuple(steps)} must be multiples of {COPY_BYTES}")
    if b * h > _MAX_BLOCKS:
        raise ValueError(f"rwkv6_scan: B*H = {b * h} exceeds the grid limit")
    if which == "token" and not 1 <= tile <= MAX_TILE:
        raise ValueError(f"rwkv6_scan: tile must be in [1, {MAX_TILE}], got "
                         f"{tile}")
    return which


def launch(lib: ctypes.CDLL, r, k, v, w, u, *, tile: int,
           return_state: bool, which: str | None = None):
    """Run the CUDA kernel's body ``which`` (default: `body` of r's dtype
    and D).  Returns (out, state or None).

    Raises on anything the body does not take, and if the launch is refused
    (the C function returns ``cudaGetLastError()``).
    """
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}; every "
                             f"input must lie on one CUDA device")
    which = check_launch(r, k, v, w, u, tile=tile, which=which)
    b, s, h, d = r.shape
    u = u.to(torch.float32).contiguous()
    out = torch.empty((b, s, h, d), dtype=r.dtype, device=dev)
    state = (torch.empty((b, h, d, d), dtype=torch.float32, device=dev)
             if return_state else None)
    if b * h == 0:
        return out, state
    strides = (ctypes.c_longlong * 12)(
        *(st for t in (r, k, v, w) for st in kernel_strides(t)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.rwkv6_scan_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), out.data_ptr(),
            None if state is None else state.data_ptr(),
            b, s, h, d, tile, strides,
            _DTYPE_CODES[r.dtype], BODIES.index(which), stream,
        )
    if err != 0:
        raise RuntimeError(f"rwkv6_scan kernel launch failed for r "
                           f"{tuple(r.shape)} ({which} body): CUDA error "
                           f"{err}")
    count_launch(BODY_LAUNCHES, which)
    return out, state


def smem_bytes(lib: ctypes.CDLL, which: str, d: int = 64,
               tile: int = TILE) -> int:
    """Dynamic shared memory of one block of body ``which``."""
    return lib.rwkv6_scan_smem_bytes(BODIES.index(which), d, tile)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures (pointers and the stream as c_void_p)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.rwkv6_scan_launch.argtypes = (
        [vp] * 7 + [i32] * 5 + [ctypes.POINTER(ctypes.c_longlong), i32, i32,
                                vp])
    lib.rwkv6_scan_launch.restype = i32
    lib.rwkv6_scan_smem_bytes.argtypes = [i32, i32, i32]
    lib.rwkv6_scan_smem_bytes.restype = i32
    return lib
