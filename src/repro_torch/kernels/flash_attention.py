"""Flash-attention forward (K2): the CUDA launch.

Port of the reference package's Pallas kernel `kernels/flash_attention.py`;
the kernel itself is `csrc/flash_attention.cu` (its header says what bounds
it and how each body is laid out).  This module holds what surrounds the
launch, in plain Python that the CPU tests reach:

  * `check_shapes` checks the (B, S, H, D) / (B, S, KV, D) shapes for both
    paths;
  * `body` names the kernel body that serves a dtype and head dim, as the
    source's `pick_d` chooses it: "wgmma" (TMA, `wgmma`, a persistent
    grid; bf16 at D = 64, 128 or 256, gemma-7b's D = 256 with Q read from
    shared memory) or "simt" (`mma.sync` in bf16, FFMA in float32; every
    other case); `key_tile` the keys a body stages per tile;
  * `grid` gives the launch's blocks and work tiles (the order in which
    the Hopper body's persistent blocks walk the work tiles is the kernel's
    own, `hopper::Work`);
  * `kernel_strides` and `tma_map` give the element strides the kernel
    reads and the TMA tensor map's dims and byte strides, and refuse what
    TMA cannot take;
  * `check_window` checks a sliding window (keys ``window`` or more rows
    back masked, as the reference's `layers.attention` masks them);
  * `launch` checks dtype, device and layout, allocates the output with
    `torch.empty`, and calls the compiled kernel on the current stream.  q,
    k and v reach the kernel through their strides, with no transposed or
    cast copy; the kernel picks its own tiles, so the reference's
    ``block_q`` / ``block_k`` are not taken.

Dispatch between the kernel and its plain version, the build and the
launch counter live in `kernels.ops`.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_TILES = 2**31 - 1    # work tiles: one per (query tile, batch, head)
# Query rows a work tile and threads a block, by body.
BLOCK = {"wgmma": (128, 256), "simt": (64, 128)}
TMA_MAX_STRIDE = 2**40    # byte strides: multiples of 16 below this
ENCODE_FAILED = 100000    # the C launch's code for a refused tensor map
# Launches by mask, counted where `ops.flash_attention` launches the kernel
# (beside its total in `ops.LAUNCHES`): "causal", or "full" (bidirectional,
# an encoder's).
MASK_LAUNCHES: dict[str, int] = {"causal": 0, "full": 0}


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


def check_window(window: int | None) -> None:
    if window is not None and (isinstance(window, bool) or int(window) != window
                               or window < 1):
        raise ValueError(f"flash_attention: window must be a positive "
                         f"integer or None, got {window!r}")


def body(dtype: torch.dtype, d: int) -> str:
    """The body that serves ``dtype`` at head dim ``d``."""
    return ("wgmma" if dtype == torch.bfloat16 and d in (64, 128, 256)
            else "simt")


def key_tile(dtype: torch.dtype, d: int) -> int:
    """Keys a staged K / V tile of the body that serves ``dtype`` at head
    dim ``d`` (the lazy softmax's unit of work in the Hopper body): 64 in
    the first body; 128 in the Hopper body, 80 at D = 256 (`hopper::Smem`:
    two stages of 128-key K and V tiles beside Q would not fit in shared
    memory there; 80 keys fill it)."""
    if body(dtype, d) == "simt":
        return 64
    return 80 if d == 256 else 128


def grid(shape, dtype: torch.dtype, sms: int | None = None
         ) -> tuple[int, int, int, int]:
    """(blocks, threads a block, work tiles, query rows a work tile) for q
    of ``shape`` (B, S, H, D).  The first body runs one block per work
    tile; the Hopper body a persistent grid of min(work tiles, ``sms``)
    blocks, ``sms`` being the card's SM count (one block per work tile when
    it is not given); at D = 256, where a block takes its work tiles in
    pairs (`hopper::Work` by head), min(pairs, ``sms``)."""
    b, s, h, d = shape
    rows, threads = BLOCK[body(dtype, d)]
    tiles = -(-s // rows) * b * h
    if body(dtype, d) != "wgmma" or sms is None:
        return tiles, threads, tiles, rows
    units = -(-tiles // 2) if d == 256 else tiles
    return min(units, sms), threads, tiles, rows


def kernel_strides(t: torch.Tensor) -> tuple[int, int, int]:
    """Element strides of the B, S and head axes as the kernel reads them.
    An axis of size 1 is never stepped along, so its stride is replaced by
    D (a value every body, and TMA, takes)."""
    return tuple(t.shape[3] if t.shape[i] == 1 else t.stride(i)
                 for i in range(3))


def tma_map(t: torch.Tensor) -> tuple[tuple[int, ...], tuple[int, ...]]:
    """The TMA tensor map of a bf16 (B, S, heads, D) tensor, as the kernel
    encodes it: dims (D, S, heads, B) and the byte strides of the S, heads
    and B axes.  Raises if TMA cannot take them (each stride a positive
    multiple of 16 bytes below 2^40)."""
    b, s, heads, d = t.shape
    sb, ss, sh = (st * t.element_size() for st in kernel_strides(t))
    strides = (ss, sh, sb)
    if any(st <= 0 or st % 16 or st >= TMA_MAX_STRIDE for st in strides):
        raise ValueError(f"flash_attention: TMA cannot take byte strides "
                         f"{strides} (S, heads, B axes): each must be a "
                         f"positive multiple of 16 below 2**40")
    return (d, s, heads, b), strides


def launch(lib: ctypes.CDLL, q, k, v, *, scale: float, causal: bool,
           window: int | None = None):
    """Run the CUDA kernel.  Returns out (B, S, H, D) in q's dtype.

    Raises on anything the kernel does not take, and if the launch is
    refused (the C function returns ``cudaGetLastError()``, or a code at or
    above `ENCODE_FAILED` if a tensor map cannot be built).
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
    check_window(window)
    vec = 16 // q.element_size()     # elements per 16-byte load
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name} must be contiguous in "
                             f"its last axis, got strides {t.stride()}")
        if t.data_ptr() % 16 or any(st % vec for st in kernel_strides(t)):
            raise ValueError(f"flash_attention: every row of {name} must "
                             f"start on 16 bytes (strides {t.stride()})")
        if body(q.dtype, d) == "wgmma":
            tma_map(t)
    if grid(q.shape, q.dtype)[2] > _MAX_TILES:
        raise ValueError(f"flash_attention: {tuple(q.shape)} exceeds the "
                         f"grid limit")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=dev)
    if b * s * h == 0:
        return out
    strides = (ctypes.c_longlong * 9)(
        *(st for t in (q, k, v) for st in kernel_strides(t)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, h, k.shape[2], d, strides, float(scale), int(causal),
            min(int(window or 0), 2**31 - 1), _DTYPE_CODES[q.dtype], stream,
        )
    if err >= ENCODE_FAILED:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled refused "
                           f"q {tuple(q.shape)} (CUresult "
                           f"{err - ENCODE_FAILED})")
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed for q "
                           f"{tuple(q.shape)}: CUDA error {err}")
    return out


def smem_bytes(lib: ctypes.CDLL, dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory a launch for ``dtype`` at head dim ``d`` takes."""
    return lib.flash_attention_smem_bytes(_DTYPE_CODES[dtype], d)


def simt_blocks_per_sm(lib: ctypes.CDLL, dtype: torch.dtype, d: int) -> int:
    """Blocks of the first body an SM holds for ``dtype`` at head dim ``d``
    (the occupancy calculator; 0 where the Hopper body serves)."""
    return lib.flash_attention_simt_blocks_per_sm(_DTYPE_CODES[dtype], d)


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures (pointers and the stream as c_void_p)."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = (
        [vp] * 4 + [i32] * 5
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, i32, i32, i32,
           vp])
    lib.flash_attention_launch.restype = i32
    for fn in (lib.flash_attention_smem_bytes,
               lib.flash_attention_simt_blocks_per_sm):
        fn.argtypes = [i32, i32]
        fn.restype = i32
    return lib
