"""PyTorch/CUDA port of the R&A D-FL simulator (Hopper, sm_90a).

The package mirrors the JAX reference package module for module (`core/`,
`data/`, `fl/`, `kernels/`, `models/`) and imports only `torch` and numpy.
Entry points (`fl.simulator.build_sim`, `fl.simulator.run`,
`kernels.ops.ra_aggregate`, `kernels.ops.rwkv6_scan`, the
`models.registry.build` bundle and `launch.serve.serve`) run on the CUDA
card unless the caller passes ``device="cpu"``; without a card and without
that argument they raise.
"""
from __future__ import annotations

import torch
from torch._C import _functorch


def func_transform_active() -> bool:
    """Whether a `torch.func` transform (grad, vmap, ...) is running."""
    return _functorch.peek_interpreter_stack() is not None


def grad_tracking(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a `torch.func` gradient transform at some
    level (a vmap's batched wrapper is looked through).

    This, `func_transform_active` and `vmap_size` are the package's only
    readers of torch's private functorch API."""
    while True:
        if _functorch.is_gradtrackingtensor(t):
            return True
        if not _functorch.is_batchedtensor(t):
            return False
        t = _functorch.get_unwrapped(t)


def vmap_size(t: torch.Tensor) -> int:
    """How many tensors ``t`` stands for: the product of the batch sizes
    of the `torch.func.vmap`s it is batched under (1 outside any)."""
    size = 1
    while _functorch.is_batchedtensor(t):
        inner = _functorch.get_unwrapped(t)
        size *= inner.shape[_functorch.maybe_get_bdim(t)]
        t = inner
    return size


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` means the card.  Asking for CUDA on a machine without one
    raises instead of quietly running on the CPU.  On the card it turns
    TF32 off for matmuls and cuDNN, process-wide: the reference computes
    float32 products in float32, and every entry point resolves its device
    here, so each computes float32 the same way whichever ran first.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; pass device='cpu' "
                "to run the plain PyTorch path on the CPU"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev
