"""The paper's FL experiment models (Sec. V-A.1), functional PyTorch.

Port of the reference package's `models/smallnets.py` for the slice's two
models:

  * CNN — 2 conv layers (32/64 filters) + 2x2 average pools + 2 FC, ReLU
          (the Fed-FashionMNIST task);
  * MLP — a small classifier for fast CPU-scale experiments.

Parameters are flat ``dict[str, Tensor]``s in the reference's leaf order
and layouts (conv weights HWIO, inputs NHWC, FC weights (din, dout)), so a
segment of the flattened model holds the same parameters in both packages.
`apply_cnn` translates to `F.conv2d`'s NCHW / OIHW internally.  Init draws
from a CPU ``torch.Generator`` (the result is the same on every device;
the caller moves it); it cannot reproduce the reference's threefry draws —
parity tests cross the reference's weights with `repro_torch.interop`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Params = dict[str, torch.Tensor]


def _normal(gen: torch.Generator, shape, std: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32) * std


def _conv_init(gen, h, w, cin, cout) -> torch.Tensor:
    return _normal(gen, (h, w, cin, cout), math.sqrt(2.0 / (h * w * cin)))


def _fc_init(gen, name: str, din: int, dout: int) -> Params:
    # Leaf order: "b" sorts before "w".
    return {f"{name}.b": torch.zeros(dout, dtype=torch.float32),
            f"{name}.w": _normal(gen, (din, dout), math.sqrt(2.0 / din))}


# ---------------------------------------------------------------------------
# CNN (paper: 2 conv (32, 64) + pool + 2 FC)
# ---------------------------------------------------------------------------
def init_cnn(gen: torch.Generator, *, in_hw=(28, 28), in_ch=1, n_classes=10,
             c1=32, c2=64, fc=128) -> Params:
    h, w = in_hw
    flat = (h // 4) * (w // 4) * c2  # two 2x2 pools
    return {
        "conv1": _conv_init(gen, 3, 3, in_ch, c1),
        "conv2": _conv_init(gen, 3, 3, c1, c2),
        **_fc_init(gen, "fc1", flat, fc),
        **_fc_init(gen, "fc2", fc, n_classes),
    }


def _conv_same(x: torch.Tensor, w_hwio: torch.Tensor) -> torch.Tensor:
    """NCHW input, HWIO weight, stride 1, SAME padding (odd kernels)."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), padding=(kh // 2, kw // 2))


def apply_cnn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> logits (B, n_classes)."""
    x = x.permute(0, 3, 1, 2)
    x = F.avg_pool2d(torch.relu(_conv_same(x, params["conv1"])), 2)
    x = F.avg_pool2d(torch.relu(_conv_same(x, params["conv2"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten order
    x = torch.relu(x @ params["fc1.w"] + params["fc1.b"])
    return x @ params["fc2.w"] + params["fc2.b"]


# ---------------------------------------------------------------------------
# MLP classifier (fast CPU-scale FL experiments)
# ---------------------------------------------------------------------------
def init_mlp_clf(gen: torch.Generator, *, d_in=32, d_hidden=64,
                 n_classes=10) -> Params:
    return {
        **_fc_init(gen, "fc1", d_in, d_hidden),
        **_fc_init(gen, "fc2", d_hidden, d_hidden),
        **_fc_init(gen, "fc3", d_hidden, n_classes),
    }


def apply_mlp_clf(params: Params, x: torch.Tensor) -> torch.Tensor:
    x = torch.relu(x @ params["fc1.w"] + params["fc1.b"])
    x = torch.relu(x @ params["fc2.w"] + params["fc2.b"])
    return x @ params["fc3.w"] + params["fc3.b"]


# ---------------------------------------------------------------------------
# Shared losses
# ---------------------------------------------------------------------------
def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
