"""Reference CIFAR-style ResNet (He et al. 2016, arXiv:1512.03385 §4.2).

Mirrors `src/repro_torch/models/smallnets.py` (`init_resnet`,
`apply_resnet`, `_same_pads`, `conv2d`) without importing it: 3 stages of
(depth - 2) / 6 basic blocks (9 at depth 56), widths ``width * 2**s``,
stride 2 entering stages 1 and 2, a 1x1 projection shortcut where the
width changes, no normalization layer, global average pooling, one linear
layer.  Parameters are a flat dict in the port's leaf order and layouts
(conv weights HWIO, inputs NHWC, the linear weight (din, dout)).

The padding is XLA's SAME rule, frozen here: ceil(size / stride) outputs,
the padding the window needs split with the smaller half in front.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _blocks(depth: int) -> int:
    return {18: 2, 56: 9}.get(depth, (depth - 2) // 6)


def layout(sizes: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, init std) of every leaf, in leaf order.  Convolutions
    and the linear weight are He-normal (std sqrt(2 / fan_in)); the bias
    starts at zero."""
    width, in_ch = sizes["width"], sizes["in_ch"]
    n = _blocks(sizes["depth"])

    def conv(h, w, cin, cout):
        return (h, w, cin, cout), math.sqrt(2.0 / (h * w * cin))

    blocks = []
    cin = width
    for s in range(3):
        cout = width * 2 ** s
        for b in range(n):
            pre = f"stage{s}.{b}"
            blocks.append((f"{pre}.conv1", *conv(3, 3, cin, cout)))
            blocks.append((f"{pre}.conv2", *conv(3, 3, cout, cout)))
            if cin != cout:
                blocks.append((f"{pre}.proj", *conv(1, 1, cin, cout)))
            cin = cout
    classes = sizes["n_classes"]
    return ([("fc.b", (classes,), 0.0),
             ("fc.w", (cin, classes), math.sqrt(2.0 / cin))]
            + blocks + [("stem", *conv(3, 3, in_ch, width))])


def same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: (before, after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w_hwio: torch.Tensor,
              stride: int = 1) -> torch.Tensor:
    """NCHW input, HWIO weight, SAME padding."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    top, bottom = same_pads(x.shape[2], kh, stride)
    left, right = same_pads(x.shape[3], kw, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), stride=stride)


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> logits (B, classes)."""
    h = torch.relu(conv_same(x.permute(0, 3, 1, 2), params["stem"]))
    s = 0
    while f"stage{s}.0.conv1" in params:
        b = 0
        while f"stage{s}.{b}.conv1" in params:
            pre = f"stage{s}.{b}"
            stride = 2 if (s > 0 and b == 0) else 1
            y = torch.relu(conv_same(h, params[f"{pre}.conv1"], stride))
            y = conv_same(y, params[f"{pre}.conv2"])
            if f"{pre}.proj" in params:
                short = conv_same(h, params[f"{pre}.proj"], stride)
            else:
                short = h[:, :, ::stride, ::stride]
            h = torch.relu(y + short)
            b += 1
        s += 1
    return h.mean(dim=(2, 3)) @ params["fc.w"] + params["fc.b"]
