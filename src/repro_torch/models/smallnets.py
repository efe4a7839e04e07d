"""The paper's FL experiment models (Sec. V-A.1), functional PyTorch.

Port of the reference package's `models/smallnets.py`:

  * CNN      — 2 conv layers (32/64 filters) + 2x2 average pools + 2 FC,
               ReLU (the Fed-FashionMNIST task);
  * ResNet   — CIFAR-style ResNet-n (n = 18, 56) with shortcut connections
               (the CIFAR-10 / CIFAR-100 tasks);
  * CharRNN  — embedding + 2-layer LSTM (256 hidden) + FC output
               (Shakespeare next-character prediction, vocab 90);
  * MLP      — a small classifier for fast CPU-scale experiments.

Parameters are flat ``dict[str, Tensor]``s in the reference's leaf order
and layouts (conv weights HWIO, inputs NHWC, FC weights (din, dout)), so a
segment of the flattened model holds the same parameters in both packages:
dotted names, keys sorted at every dict level, list entries in index order
("fc.b", "fc.w", "stage0.0.conv1", ..., "stage1.0.proj", ..., "stem").
The convolutions translate to `F.conv2d`'s NCHW / OIHW internally, with
the reference's SAME padding (`conv2d`).  Init draws from a CPU
``torch.Generator`` (the result is the same on every device; the caller
moves it); it cannot reproduce the reference's threefry draws — parity
tests cross the reference's weights with `repro_torch.interop`.  Every
apply is `torch.func.vmap(grad)`-safe: no in-place op, no host read.
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


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial axis: ceil(size / stride) outputs;
    the padding the window needs, less in front when it is odd (a stride-2
    3x3 convolution on an even side pads 0 before and 1 after)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, w_hwio: torch.Tensor,
           stride: int = 1) -> torch.Tensor:
    """NCHW input, HWIO weight, SAME padding as the reference's
    ``conv_general_dilated(..., "SAME")``."""
    kh, kw = w_hwio.shape[0], w_hwio.shape[1]
    if kh == kw == 1 and stride > 1:
        # A 1x1 kernel needs no padding and reads every stride-th position:
        # the stride-1 product of that slice (the same sums).  oneDNN's CPU
        # backward of a strided 1x1 convolution on a channels-last input
        # (what the NHWC permute gives) crashes in torch 2.13.
        x, stride = x[:, :, ::stride, ::stride], 1
    (ht, hb), (wl, wr) = (_same_pads(x.shape[2], kh, stride),
                          _same_pads(x.shape[3], kw, stride))
    w = w_hwio.permute(3, 2, 0, 1)
    if ht == hb and wl == wr:
        return F.conv2d(x, w, stride=stride, padding=(ht, wl))
    return F.conv2d(F.pad(x, (wl, wr, ht, hb)), w, stride=stride)


def channels_last_kernels(params: Params) -> Params:
    """``params`` with each HWIO conv kernel (a rank-4 leaf) copied into O,
    H, W, I order, so that `conv2d`'s OIHW view of it is channels-last, as
    the NCHW view of an NHWC input is.  Under `torch.func.vmap` the
    kernels stacked for a grouped convolution then stay one channels-last
    view, and cuDNN transposes far less."""
    return {k: v.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
            if v.ndim == 4 else v for k, v in params.items()}


def apply_cnn(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> logits (B, n_classes)."""
    x = x.permute(0, 3, 1, 2)
    x = F.avg_pool2d(torch.relu(conv2d(x, params["conv1"])), 2)
    x = F.avg_pool2d(torch.relu(conv2d(x, params["conv2"])), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten order
    x = torch.relu(x @ params["fc1.w"] + params["fc1.b"])
    return x @ params["fc2.w"] + params["fc2.b"]


# ---------------------------------------------------------------------------
# ResNet (CIFAR-style: 3 stages, 2n blocks per stage for ResNet-6n+2)
# ---------------------------------------------------------------------------
def init_resnet(gen: torch.Generator, *, depth=18, in_ch=3, n_classes=10,
                width=16) -> Params:
    """Blocks per stage: depth 18 -> (2, 2, 2), 56 -> (9, 9, 9), else
    (depth - 2) / 6 each.  Stage s has width * 2**s channels; a block whose
    input width differs carries a 1x1 ``proj`` shortcut.  Drawn stem,
    blocks, fc (the reference's key order); returned in leaf order."""
    n = {18: 2, 56: 9}.get(depth, (depth - 2) // 6)
    p: Params = {"stem": _conv_init(gen, 3, 3, in_ch, width)}
    cin = width
    for s, nb in enumerate((n, n, n)):
        cout = width * (2 ** s)
        for b in range(nb):
            pre = f"stage{s}.{b}"
            p[f"{pre}.conv1"] = _conv_init(gen, 3, 3, cin, cout)
            p[f"{pre}.conv2"] = _conv_init(gen, 3, 3, cout, cout)
            if cin != cout:
                p[f"{pre}.proj"] = _conv_init(gen, 1, 1, cin, cout)
            cin = cout
    p.update(_fc_init(gen, "fc", cin, n_classes))
    # Leaf order: "fc" < "stage0" < ... < "stem"; blocks in index order.
    return {k: p[k] for k in
            ["fc.b", "fc.w", *(k for k in p if k.startswith("stage")),
             "stem"]}


def apply_resnet(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) NHWC -> logits (B, n_classes)."""
    x = torch.relu(conv2d(x.permute(0, 3, 1, 2), params["stem"]))
    s = 0
    while f"stage{s}.0.conv1" in params:
        stride = 1 if s == 0 else 2
        i = 0
        while f"stage{s}.{i}.conv1" in params:
            pre = f"stage{s}.{i}"
            st = stride if i == 0 else 1
            h = torch.relu(conv2d(x, params[f"{pre}.conv1"], stride=st))
            h = conv2d(h, params[f"{pre}.conv2"])
            sc = x
            if f"{pre}.proj" in params:
                sc = conv2d(x, params[f"{pre}.proj"], stride=st)
            elif st != 1:
                sc = x[:, :, ::st, ::st]
            x = torch.relu(h + sc)
            i += 1
        s += 1
    x = x.mean(dim=(2, 3))  # global average pool
    return x @ params["fc.w"] + params["fc.b"]


# ---------------------------------------------------------------------------
# Char-RNN (embedding + 2-layer LSTM + FC; paper Sec. V-A.1)
# ---------------------------------------------------------------------------
def init_lstm_cell(gen: torch.Generator, name: str, din: int,
                   dh: int) -> Params:
    wx = _normal(gen, (din, 4 * dh), 1.0 / math.sqrt(din))
    wh = _normal(gen, (dh, 4 * dh), 1.0 / math.sqrt(dh))
    return {f"{name}.b": torch.zeros(4 * dh, dtype=torch.float32),
            f"{name}.wh": wh, f"{name}.wx": wx}


def lstm_cell(params: Params, carry, x_proj: torch.Tensor):
    """One step; ``x_proj`` is the input's product ``x @ wx``.  Gates
    split i, f, g, o; the forget gate is biased by +1."""
    h, c = carry
    z = x_proj + h @ params["wh"] + params["b"]
    i, f, g, o = torch.chunk(z, 4, dim=-1)
    c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
    h = torch.sigmoid(o) * torch.tanh(c)
    return (h, c), h


def init_charrnn(gen: torch.Generator, *, vocab=90, embed=8,
                 hidden=256) -> Params:
    """Drawn embed, lstm1, lstm2, fc (the reference's key order); returned
    in leaf order ("fc" sorts before "lstm1")."""
    emb = _normal(gen, (vocab, embed), 0.1)
    l1 = init_lstm_cell(gen, "lstm1", embed, hidden)
    l2 = init_lstm_cell(gen, "lstm2", hidden, hidden)
    return {"embed": emb, **_fc_init(gen, "fc", hidden, vocab), **l1, **l2}


def _lstm_layer(params: Params, seq: torch.Tensor) -> torch.Tensor:
    """seq: (B, S, Din) -> hidden states (B, S, Dh); the reference's scan
    over time is a loop over S."""
    b, s = seq.shape[0], seq.shape[1]
    dh = params["wh"].shape[0]
    xp = seq @ params["wx"]                       # every step's input product
    carry = (seq.new_zeros((b, dh)), seq.new_zeros((b, dh)))
    hs = []
    for t in range(s):
        carry, h = lstm_cell(params, carry, xp[:, t])
        hs.append(h)
    return torch.stack(hs, dim=1)


def apply_charrnn(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, V)."""
    x = params["embed"][tokens.long()]            # (B, S, E)
    lstm = {n: {k[len(n) + 1:]: v for k, v in params.items()
                if k.startswith(n + ".")} for n in ("lstm1", "lstm2")}
    h = _lstm_layer(lstm["lstm1"], x)
    h = _lstm_layer(lstm["lstm2"], h)
    return h @ params["fc.w"] + params["fc.b"]


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
def _nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return logz - gold


def ce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return _nll(logits, labels).mean()


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Each sample's cross-entropy times its weight, summed: ``weights``
    (B,) all 1 / B give `ce_loss`."""
    return (_nll(logits, labels) * weights).sum()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=-1) == labels).to(torch.float32).mean()


MODELS = {
    "cnn": (init_cnn, apply_cnn),
    "resnet": (init_resnet, apply_resnet),
    "charrnn": (init_charrnn, apply_charrnn),
    "mlp": (init_mlp_clf, apply_mlp_clf),
}
