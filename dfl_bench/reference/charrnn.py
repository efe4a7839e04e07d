"""Reference character LSTM (McMahan et al. 2017, arXiv:1602.05629 §3;
LEAF's Shakespeare model, arXiv:1812.01097): an embedding, two LSTM layers
and a linear output over the vocabulary.

Mirrors `src/repro_torch/models/smallnets.py` (`init_charrnn`,
`lstm_cell`, `apply_charrnn`) without importing it.  Each LSTM layer
computes, per step, z = x W_x + h W_h + b split into gates (i, f, g, o);
c' = sigmoid(f + 1) c + sigmoid(i) tanh(g) (the forget gate biased by +1),
h' = sigmoid(o) tanh(c'); both carries start at zero.  Parameters are a
flat dict in the port's leaf order ("embed", "fc.b", "fc.w", "lstm1.b",
"lstm1.wh", "lstm1.wx", "lstm2...").
"""
from __future__ import annotations

import math

import torch


def layout(sizes: dict) -> list[tuple[str, tuple[int, ...], float]]:
    """(name, shape, init std) of every leaf, in leaf order: the
    embedding N(0, 0.1^2), the output He-normal, each LSTM weight
    N(0, 1 / fan_in), biases zero."""
    vocab, embed, hidden = sizes["vocab"], sizes["embed"], sizes["hidden"]

    def cell(name, din):
        return [(f"{name}.b", (4 * hidden,), 0.0),
                (f"{name}.wh", (hidden, 4 * hidden), 1.0 / math.sqrt(hidden)),
                (f"{name}.wx", (din, 4 * hidden), 1.0 / math.sqrt(din))]

    return ([("embed", (vocab, embed), 0.1),
             ("fc.b", (vocab,), 0.0),
             ("fc.w", (hidden, vocab), math.sqrt(2.0 / hidden))]
            + cell("lstm1", embed) + cell("lstm2", hidden))


def _layer(params: dict, name: str, seq: torch.Tensor) -> torch.Tensor:
    wx, wh, b = (params[f"{name}.{k}"] for k in ("wx", "wh", "b"))
    batch, steps = seq.shape[0], seq.shape[1]
    h = seq.new_zeros((batch, wh.shape[0]))
    c = seq.new_zeros((batch, wh.shape[0]))
    out = []
    for t in range(steps):
        z = seq[:, t] @ wx + h @ wh + b
        i, f, g, o = z.chunk(4, dim=-1)
        c = torch.sigmoid(f + 1.0) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out.append(h)
    return torch.stack(out, dim=1)


def forward(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) integers -> logits (B, S, vocab)."""
    x = params["embed"][tokens.long()]
    h = _layer(params, "lstm2", _layer(params, "lstm1", x))
    return h @ params["fc.w"] + params["fc.b"]
