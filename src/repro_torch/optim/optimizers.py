"""Local optimizers in plain tensor arithmetic.

Port of the reference package's `optim/optimizers.py`.  Each optimizer is
an (init, update) pair over a tensor or a dict of tensors:

  opt_state = init(params)
  new_params, new_opt_state = update(params, grads, opt_state)

The update expressions are the reference's, term for term (AdamW's float32
bias corrections ``1 - b**t`` and its decoupled weight decay included).
Every update is elementwise with one shared step count, so the simulator
applies it to all clients' stacked rows at once.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

Params = Any   # a tensor or a dict of tensors


class Optimizer(NamedTuple):
    init: Callable[[Params], Params]
    update: Callable[[Params, Params, Params], tuple[Params, Params]]


def _map(fn, *trees):
    """``fn`` leaf by leaf over tensors or dicts of tensors of one layout."""
    if isinstance(trees[0], dict):
        return {k: fn(*(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _step0(params) -> torch.Tensor:
    leaf = next(iter(params.values())) if isinstance(params, dict) else params
    return torch.zeros((), dtype=torch.int32, device=leaf.device)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return {"step": _step0(params)}
        return {"step": _step0(params),
                "mu": _map(torch.zeros_like, params)}

    def update(params, grads, state):
        if momentum == 0.0:
            new_params = _map(lambda p, g: p - lr * g, params, grads)
            return new_params, {"step": state["step"] + 1}
        mu = _map(lambda m, g: momentum * m + g, state["mu"], grads)
        new_params = _map(lambda p, m: p - lr * m, params, mu)
        return new_params, {"step": state["step"] + 1, "mu": mu}

    return Optimizer(init, update)


def adamw(
    lr: float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Optimizer:
    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.float32)

        return {"step": _step0(params), "m": _map(zeros, params),
                "v": _map(zeros, params)}

    def update(params, grads, state):
        step = state["step"] + 1
        t = step.to(torch.float32)
        bc1 = 1.0 - b1 ** t
        bc2 = 1.0 - b2 ** t

        def upd(p, g, m, v):
            g32 = g.to(torch.float32)
            m_ = b1 * m + (1 - b1) * g32
            v_ = b2 * v + (1 - b2) * g32 * g32
            mhat = m_ / bc1
            vhat = v_ / bc2
            p32 = p.to(torch.float32)
            delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
            return (p32 - lr * delta).to(p.dtype), m_, v_

        if isinstance(params, dict):
            out = {k: upd(params[k], grads[k], state["m"][k], state["v"][k])
                   for k in params}
            return ({k: o[0] for k, o in out.items()},
                    {"step": step, "m": {k: o[1] for k, o in out.items()},
                     "v": {k: o[2] for k, o in out.items()}})
        p, m, v = upd(params, grads, state["m"], state["v"])
        return p, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def get(name: str, lr: float, **kw) -> Optimizer:
    if name == "sgd":
        return sgd(lr, **kw)
    if name == "adamw":
        return adamw(lr, **kw)
    raise ValueError(name)
