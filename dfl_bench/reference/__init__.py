"""The benchmark's plain reference of a D-FL sweep.

Plain PyTorch that imports nothing of the port (`repro_torch`) nor of the
JAX package: frozen copies of the rules the port implements, each module
naming the port file it mirrors.

  * `resnet`, `charrnn` — the client models (one module per model, found
    by the name a configuration's ``reference`` key gives);
  * `exchange` — min-E2E-PER routing, eq. 6, AaYG's one-hop mixes, C-FL's
    star and the error-free aggregate;
  * `sweep` — one scenario's rounds: local full-batch GD per client, the
    round's draws, the exchange, and the per-client test accuracy and
    train loss that the port's `GridResult` returns.

It is handed the benchmark's inputs (data, link matrices, initial weights,
scenario seeds) and works out everything else itself.
"""
from __future__ import annotations

import importlib


def model(name: str):
    """The reference module of the client model ``name``."""
    if not name.isidentifier():
        raise ValueError(f"no reference model named {name!r}")
    return importlib.import_module(f"{__name__}.{name}")
