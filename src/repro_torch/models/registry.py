"""Model registry: ModelCfg -> a serving bundle (init, prefill, decode, cache).

Port of the serving half of the reference package's `models/registry.py`
`build`.  Its `loss_fn`, `train_step` and optimizer come with training, and
`sim_model` with the simulator's model zoo (ROADMAP Queue 1 item 7).

Every function of the bundle is an entry point: it runs on the CUDA card
unless the caller passes ``device="cpu"`` (without a card and without that
argument it raises), and the tensors it is given must lie there.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .. import resolve_device
from . import transformer as T


class ModelBundle(NamedTuple):
    cfg: T.ModelCfg
    init: Callable[..., T.Params]
    prefill_step: Callable[..., tuple]
    serve_step: Callable[..., tuple]
    init_cache: Callable[..., T.Params]


def needs_modal(cfg: T.ModelCfg) -> bool:
    return cfg.family in ("enc_dec", "vlm")


def _on(dev: torch.device, what: str, tensors) -> None:
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"{what}: a tensor is on {t.device}, the call "
                             f"runs on {dev}")


def build(cfg: T.ModelCfg) -> ModelBundle:
    T.check_family(cfg)

    def init(gen: torch.Generator, *, device=None) -> T.Params:
        """Parameters drawn with ``gen`` (on the generator's device) and
        placed on ``device``."""
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in T.init_params(gen, cfg).items()}

    def prefill_step(params, batch, *, window=None, impl="auto", device=None):
        dev = resolve_device(device)
        _on(dev, "prefill_step", [batch["tokens"], *params.values()])
        with torch.no_grad():
            return T.prefill(params, cfg, batch["tokens"], window=window,
                             impl=impl)

    def serve_step(params, cache, token, pos, *, window=None, device=None):
        dev = resolve_device(device)
        _on(dev, "serve_step", [token, *params.values(), *cache.values()])
        with torch.no_grad():
            return T.serve_step(params, cfg, cache, token, pos, window=window)

    def init_cache(batch, max_len, *, window=None, device=None):
        return T.init_cache(cfg, batch, max_len, window=window,
                            device=resolve_device(device))

    return ModelBundle(cfg, init, prefill_step, serve_step, init_cache)
