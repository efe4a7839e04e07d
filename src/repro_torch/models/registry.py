"""Model registry: ModelCfg -> a bundle (init, prefill, decode, cache, loss,
train step, optimizer), and the simulator's model zoo.

Port of the reference package's `models/registry.py`.  Two registries:

  * `build` / `ModelBundle` — the serving bundle (`prefill_step`,
    `serve_step`, `init_cache`) and the training one (`loss_fn`,
    `train_step`, `optimizer`) used by `launch.train`.
  * `sim_model` / `SIM_MODEL_IDS` — the simulator-facing zoo: name ->
    ``(init_fn, apply_fn)`` pairs with `build_sim` / `GridRunner`'s
    contract (``init(CPU generator) -> params``, ``apply(params, x) ->
    logits``): the four smallnets, the tiny ``transformer_nwp`` decoder LM
    for `data.synthetic.fed_char_stream`, and ``nwp:<arch>`` for each
    decoder-only architecture at smoke size.  The ids equal the
    reference's.

Every function of the bundle is an entry point: it runs on the CUDA card
unless the caller passes ``device="cpu"`` (without a card and without that
argument it raises), and the tensors it is given must lie there.  Training
runs the reference's training forward (`transformer.train_impl`: the
masked, chunked or flash attention of ``cfg.attn_impl`` and the plain
time-mix scan); serving keeps K2 and K3.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from .. import resolve_device
from ..configs import base as configs
from ..optim import optimizers
from . import smallnets
from . import transformer as T


class ModelBundle(NamedTuple):
    cfg: T.ModelCfg
    init: Callable[..., T.Params]
    prefill_step: Callable[..., tuple]
    serve_step: Callable[..., tuple]
    init_cache: Callable[..., T.Params]
    loss_fn: Callable[..., tuple]
    train_step: Callable[..., tuple]
    optimizer: optimizers.Optimizer


def needs_modal(cfg: T.ModelCfg) -> bool:
    return cfg.family in ("enc_dec", "vlm")


def _on(dev: torch.device, what: str, tensors) -> None:
    for t in tensors:
        if t.device.type != dev.type:
            raise ValueError(f"{what}: a tensor is on {t.device}, the call "
                             f"runs on {dev}")


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean token CE in float32.  logits: (B, S, V); labels: (B, S)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean()


def chunked_cross_entropy(table: torch.Tensor, hidden: torch.Tensor,
                          labels: torch.Tensor, chunk: int) -> torch.Tensor:
    """Vocab-chunked CE that never materializes (B, S, V) logits: a
    streaming logsumexp over vocabulary chunks, the gold logit taken from
    whichever chunk holds the label.  hidden: (B, S, D) final normed
    states; table: (V, D) tied embedding."""
    b, s, _ = hidden.shape
    v = table.shape[0]
    c = min(chunk, v)
    h = hidden.float()
    tab = table.float()
    m = torch.full((b, s), -torch.inf, device=h.device)
    denom = torch.zeros((b, s), device=h.device)
    gold = torch.zeros((b, s), device=h.device)
    labels = labels.long()
    for base in range(0, v, c):
        logits = h @ tab[base:base + c].T                      # (B, S, <=C)
        if logits.shape[-1] < c:   # the reference pads the last chunk
            logits = torch.cat([logits, logits.new_full(
                (b, s, c - logits.shape[-1]), -torch.inf)], dim=-1)
        m_new = torch.maximum(m, logits.amax(-1))
        denom = (denom * torch.exp(m - m_new)
                 + torch.exp(logits - m_new[..., None]).sum(-1))
        in_chunk = (labels >= base) & (labels < base + c)
        local = torch.clamp(labels - base, 0, c - 1)
        g = torch.gather(logits, -1, local[..., None])[..., 0]
        gold = torch.where(in_chunk, g, gold)
        m = m_new
    logz = m + torch.log(torch.clamp_min(denom, 1e-30))
    return (logz - gold).mean()


def _update_leafwise(opt: optimizers.Optimizer, params: T.Params,
                     grads: T.Params, opt_state: dict) -> None:
    """``opt.update`` one leaf at a time, each new leaf (and its moments)
    written over the old in ``params`` / ``opt_state`` and its gradient
    dropped: the old and new states never both sit on the device (the
    full qwen2.5-3b's float32 AdamW moments alone take 24.7 GB).  The
    update is elementwise, so this equals one update of the whole tree."""
    step = opt_state["step"]
    new_step = step
    for k in list(params):
        sub = {name: ({k: val[k]} if isinstance(val, dict) else val)
               for name, val in opt_state.items() if name != "step"}
        new_p, new_sub = opt.update({k: params[k]}, {k: grads.pop(k)},
                                    {"step": step, **sub})
        params[k] = new_p[k]
        for name, val in new_sub.items():
            if name == "step":
                new_step = val
            else:
                opt_state[name][k] = val[k]
    opt_state["step"] = new_step


def build(cfg: T.ModelCfg, *, optimizer: str = "adamw", lr: float = 3e-4,
          aux_weight: float = 0.01) -> ModelBundle:
    T.check_family(cfg)
    opt = optimizers.get(optimizer, lr)

    def _modal(batch) -> dict:
        """The forward's modal keyword from ``batch`` (the modal families
        only)."""
        if needs_modal(cfg):
            return {"modal_embeds": batch["modal_embeds"]}
        return {}

    def init(gen: torch.Generator, *, device=None) -> T.Params:
        """Parameters drawn with ``gen`` (on the generator's device) and
        placed on ``device``."""
        dev = resolve_device(device)
        return {k: v.to(dev) for k, v in T.init_params(gen, cfg).items()}

    def prefill_step(params, batch, *, window=None, impl="auto", device=None):
        """The prefill of ``batch["tokens"]`` (and, for the modal families,
        ``batch["modal_embeds"]``): (last-token logits, decode cache)."""
        dev = resolve_device(device)
        modal = _modal(batch)
        _on(dev, "prefill_step", [batch["tokens"], *modal.values(),
                                  *params.values()])
        with torch.no_grad():
            return T.prefill(params, cfg, batch["tokens"], window=window,
                             impl=impl, **modal)

    def serve_step(params, cache, token, pos, *, window=None, abs_pos=None,
                   full_cache=False, device=None):
        dev = resolve_device(device)
        _on(dev, "serve_step", [token, *params.values(), *cache.values()])
        with torch.no_grad():
            return T.serve_step(params, cfg, cache, token, pos, window=window,
                                abs_pos=abs_pos, full_cache=full_cache)

    def init_cache(batch, max_len, *, window=None, device=None):
        return T.init_cache(cfg, batch, max_len, window=window,
                            device=resolve_device(device))

    def loss_fn(params, batch, *, window=None, device=None):
        """Next-token loss of ``batch["tokens"]`` (B, S), given the modal
        families' ``batch["modal_embeds"]`` (B, T, D): returns (loss +
        aux_weight * aux, {"loss", "aux"}), differentiable (the training
        forward, `transformer.train_impl`)."""
        dev = resolve_device(device)
        tokens = batch["tokens"]
        modal = _modal(batch)
        _on(dev, "loss_fn", [tokens, *modal.values(), *params.values()])
        impl = T.train_impl(cfg)
        if cfg.loss_vocab_chunk:
            hidden, aux = T.forward(params, cfg, tokens, impl=impl,
                                    window=window, return_hidden=True,
                                    **modal)
            loss = chunked_cross_entropy(params["embed.table"],
                                         hidden[:, :-1], tokens[:, 1:],
                                         cfg.loss_vocab_chunk)
        else:
            logits, aux = T.forward(params, cfg, tokens, impl=impl,
                                    window=window, **modal)
            loss = cross_entropy(logits[:, :-1], tokens[:, 1:])
        return loss + aux_weight * aux, {"loss": loss, "aux": aux}

    def train_step(state, batch, *, window=None, device=None):
        """One optimizer step on ``batch``: the gradient of `loss_fn` by
        autograd, then ``optimizer.update``.  Returns (state, metrics).

        ``state`` ({"params", "opt"}, from `init_state`) is consumed: its
        leaves are replaced one by one as the update goes (see
        `_update_leafwise`), and the returned state is the same dicts."""
        dev = resolve_device(device)
        params = state["params"]
        _on(dev, "train_step", [batch["tokens"], *_modal(batch).values(),
                                *params.values()])
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_()
                      for k, v in params.items()}
            total, metrics = loss_fn(leaves, batch, window=window,
                                     device=dev)
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads = dict(zip(leaves, torch.autograd.grad(
                total, list(leaves.values()))))
        del leaves, total
        with torch.no_grad():
            _update_leafwise(opt, params, grads, state["opt"])
        return state, metrics

    return ModelBundle(cfg, init, prefill_step, serve_step, init_cache,
                       loss_fn, train_step, opt)


def init_state(bundle: ModelBundle, gen: torch.Generator, *,
               device=None) -> dict:
    """{"params": drawn with ``gen``, "opt": the optimizer's fresh state
    (AdamW: float32 moments)} on ``device``."""
    params = bundle.init(gen, device=device)
    return {"params": params, "opt": bundle.optimizer.init(params)}


# ---------------------------------------------------------------------------
# Simulator-facing model zoo.
# ---------------------------------------------------------------------------
class SimModel(NamedTuple):
    """A model the FL simulator can carry: `build_sim(init_fn, apply_fn,
    ...)`.  ``model_id`` is a stable small integer (append-only in
    `SIM_MODEL_IDS`); ``cfg`` is the backing `ModelCfg` for transformer
    entries, None for smallnets."""

    name: str
    model_id: int
    init_fn: Callable[[torch.Generator], T.Params]
    apply_fn: Callable[[T.Params, torch.Tensor], torch.Tensor]
    cfg: T.ModelCfg | None


def _nwp_archs() -> tuple[str, ...]:
    """The decoder-only architectures (the modal families need side inputs
    the simulator's ``apply(params, x)`` cannot carry)."""
    return tuple(a for a in configs.ARCH_IDS if a not in configs.MODAL_ARCHS)


def _sim_model_ids() -> dict[str, int]:
    ids = {name: i for i, name in enumerate(smallnets.MODELS)}
    ids["transformer_nwp"] = len(ids)
    # Arch entries get a disjoint, append-only id block.
    for i, arch in enumerate(_nwp_archs()):
        ids[f"nwp:{arch}"] = 10 + i
    return ids


SIM_MODEL_IDS = _sim_model_ids()


def nwp_cfg(arch: str = "qwen2_5_3b", *, vocab: int = 90,
            tiny: bool = True) -> T.ModelCfg:
    """A next-word-prediction `ModelCfg` derived from a config entry: its
    `smoke_variant` with the char-stream vocabulary, shrunk (``tiny``) to
    simulator scale (d_model 32, 2 heads of 16, d_ff 64).  ``tiny=False``
    keeps the smoke geometry.  A modal architecture (enc_dec, vlm) raises
    `ValueError`: its side inputs do not fit the simulator's
    ``apply(params, x)``."""
    cfg = configs.smoke_variant(configs.get(arch))
    if needs_modal(cfg):
        raise ValueError(
            f"{arch} ({cfg.family}) needs side inputs (modal embeds); "
            f"next-word-prediction sim models must be decoder-only")
    kw: dict = dict(name=f"nwp-{cfg.name}", vocab=vocab)
    if tiny:
        kw.update(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64)
    return dataclasses.replace(cfg, **kw)


def _nwp_apply(cfg: T.ModelCfg):
    impl = T.train_impl(cfg)

    def apply_fn(params, tokens):
        logits, _aux = T.forward(params, cfg, tokens, impl=impl)
        return logits

    return apply_fn


def sim_models() -> list[str]:
    """Every registered simulator model name (see `sim_model`)."""
    return sorted(SIM_MODEL_IDS, key=SIM_MODEL_IDS.get)


def sim_model(name: str, *, vocab: int = 90) -> SimModel:
    """Construct a registered simulator model by name: a
    `smallnets.MODELS` entry, ``transformer_nwp`` (tiny decoder LM for
    `fed_char_stream` next-word prediction) or ``nwp:<arch>`` (a
    decoder-only architecture at smoke size; ``vocab`` must match the
    char-stream corpus).  Feed ``init_fn`` / ``apply_fn`` to
    `fl.simulator.build_sim` or `fl.scenarios.GridRunner`."""
    if name not in SIM_MODEL_IDS:
        raise ValueError(
            f"unknown sim model {name!r}: choose from {sim_models()}")
    mid = SIM_MODEL_IDS[name]
    if name in smallnets.MODELS:
        init_fn, apply_fn = smallnets.MODELS[name]
        return SimModel(name, mid, init_fn, apply_fn, None)
    if name == "transformer_nwp":
        cfg = nwp_cfg(vocab=vocab)
    else:                                   # "nwp:<arch>"
        cfg = nwp_cfg(name.split(":", 1)[1], vocab=vocab, tiny=False)
    return SimModel(name, mid, lambda gen: T.init_params(gen, cfg),
                    _nwp_apply(cfg), cfg)
