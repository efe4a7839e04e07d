"""Batched serving driver: prefill a batch of prompts, then decode greedily.

Port of the reference package's `launch/serve.py` (single device).  Usage:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --batch 4 --prompt-len 32 --gen 16            # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
      --device cpu                                  # the dense family
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-7b \\
      --window 16 --device cpu                      # a sliding window

`main`, like the reference's, serves the config's smoke variant; `serve`
takes any config (the full-width one included) and returns the generated
ids with the prefill and decode times.  The modal families (enc_dec, vlm)
prefill with frame / patch embeddings (B, T, d_model), a standard normal
draw unless given, as the reference's `main` draws them.  After the prefill, attention caches
(``k`` / ``v``) grow along their sequence axis to ``prompt_len + gen``, as
the reference's `main` grows them; with ``window`` the prefill masks keys
that far back (K2 takes the window on the card) and each decode step reads
the grown cache under the same window mask.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import base as cfgbase
from ..kernels import ops
from ..models import registry, transformer


def first_token(logits: torch.Tensor) -> torch.Tensor:
    """Greedy next token from step logits, sliced consistently.

    `prefill_step` returns the last-position logits already reduced to
    ``(batch, vocab)``, while `serve_step` returns ``(batch, 1, vocab)``
    — slice the trailing position only when it exists, so both call
    sites agree on which position feeds the argmax.
    """
    if logits.ndim == 3:
        logits = logits[:, -1]
    return logits.argmax(dim=-1)[:, None]


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # (B, gen) int64 generated ids, on the CPU
    prompt: torch.Tensor          # (B, prompt_len) prompt ids, on the device
    params: transformer.Params    # the weights served
    modal: torch.Tensor | None    # (B, T, D) modal embeddings prefilled
                                  # (enc_dec, vlm), on the device
    prefill_logits: torch.Tensor  # (B, V) float32 last-token logits
    prefill_cache: transformer.Params  # the cache as prefill left it
                                       # (attention caches not yet grown)
    prefill_s: float              # host clock, ending in a device sync
    decode_s: float               # the (gen - 1) serve_step calls
    decode_steps: int
    prefill_launches: dict[str, int]  # kernel launches by name, prefill
    decode_launches: dict[str, int]   # and over the decode steps

    @property
    def decode_tokens_per_s(self) -> float:
        return self.decode_steps * self.tokens.shape[0] / max(self.decode_s, 1e-9)


def grow_cache(cache: transformer.Params, total: int) -> transformer.Params:
    """Attention caches ``k`` / ``v`` (..., T, KV, Dh) zero-padded along T
    to ``total`` slots (new tensors); other leaves (recurrent states, the
    cross keys and values ``xk`` / ``xv``) as they are."""
    def grow(name, leaf):
        if name in ("k", "v") and leaf.ndim >= 4:
            pad = list(leaf.shape)
            pad[-3] = total - leaf.shape[-3]
            return torch.cat([leaf, leaf.new_zeros(pad)], dim=-3)
        return leaf
    return {name: grow(name, leaf) for name, leaf in cache.items()}


def _since(before: dict[str, int], *already: dict[str, int]) -> dict[str, int]:
    """Kernel launches by name since ``before``, less those counted in
    ``already``."""
    return {name: n - before.get(name, 0) - sum(a.get(name, 0) for a in already)
            for name, n in ops.LAUNCHES.items()}


def _seeds(seed: int) -> tuple[int, int, int]:
    """Independent seeds for the weights, the prompts and the modal
    embeddings: correlating them with the parameter draws would make the
    run unrepresentative.  The first two are `SeedSequence.spawn(2)`'s,
    which `spawn(3)` keeps."""
    kids = np.random.SeedSequence(seed).spawn(3)
    return tuple(int(k.generate_state(1, dtype=np.uint64)[0] >> 1) for k in kids)


def serve(cfg: transformer.ModelCfg, *, batch: int, prompt_len: int,
          gen: int, window: int | None = None, device=None, seed: int = 0,
          params: transformer.Params | None = None,
          tokens: torch.Tensor | None = None,
          modal: torch.Tensor | None = None) -> ServeResult:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens, then greedy-decode
    until each row has ``gen`` tokens (the first from prefill).

    Weights and prompts are drawn from ``seed`` on the device unless
    ``params`` / ``tokens`` are given (they must lie on the device); so are
    the modal families' embeddings ``modal`` (B, T, d_model), a float32
    standard normal draw (the prefill casts them to ``cfg.dtype``).
    """
    if gen < 1:
        raise ValueError(f"gen must be at least 1, got {gen}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        def sync():
            torch.cuda.synchronize(dev)
    else:
        def sync():
            pass
    bundle = registry.build(cfg)
    s_params, s_tokens, s_modal = _seeds(seed)
    if params is None:
        params = bundle.init(torch.Generator(dev).manual_seed(s_params),
                             device=dev)
    if tokens is None:
        tokens = torch.randint(
            0, cfg.vocab, (batch, prompt_len), device=dev,
            generator=torch.Generator(dev).manual_seed(s_tokens))
    inputs = {"tokens": tokens}
    if registry.needs_modal(cfg):
        if modal is None:
            modal = torch.randn(
                (batch, transformer.modal_len(cfg), cfg.d_model), device=dev,
                generator=torch.Generator(dev).manual_seed(s_modal))
        inputs["modal_embeds"] = modal

    launches = dict(ops.LAUNCHES)
    sync()
    t0 = time.perf_counter()
    logits, cache = bundle.prefill_step(params, inputs, window=window,
                                        device=dev)
    sync()
    prefill_s = time.perf_counter() - t0
    prefill_launches = _since(launches)
    prefill_logits, prefill_cache = logits, cache
    cache = grow_cache(cache, prompt_len + gen)

    tok = first_token(logits)
    generated = [tok]
    t0 = time.perf_counter()
    for i in range(gen - 1):
        logits, cache = bundle.serve_step(params, cache, tok, prompt_len + i,
                                          window=window, device=dev)
        tok = first_token(logits)
        generated.append(tok)
    sync()
    decode_s = time.perf_counter() - t0
    decode_launches = _since(launches, prefill_launches)
    return ServeResult(
        tokens=torch.cat(generated, dim=1).cpu(), prompt=tokens, params=params,
        modal=modal, prefill_logits=prefill_logits, prefill_cache=prefill_cache,
        prefill_s=prefill_s, decode_s=decode_s, decode_steps=gen - 1,
        prefill_launches=prefill_launches, decode_launches=decode_launches)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="rwkv6-1.6b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the plain path")
    args = ap.parse_args(argv)

    cfg = cfgbase.smoke_variant(cfgbase.get(args.arch))
    res = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen=args.gen, window=args.window, device=args.device)
    b, s = args.batch, args.prompt_len
    print(f"prefill: batch={b} len={s} -> cache ready "
          f"({res.prefill_s:.2f}s)", flush=True)
    # The timer brackets exactly gen - 1 serve_step calls (the first token
    # falls out of prefill), so that is what the rate counts.
    print(f"decode: {res.decode_steps} steps x batch {b} in "
          f"{res.decode_s:.2f}s ({res.decode_tokens_per_s:.1f} tok/s)")
    print("sample token ids:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
