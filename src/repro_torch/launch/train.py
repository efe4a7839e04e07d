"""End-to-end training entry point (single device).

Port of the reference package's `launch/train.py`: a plain (non-FL)
training loop for any architecture, at its smoke size or (with
``--full-config``) at full width and depth, or R&A D-FL pre-training of
the smoke LM across simulated clients, exchanging through
`core.protocols.ra_round` (K1 on the card).  The modal families (enc_dec,
vlm) are fed zero frame / patch embeddings, as the reference feeds them.
Usage:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
      --steps 50 --dfl --clients 4                  # on the CUDA card
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5

Weights are drawn from seed 0 with a generator on the device (every D-FL
client starts from the same draw, paper Sec. III); the exchange's success
masks from a generator of their own.  `main` returns what it measured:
each step's loss, MoE aux loss (0 for the other families) and seconds
(host clock, ending in a device sync), each
exchange round's mean client loss, K1's launches, the parameter count and
the final parameters (client 0's under ``--dfl``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..checkpoint import checkpoint
from ..configs import base as cfgbase
from ..core import protocols, routing, topology
from ..data import pipeline, synthetic
from ..kernels import ops
from ..models import registry, transformer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--dfl", action="store_true",
                    help="R&A D-FL across --clients simulated clients")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds-per-exchange", type=int, default=5)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--full-config", action="store_true",
                    help="use the FULL architecture config (needs memory!)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def main(argv: list[str] | None = None) -> dict:
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    cfg = cfgbase.get(args.arch)
    if not args.full_config:
        cfg = cfgbase.smoke_variant(cfg)
    bundle = registry.build(cfg, lr=args.lr)

    def make_batch(tokens: np.ndarray) -> dict:
        batch = {"tokens": torch.from_numpy(tokens[:, :-1]).to(dev)}
        if registry.needs_modal(cfg):
            # As the reference's: zero frame / patch embeddings.
            batch["modal_embeds"] = torch.zeros(
                (args.batch, transformer.modal_len(cfg), cfg.d_model),
                dtype=cfg.dtype, device=dev)
        return batch

    def step(state, tokens):
        sync()
        t0 = time.perf_counter()
        state, metrics = bundle.train_step(state, make_batch(tokens),
                                           device=dev)
        loss = float(metrics["loss"])       # waits for the device
        dt = time.perf_counter() - t0
        out["auxes"].append(float(metrics["aux"]))
        return state, loss, dt

    out = {"cfg": cfg, "losses": [], "auxes": [], "step_s": [],
           "round_losses": [], "tokens_per_step": args.batch * args.seq}
    k1_before = ops.LAUNCHES["ra_aggregate"]
    t_start = time.perf_counter()

    if not args.dfl:
        state = registry.init_state(
            bundle, torch.Generator(dev).manual_seed(0), device=dev)
        batches = pipeline.lm_batches(
            synthetic.lm_token_stream(vocab=cfg.vocab, n_tokens=200_000),
            args.batch, args.seq)
        for i in range(args.steps):
            state, loss, dt = step(state, next(batches))
            out["losses"].append(loss)
            out["step_s"].append(dt)
            if i % 10 == 0 or i == args.steps - 1:
                print(f"step {i:4d} loss {loss:.4f} "
                      f"({time.perf_counter() - t_start:.1f}s)", flush=True)
        saved = state["params"]
    else:
        # ----- R&A D-FL: N simulated clients, exchange every R local steps
        n = args.clients
        net = topology.random_geometric_network(
            n, edge_density=0.6, packet_len_bits=32 * 1024, seed=1)
        rho, _ = routing.e2e_success(net.link_eps)
        rho = rho.to(dev)
        p = torch.full((n,), 1.0 / n, device=dev)
        states = [registry.init_state(
            bundle, torch.Generator(dev).manual_seed(0), device=dev)
            for _ in range(n)]
        client_streams = [
            pipeline.lm_batches(
                synthetic.lm_token_stream(vocab=cfg.vocab, n_tokens=100_000,
                                          seed=c),
                args.batch, args.seq, seed=c)
            for c in range(n)]
        masks = torch.Generator(dev).manual_seed(0)
        for rnd in range(args.steps // args.rounds_per_exchange):
            losses = []
            for c in range(n):
                for _ in range(args.rounds_per_exchange):
                    states[c], loss, dt = step(states[c],
                                               next(client_streams[c]))
                    out["losses"].append(loss)
                    out["step_s"].append(dt)
                losses.append(loss)
            stacked = {k: torch.stack([s["params"][k] for s in states])
                       for k in states[0]["params"]}
            with torch.no_grad():
                new_stacked, _ = protocols.ra_round(
                    stacked, p, rho, seg_len=1024, generator=masks)
            del stacked
            for c in range(n):
                states[c]["params"] = {k: v[c] for k, v in
                                       new_stacked.items()}
            out["round_losses"].append(float(np.mean(losses)))
            print(f"round {rnd:3d} mean client loss {np.mean(losses):.4f} "
                  f"({time.perf_counter() - t_start:.1f}s)", flush=True)
        saved = states[0]["params"]
    out["k1_launches"] = ops.LAUNCHES["ra_aggregate"] - k1_before
    out["n_params"] = sum(v.numel() for v in saved.values())
    out["params"] = saved
    if args.checkpoint:
        checkpoint.save(args.checkpoint, saved, step=args.steps)
        print(f"saved checkpoint to {args.checkpoint}")
    return out


if __name__ == "__main__":
    main()
