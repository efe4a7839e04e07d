#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits nonzero (no phase is skipped):

  1. device    — requires CUDA; prints the card, its power limit, the torch
                 and CUDA versions and the two TF32 flags.
  2. build     — compiles every kernel under src/repro_torch/kernels/csrc/
                 with nvcc for sm_90a (one process per source, in parallel);
                 for K1 prints each instantiation's registers, shared
                 memory, spills and stack frame, and counts its 16-byte
                 loads and stores (LDG/STG .128) and LDGSTS (cp.async) in
                 `cuobjdump -sass`: the register body must hold 16-byte
                 loads, the shared-memory body LDGSTS, and none may spill
                 or keep a stack frame; for K2 prints each instantiation's registers, shared memory
                 and spills (ptxas -v) and counts its HGMMA (wgmma), UTMALDG
                 and UTMASTG (TMA) instructions in `cuobjdump -sass`: the bf16
                 D = 128 body must hold all three; for K3 the same per
                 instantiation, and the chunked body's HMMA (tensor cores)
                 and LDGSTS (cp.async) counts: both above 0, no spills.
  3. kernels   — K1 `ra_aggregate` in its four variants (two modes, with and
                 without a transmit mask) x {float32, bfloat16} at four
                 shapes, held to its plain PyTorch version on the same
                 inputs; prints each shape's launch (body, grid, tiles,
                 resident blocks an SM); times the kernel, the plain
                 version and one library call (`torch.bmm` of precomputed
                 coefficients, B*L folded into its batch) with CUDA
                 events, L2 cold and warm, beside the memory bound.
  4. reference — a quickstart-sized run on the card against the same run on
                 the CPU's plain path, with the same weights and draws.
  5. slice     — the main path: the full-width paper CNN on 28x28x1 data,
                 10 clients on the Table-II network, 3 rounds of each of
                 R&A (both modes), AaYG, C-FL and ideal C-FL; the kernel's
                 launch count is set to 0 just before and read just after.
  6. profile   — one R&A round under torch.profiler: device time by kernel,
                 and K1's own.
  7. k3        — K3 `rwkv6_scan` against its plain PyTorch version (the
                 sequential recurrence), output and final state, naming the
                 body each case ran: the chunked body (bf16, D = 64) at the
                 serving shape, at ragged lengths, on a strided head slice
                 and with decays at, below and partly below the -60/64
                 floor; the token body at two test shapes in float32 and at
                 the floor; times the chunked body, the token body and the
                 plain version at the serving shape with CUDA events, L2
                 cold and warm, beside the bytes bound and the token form's
                 operations bound.
  8. serve     — the second main path: `launch.serve.serve` on rwkv6-1.6b at
                 full width and depth (bfloat16, seed 0; 8 prompts of 2048
                 tokens, 32 generated per row); the kernel's launch count is
                 set to 0 just before and must read 24 (one per layer) just
                 after, all through the chunked body.  Then the same
                 prefill through the plain chunked scan (impl="torch") on
                 the card: with float32 activations
                 at full depth and in bfloat16 layer by layer, kernel
                 against plain; and each bfloat16 path against the float32
                 run, where the kernel may be at most 1.1x as far from it
                 as the plain path.
  9. serve-reference — the float32 smoke rwkv6 served on the card and on the
                 CPU's plain path from the same weights and prompts: the
                 greedy ids must be identical.
 10. serve-profile — one full-width prefill and one decode step under
                 torch.profiler: device time by kernel, launches, K3's share.
 11. k2        — K2 `flash_attention` against its plain PyTorch version
                 (float32 logits and softmax), in absolute error and against
                 each output row's size: at the dense serving shape (B=8,
                 S=2048, H=16, KV=2, D=128, bfloat16, causal), at the
                 reference's test shapes in float32 and bfloat16, one
                 non-causal shape, a ragged bf16 D = 128 shape, a bf16
                 D = 64 one with more work tiles than SMs, inputs whose
                 rows' maxima jump at later key tiles (the Hopper body's
                 lazy softmax must redo tiles there, and the count of such
                 tiles replayed from the logits must be above 0), and a
                 negative scale; times the kernel, the plain version and
                 `F.scaled_dot_product_attention` (the library yardstick,
                 used nowhere in the port) with CUDA events, L2 cold and
                 warm, beside the bound, and prints the persistent grid.
 12. dense-serve — the third main path: `launch.serve.serve` on qwen2.5-3b at
                 full width and depth (bfloat16, seed 0; 8 prompts of 2048
                 tokens, 32 generated per row); K2's launch count is set to
                 0 just before and must read 36 (one per layer) after the
                 prefill and still 36 after decode, which runs `_sdpa` in
                 plain PyTorch.  Then the same checks as phase 8, kernel
                 against impl="torch", with the K/V caches in place of the
                 states.
 13. dense-serve-reference — the float32 smoke qwen2.5 served on the card
                 and on the CPU's plain path: the greedy ids must be
                 identical.
 14. dense-serve-profile — one full-width prefill and one decode step under
                 torch.profiler: device time by kernel, K2's share.

It then prints the card line, one JSON line describing every ported kernel,
and last a JSON line with the device.  Without CUDA, or without the rest of
the repository beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# K1 checks: the slice shape, a batched prime-L shape, N > 16 receivers
# (the shared-memory body), and one round of examples/sweep_grid.py's
# 12-scenario grid at the slice's width (per-scenario masks; 405 MB, more
# than the 50 MB L2).
K1_SHAPES = [
    ("slice", dict(b=None, n=10, l=412, k=1024)),
    ("batched_primeL", dict(b=4, n=10, l=1181, k=256)),
    ("n33", dict(b=None, n=33, l=64, k=1024)),
    ("grid12", dict(b=12, n=10, l=412, k=1024)),
]
F32_TOL = 1e-5      # absolute; float32 sums in another order
BF16_TOL_ULP = 1.0  # bfloat16 spacing at the result's magnitude, + F32_TOL
# K3 checks: (name, (B, S, H, D), dtype of r/k/v, w as `k3_inputs` draws
# it, layout).  bf16 at D = 64 runs the chunked body: the serving shape,
# ragged last steps (S = 1, 63, 257, 1000), a strided head slice, and
# decays at the -60/64 floor, below it (-5, -60) and below it in some steps
# only; the rest runs the token body.
K3_CASES = [
    ("serve", (8, 2048, 32, 64), torch.bfloat16, None, "contiguous"),
    ("2x96x3x16", (2, 96, 3, 16), torch.float32, None, "contiguous"),
    ("1x128x4x64", (1, 128, 4, 64), torch.float32, None, "contiguous"),
    ("decay_floor", (1, 128, 4, 64), torch.float32, -60.0 / 64.0,
     "contiguous"),
    *((f"ragged_S{s}", (2, s, 4, 64), torch.bfloat16, None, "contiguous")
      for s in (1, 63, 257, 1000)),
    ("head_slice", (2, 300, 4, 64), torch.bfloat16, None, "strided"),
    ("bf16_floor", (2, 256, 4, 64), torch.bfloat16, -60.0 / 64.0,
     "contiguous"),
    ("bf16_w-5", (2, 256, 4, 64), torch.bfloat16, -5.0, "contiguous"),
    ("bf16_w-60", (2, 256, 4, 64), torch.bfloat16, -60.0, "contiguous"),
    ("bf16_mixed", (2, 512, 4, 64), torch.bfloat16, "mixed", "contiguous"),
]
K3_TOL = 2e-5        # absolute and relative, float32 outputs and states
# K2 checks: (name, (B, S, H, KV, D), dtype, causal, inputs as `k2_inputs`
# draws them).  The serving shape is qwen2.5-3b's prefill; the next ones are
# tests/test_kernels.py's; the `growth` and `scale1` cases make the Hopper
# body's lazy softmax redo tiles exactly (`k2_lazy_redos` counts them).
K2_CASES = [
    ("serve", (8, 2048, 16, 2, 128), torch.bfloat16, True, "randn"),
    *((f"{'x'.join(map(str, sh))}", sh, dt, True, "randn")
      for sh in ((2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 6, 2, 16))
      for dt in (torch.float32, torch.bfloat16)),
    ("full_2x96x6x2x16", (2, 96, 6, 2, 16), torch.float32, False, "randn"),
    ("full_2x96x6x2x16", (2, 96, 6, 2, 16), torch.bfloat16, False, "randn"),
    ("ragged_1x257", (1, 257, 16, 2, 128), torch.bfloat16, True, "randn"),
    ("d64_2x1000", (2, 1000, 16, 2, 64), torch.bfloat16, True, "randn"),
    ("growth_1x700", (1, 700, 16, 2, 128), torch.bfloat16, True, "growth"),
    ("growth_1x700", (1, 700, 16, 2, 128), torch.bfloat16, False, "growth"),
    ("growth_d64_2x520", (2, 520, 8, 2, 64), torch.bfloat16, True, "growth"),
    ("growth_d64_2x520", (2, 520, 8, 2, 64), torch.bfloat16, False, "growth"),
    ("scale1_1x700", (1, 700, 16, 2, 128), torch.bfloat16, True, "scale1"),
    ("negative_1x300", (1, 300, 16, 2, 128), torch.bfloat16, False,
     "negative"),
]
K2_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}   # absolute
# The same errors against each output row's own size (`k2_row_err`): late
# causal rows average many values and are small, so the absolute limit
# alone leaves room for a fault there.  bf16: about twice the largest
# reading on the H100 (3.27e-2, one ulp of a row's largest value); float32
# well above its readings (3.2e-6); the readings are in PERF.md section 6.
K2_ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 6.25e-2}
# The serving paths: tag -> (architecture, the kernel its prefill runs).
SERVE_PATHS = {"serve": ("rwkv6-1.6b", "rwkv6_scan"),
               "dense-serve": ("qwen2.5-3b", "flash_attention")}
SERVE_SHAPE = dict(batch=8, prompt_len=2048, gen=32)
# Serving prefill, kernel path vs impl="torch" (`serve_vs_plain`); limits
# of max |diff| / max |value| set from the readings in PERF.md section 6.
SERVE_F32_TOL = 1e-3    # float32 activations, full depth: logits, caches
SERVE_LAYER_TOL = 2e-2  # bf16 layer outputs from one input (~1 ulp at max;
                        # qwen2.5-3b read 1.3e-2)
SERVE_STATE_TOL = 1e-4  # bf16 layers' caches: time-mix states (float32),
                        # K/V (equal on both paths)
SERVE_BF16_RATIO = 1.1  # bf16 end to end: kernel's gap to the float32 run
                        # at most this times impl="torch"'s (read 0.99-1.01
                        # for rwkv6, 0.96 for qwen2.5)
SLICE_PROTOCOLS = [("ra", "ra_normalized"), ("ra", "substitution"),
                   ("aayg", "ra_normalized"), ("cfl", "ra_normalized"),
                   ("ideal_cfl", "ra_normalized")]


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def cuda_timer(dev):
    """``timer(fn, cold) -> ms``: median device time of one call over 30,
    each bracketed by CUDA events after GPU-side slack (so the host's
    enqueue is not timed); ``cold`` first overwrites a 256 MB buffer to
    evict the 50 MB L2."""
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def timer(fn, cold: bool, reps: int = 30) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            if cold:
                flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return timer


def k1_checks(dev, shapes, timer):
    """Phase 3: K1 against its plain version, with times and bounds."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ra_aggregate as _ra

    refs = {"ra_normalized": ref.ra_aggregate_ref,
            "substitution": ref.ra_substitution_ref}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    k1_lib = ops.load_library("ra_aggregate")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape_name, s in shapes:
        b, n, l, k = s["b"], s["n"], s["l"], s["k"]
        lead = () if b is None else (b,)
        for dtype in (torch.float32, torch.bfloat16):
            pl = _ra.plan(k1_lib, b or 1, n, l, k, dtype)
            waves = pl["blocks"] / (sms * pl["blocks_per_sm"])
            print(f"[k1] {shape_name:14s} {str(dtype)[6:]:8s} launch: "
                  f"{pl['body']} body, {pl['threads']} threads, "
                  f"{pl['smem_bytes']} B dynamic shared memory, "
                  f"{pl['blocks']} blocks for {pl['tiles']} tiles, "
                  f"{pl['blocks_per_sm']} resident an SM: {waves:.2f} of "
                  f"the card's resident blocks; {pl['receivers_per_warp']} "
                  f"receivers a warp, {pl['slabs']} slab(s)")
            for mode in ("ra_normalized", "substitution"):
                for with_tx in (False, True):
                    w = torch.randn(lead + (n, l, k), generator=gen,
                                    device=dev).to(dtype)
                    p = torch.rand(n, generator=gen, device=dev) + 0.1
                    p = p / p.sum()
                    e = torch.rand(lead + (n, n, l), generator=gen,
                                   device=dev) < 0.7
                    e |= torch.eye(n, dtype=torch.bool, device=dev)[:, :, None]
                    tx = (torch.rand((n, l), generator=gen, device=dev) < 0.5
                          if with_tx else None)
                    # The plain version takes batch-shaped p / tx.
                    pb = p if b is None else p[None].expand(b, n)
                    txb = (tx if tx is None or b is None
                           else tx[None].expand(b, n, l))

                    def kernel():
                        return ops.ra_aggregate(w, p, e, tx=tx, mode=mode,
                                                device=dev)

                    def plain():
                        return refs[mode](w, pb, e, txb)

                    launches_before = ops.LAUNCHES["ra_aggregate"]
                    gf = kernel().float()
                    wf = plain().float()
                    err = float((gf - wf).abs().max())
                    row = dict(shape=shape_name, dtype=str(dtype)[6:],
                               variant=mode + ("+tx" if with_tx else ""),
                               err=err)
                    if dtype == torch.float32:
                        row["ok"] = err <= F32_TOL
                        desc = f"max_abs_err={err:.3e} (tol {F32_TOL:g})"
                    else:
                        # Both sides round float32 sums to bfloat16; sums
                        # taken in another order may differ by F32_TOL, and
                        # rounding adds one bfloat16 ulp.
                        mag = torch.maximum(gf.abs(), wf.abs()).clamp_min(
                            torch.finfo(torch.float32).tiny)
                        ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
                        gap = (gf - wf).abs()
                        row["ulp"] = float((gap / ulp).max())
                        excess = float((gap - BF16_TOL_ULP * ulp).max())
                        row["ok"] = excess <= F32_TOL
                        desc = (f"max_abs_err={err:.3e} max_ulp="
                                f"{row['ulp']:.2f} (tol {BF16_TOL_ULP:g} ulp "
                                f"+ {F32_TOL:g})")
                    bytes_moved = (2 * w.numel() * w.element_size()
                                   + e.numel() * e.element_size()
                                   + 4 * p.numel()
                                   + (0 if tx is None else tx.numel()))
                    flops = 2 * (b or 1) * n * n * l * k
                    t_bytes = bytes_moved / HBM_BYTES_PER_S
                    t_ops = flops / F32_FLOP_PER_S
                    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
                    row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
                    for tag, cold in (("cold", True), ("warm", False)):
                        row[f"ms_{tag}"] = timer(kernel, cold)
                        row[f"plain_ms_{tag}"] = timer(plain, cold)
                    if not with_tx:
                        # Library yardstick: one bmm of precomputed
                        # (B*L, N, N)^T coefficients with (B*L, N, K)
                        # segments.
                        ef = e.float() * p[:, None, None]     # (.., m, n, l)
                        if mode == "ra_normalized":
                            coef = ef / ef.sum(-3, keepdim=True).clamp_min(1e-12)
                        else:
                            miss = p.sum() - ef.sum(-3)          # (.., n, l)
                            coef = ef + torch.diag_embed(
                                miss.transpose(-1, -2)).movedim(-3, -1)
                        coef_t = (coef.movedim(-1, -3).transpose(-1, -2)
                                  .contiguous().reshape(-1, n, n).to(dtype))
                        w_l = w.movedim(-2, -3).contiguous().reshape(-1, n, k)
                        lib = (torch.bmm(coef_t, w_l).reshape(lead + (l, n, k))
                               .movedim(-3, -2).float())
                        check(float((lib - wf).abs().max())
                              <= (1e-4 if dtype == torch.float32 else 0.1),
                              f"bmm yardstick disagrees at {shape_name}")
                        for tag, cold in (("cold", True), ("warm", False)):
                            row[f"library_ms_{tag}"] = timer(
                                lambda: torch.bmm(coef_t, w_l), cold)
                    ops.LAUNCHES["ra_aggregate"] = launches_before
                    rows.append(row)
                    lib_txt = (f" bmm {row['library_ms_cold'] * 1e3:.1f}/"
                               f"{row['library_ms_warm'] * 1e3:.1f} us"
                               if "library_ms_cold" in row else "")
                    print(f"[k1] {shape_name:14s} {row['dtype']:8s} "
                          f"{row['variant']:18s} {desc} "
                          f"{'ok' if row['ok'] else 'FAIL'} | kernel "
                          f"{row['ms_cold'] * 1e3:.1f}/"
                          f"{row['ms_warm'] * 1e3:.1f} us plain "
                          f"{row['plain_ms_cold'] * 1e3:.1f}/"
                          f"{row['plain_ms_warm'] * 1e3:.1f} us{lib_txt} | "
                          f"bound {row['bound_ms'] * 1e3:.2f} us "
                          f"({row['bound_by']}) [L2 cold/warm]")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"K1 disagrees with its plain version: {bad}")
    return rows


def reference_check(devices):
    """Phase 4: the same quickstart-sized rounds on ``devices[1]`` and on
    ``devices[0]``'s plain path, from the same weights and uniforms."""
    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.fl import simulator
    from repro_torch.models import smallnets

    data = synthetic.fed_image_classification(n_clients=10,
                                              samples_per_client=80)
    net = topology.make_network(topology.TABLE_II_COORDS,
                                packet_len_bits=100_000, tx_power_dbm=17.0)

    def mlp(g):
        return smallnets.init_mlp_clf(g, d_in=32, d_hidden=48)

    rng = np.random.default_rng(0)
    for protocol, mode in SLICE_PROTOCOLS[:3]:
        cfg = simulator.SimConfig(protocol=protocol, mode=mode, seg_len=256,
                                  local_epochs=3, n_rounds=2)
        sims = [simulator.build_sim(
            mlp, smallnets.apply_mlp_clf, data, seg_len=cfg.seg_len,
            local_epochs=cfg.local_epochs, n_rounds=cfg.n_rounds, device=d)
            for d in devices]
        sc = simulator.make_scenario(net, cfg)
        params0 = mlp(torch.Generator().manual_seed(0))
        states = [{"params": {k: v[None].expand((10,) + tuple(v.shape))
                              for k, v in params0.items()}} for _ in sims]
        n_seg = sims[0].n_segments
        for _ in range(cfg.n_rounds):
            shape = ((10, 10, n_seg) if protocol == "ra"
                     else (cfg.aayg_mixes, 10, 10, n_seg))
            u = torch.from_numpy(rng.random(shape, dtype=np.float32))
            outs = []
            for i, sim in enumerate(sims):
                states[i], m = sim.round_step(states[i], sc, u=u)
                outs.append(m)
            gap = max(float((states[1]["params"][k].cpu()
                             - states[0]["params"][k].cpu()).abs().max())
                      for k in params0)
            loss_gap = float((outs[1]["loss"].cpu()
                              - outs[0]["loss"].cpu()).abs().max())
            check(gap <= 1e-4 and loss_gap <= 1e-4,
                  f"{protocol}/{mode}: gap {gap:.2e} / {loss_gap:.2e}")
        print(f"[reference] {protocol}/{mode}: {devices[1]} == {devices[0]} "
              f"plain path after {cfg.n_rounds} rounds (param gap "
              f"{gap:.2e}, loss gap {loss_gap:.2e}; tol 1e-4)")


def slice_setup(dev, *, samples_per_client=600, hw=(28, 28),
                cnn_kwargs=None):
    """The slice's simulator and scenarios (phase 5)."""
    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.fl import simulator
    from repro_torch.models import smallnets

    data = synthetic.fed_image_classification(
        n_clients=10, d=hw[0] * hw[1], samples_per_client=samples_per_client)
    shape = (-1,) + tuple(hw) + (1,)
    data = dataclasses.replace(
        data, train_x=[x.reshape(shape) for x in data.train_x],
        test_x=data.test_x.reshape(shape))
    base = simulator.SimConfig(seg_len=1024, local_epochs=2, n_rounds=3,
                               seed=0)
    net = topology.paper_network(packet_len_bits=base.packet_len_bits)

    def init(g):
        return smallnets.init_cnn(g, in_hw=tuple(hw), **(cnn_kwargs or {}))

    sim = simulator.build_sim(
        init, smallnets.apply_cnn, data, seg_len=base.seg_len,
        local_epochs=base.local_epochs, n_rounds=base.n_rounds,
        aayg_mixes=base.aayg_mixes, device=dev)
    scenarios = {pm: simulator.make_scenario(
        net, dataclasses.replace(base, protocol=pm[0], mode=pm[1])).prepare()
        for pm in SLICE_PROTOCOLS}
    n_params = sum(v.numel() for v in
                   init(torch.Generator().manual_seed(0)).values())
    print(f"[slice] paper CNN {n_params} params, {sim.n_segments} segments "
          f"of {sim.seg_len}; 10 clients x "
          f"{max(len(x) for x in data.train_x)} padded samples of "
          f"{hw[0]}x{hw[1]}x1; tf32: matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    return sim, scenarios, base


def run_slice(sim, scenarios, base, sync):
    """Phase 5: every protocol for ``n_rounds``; returns the K1 launches."""
    from repro_torch.kernels import ops

    # Warm-up (cuDNN plans, allocator): one round, before the counted run.
    first = scenarios[SLICE_PROTOCOLS[0]]
    sim.advance_chunk(sim.init_scan(first), first)
    sync()

    ops.LAUNCHES["ra_aggregate"] = 0
    results = {}
    for pm in SLICE_PROTOCOLS:
        sc = scenarios[pm]
        state = sim.init_scan(sc)
        sync()
        rows, secs = [], []
        for _ in range(sim.n_chunks):
            t0 = time.perf_counter()
            state, m = sim.advance_chunk(state, sc)
            sync()
            secs.append(time.perf_counter() - t0)
            rows.append({k: v.cpu() for k, v in m.items()})
        results[pm] = (rows, secs)
    launches = ops.LAUNCHES["ra_aggregate"]

    for pm, (rows, secs) in results.items():
        acc = torch.stack([r["acc"] for r in rows])
        loss = torch.stack([r["loss"] for r in rows])
        bias = torch.cat([r["bias"] for r in rows])
        n_rounds = base.n_rounds
        check(tuple(acc.shape) == (n_rounds, 10)
              and tuple(loss.shape) == (n_rounds, 10),
              f"{pm}: metric shapes {tuple(acc.shape)} {tuple(loss.shape)}")
        check(bool(torch.isfinite(acc).all() and torch.isfinite(loss).all()),
              f"{pm}: non-finite accuracy or loss")
        if pm[0] == "ra":
            check(bool(torch.isfinite(bias).all()), f"{pm}: non-finite bias")
        print(f"[slice] {pm[0]:9s} {pm[1]:13s} acc/round "
              f"{[round(float(a), 4) for a in acc.mean(1)]} loss/round "
              f"{[round(float(x), 4) for x in loss.mean(1)]} s/round "
              f"{[round(x, 4) for x in secs]}")
    ideal = torch.stack([r["loss"] for r in
                         results[("ideal_cfl", "ra_normalized")][0]])
    check(float(ideal[-1].mean()) < float(ideal[0].mean()),
          "ideal_cfl train loss did not fall over the rounds")
    return launches


def _profiled(fn):
    """(wall ms, CUDA kernel events) of one call of ``fn`` under
    torch.profiler, ending in a device sync.  Kernel events only: CPU-side
    aten ops also report the device time of the kernels they launched."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    return wall_ms, [ev for ev in prof.key_averages()
                     if ev.device_type.name == "CUDA"
                     and ev.self_device_time_total > 0]


def profile_round(sim, scenario):
    """Phase 6: one R&A round under torch.profiler."""
    state = sim.init_scan(scenario)
    wall_ms, events = _profiled(lambda: sim.advance_chunk(state, scenario))
    dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    if dev_ms <= 0:
        print(f"[profile] one ra round: wall {wall_ms:.2f} ms, device time "
              f"not measured (the profiler saw no CUDA kernels)")
        return
    print(f"[profile] one ra round: wall {wall_ms:.2f} ms, device kernels "
          f"{dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}% of wall busy)")
    for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:10]:
        print(f"[profile]   {ev.self_device_time_total / 1e3:9.3f} ms "
              f"x{ev.count:<5d} {ev.key[:100]}")
    k1 = [ev for ev in events if re.search(r"ra_(reg|smem)_kernel", ev.key)]
    k1_us = sum(ev.self_device_time_total for ev in k1)
    print(f"[profile] ra_aggregate (K1): {k1_us:.1f} us in "
          f"{sum(ev.count for ev in k1)} launch(es) = "
          f"{100 * k1_us / 1e3 / dev_ms:.4f}% of device time")


def _bf16_ulps(got, want, atol):
    """Largest |got - want| - atol in bfloat16 ulps at the larger magnitude."""
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(
        torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float((((got - want).abs() - atol) / ulp).max())


def k3_inputs(shape, dtype, dev, w_kind=None, layout="contiguous", seed=1):
    """r, k, v (0.5 N(0, 1) in ``dtype``), w and u for K3.  ``w_kind``:
    None draws w = -exp(N(0, 1/4) - 1) (every decay well above the -60/64
    floor), a number makes w constant, "mixed" draws as None and sets
    tokens 100-139 of every head to -60 (some steps far below the floor).
    ``layout`` "strided" hands out head slices of tensors twice as wide."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r, k, v = ((0.5 * torch.randn(shape, generator=gen, device=dev))
               .to(dtype) for _ in range(3))
    if w_kind is None or w_kind == "mixed":
        w = -torch.exp(0.5 * torch.randn(shape, generator=gen, device=dev)
                       - 1.0)
        if w_kind == "mixed":
            w[:, 100:140] = -60.0
    else:
        w = torch.full(shape, float(w_kind), device=dev)
    u = 0.3 * torch.randn(shape[2:], generator=gen, device=dev)
    if layout == "strided":
        r, k, v, w = (torch.cat([t, torch.zeros_like(t)], dim=2)
                      [:, :, :shape[2]] for t in (r, k, v, w))
    return r, k, v, w, u


def k3_bounds(shape, elem=2):
    """(bytes, float32 operations of the token form, bf16 tensor operations
    of the chunked form) for K3 at (B, S, H, D), r/k/v/out of ``elem``
    bytes, with the final state.  Bytes: r, k, v, w and u read once, out and
    the state written once.  The token form: y += r s; x = k v;
    s = s exp(w) + x, 5 operations per (token, d, e), and 4 per (token, d)
    for the bonus.  The
    chunked form per token: six 64 x 64 part products for (r P) S, three for
    (k Q)^T v, three 16 x 64 for A v (multiply-adds, 2 operations each)."""
    b, s, h, d = shape
    n = b * s * h
    bytes_moved = 4 * n * d * elem + n * d * 4 + h * d * 4 + b * h * d * d * 4
    token_ops = 5 * n * d * d + 4 * n * d
    chunked_ops = 2 * n * (6 * d * d + 3 * d * d + 3 * 16 * d)
    return bytes_moved, token_ops, chunked_ops


def k3_checks(dev, timer):
    """Phase 7: K3 against its plain version, with times and bounds."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import rwkv6_scan as _rwkv

    rows = []
    for name, shape, dtype, w_kind, layout in K3_CASES:
        r, k, v, w, u = k3_inputs(shape, dtype, dev, w_kind, layout)
        body = _rwkv.body(dtype, shape[3])

        def kernel():
            return ops.rwkv6_scan(r, k, v, w, u, return_state=True)

        def token_body():   # the launch alone, through the first body
            return _rwkv.launch(ops.load_library("rwkv6_scan"), r, k, v, w,
                                u, tile=_rwkv.TILE, return_state=True,
                                which="token")

        def plain():
            return ref.rwkv6_scan_ref(r, k, v, w, u, return_state=True)

        launches_before = ops.LAUNCHES["rwkv6_scan"]
        bodies_before = dict(_rwkv.BODY_LAUNCHES)
        got, got_state = kernel()
        ran = [b for b in _rwkv.BODIES
               if _rwkv.BODY_LAUNCHES[b] > bodies_before[b]]
        want, want_state = plain()
        got, want = got.float(), want.float()
        err = float((got - want).abs().max())
        state_err = float((got_state - want_state).abs().max())
        state_ok = bool(torch.allclose(got_state, want_state, atol=K3_TOL,
                                       rtol=K3_TOL))
        row = dict(case=name, shape=shape, dtype=str(dtype)[6:], body=body,
                   err=err, state_err=state_err)
        ok = state_ok and ran == [body] and bool(torch.isfinite(got).all())
        if dtype == torch.float32:
            row["ok"] = ok and bool(torch.allclose(
                got, want, atol=K3_TOL, rtol=K3_TOL))
            desc = f"max_abs_err={err:.3e} (tol {K3_TOL:g} abs+rel)"
        else:
            row["ulp"] = _bf16_ulps(got, want, K3_TOL)
            row["ok"] = ok and row["ulp"] <= 1.0
            desc = (f"max_abs_err={err:.3e} max_ulp={row['ulp']:.2f} (tol 1 "
                    f"ulp + {K3_TOL:g})")
        bytes_moved, token_ops, chunked_ops = k3_bounds(shape,
                                                        r.element_size())
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_token = token_ops / F32_FLOP_PER_S
        t_chunked = chunked_ops / BF16_FLOP_PER_S
        t_ops = t_chunked if body == "chunked" else t_token
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        row["token_bound_ms"] = 1e3 * max(t_bytes, t_token)
        timing = ""
        if name == "serve":
            for tag, cold in (("cold", True), ("warm", False)):
                row[f"ms_{tag}"] = timer(kernel, cold)
                row[f"token_ms_{tag}"] = timer(token_body, cold)
                row[f"plain_ms_{tag}"] = timer(plain, cold, reps=5)
            timing = (
                f" | {body} body {row['ms_cold'] * 1e3:.1f}/"
                f"{row['ms_warm'] * 1e3:.1f} us, token body (tile "
                f"{_rwkv.TILE}) {row['token_ms_cold'] * 1e3:.1f}/"
                f"{row['token_ms_warm'] * 1e3:.1f} us, plain "
                f"{row['plain_ms_cold']:.2f}/{row['plain_ms_warm']:.2f} ms "
                f"[L2 cold/warm] | bounds: bytes {t_bytes * 1e6:.1f} us "
                f"({bytes_moved / 1e6:.1f} MB; "
                f"{100 * t_bytes / (row['ms_cold'] * 1e-3):.1f}% reached "
                f"cold), token form {t_token * 1e6:.1f} us "
                f"({token_ops / 1e9:.2f} GFLOP float32), chunked form's "
                f"products {t_chunked * 1e6:.1f} us ({chunked_ops / 1e9:.2f}"
                f" GFLOP bf16); grid {shape[0] * shape[2]} blocks")
        ops.LAUNCHES["rwkv6_scan"] = launches_before
        rows.append(row)
        print(f"[k3] {name:12s} {'x'.join(map(str, shape)):14s} "
              f"{row['dtype']:8s} {layout:10s} w={w_kind} {body} body: "
              f"{desc} state_err={state_err:.3e} "
              f"{'ok' if row['ok'] else 'FAIL'}{timing}")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"K3 disagrees with its plain version: {bad}")
    return rows


def _ptxas_report(log: str | None, instance) -> list:
    """(instance, registers, static shared memory, spill stores, spill
    loads, stack frame) per kernel entry of an ``-Xptxas -v`` log."""
    rows, name, spills = [], None, (0, 0, 0)
    for line in (log or "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spills = instance(m.group(1)), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spills = (int(m.group(2)), int(m.group(3)), int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            sm = re.search(r"(\d+) bytes smem", line)
            rows.append((name, int(m.group(1)), int(sm.group(1)) if sm else 0,
                         *spills))
            name = None
    return rows


def _sass_counts(so_path, instance, opcodes) -> dict | None:
    """{instance: {opcode: count}} from ``cuobjdump -sass`` of a built
    library, or None without cuobjdump.  ``opcodes``: names, or a dict of
    name -> regular expression."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    if not isinstance(opcodes, dict):
        opcodes = {op: rf"\b{op}\b" for op in opcodes}
    sass = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, check=True).stdout
    return {instance(chunk.split("\n", 1)[0]):
            {op: len(re.findall(pat, chunk)) for op, pat in opcodes.items()}
            for chunk in re.split(r"\n\s*Function : ", sass)[1:]}


def _k1_instance(mangled: str) -> str:
    """'reg<float, 10>' or 'smem<bf16, 5>' from a mangled K1 name."""
    m = re.search(r"ra_(reg|smem)_kernelI(f|13__nv_bfloat16)Li(\d+)E", mangled)
    if not m:
        return mangled
    dtype = "float" if m.group(2) == "f" else "bf16"
    return f"{m.group(1)}<{dtype}, {m.group(3)}>"


# K1's SASS: 16-byte global loads and stores, cp.async, tensor-core products.
K1_SASS = {"LDG.128": r"\bLDG(?:\.\w+)*\.128\b",
           "STG.128": r"\bSTG(?:\.\w+)*\.128\b",
           "LDGSTS": r"\bLDGSTS\b", "HMMA": r"\bHMMA\b"}


def k1_build_report(log: str | None, so_path) -> None:
    """Phase 2, K1: registers, shared memory, spills and stack frame per
    instantiation (register body: N = 1..16; shared-memory body: R = 3..8
    receivers a warp), and the 16-byte and cp.async instructions in each
    one's SASS.  No instantiation may spill
    or keep a stack frame; each register body must load 16 bytes at a
    time, each shared-memory body copy by cp.async."""
    if log is None:
        print("[build] ra_aggregate was built before this run: no ptxas "
              "report, spills not measured")
    report = _ptxas_report(log, _k1_instance)
    for name, regs, smem, st, ld, frame in report:
        print(f"[build] ra_aggregate {name}: {regs} registers, {smem} B "
              f"static shared memory, spill stores/loads {st}/{ld} B, stack "
              f"frame {frame} B")
    bad = [r for r in report if r[3:] != (0, 0, 0)]
    check(log is None or (len(report) == 44 and not bad),
          f"K1 instantiations spill, keep a stack frame or are missing "
          f"({len(report)} of 44): {bad}")
    counts = _sass_counts(so_path, _k1_instance, K1_SASS)
    check(counts is not None, "cuobjdump not found: K1's SASS cannot be "
          "checked")
    for inst, c in sorted(counts.items()):
        print(f"[build] ra_aggregate {inst} SASS: " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
    missing = [inst for inst, c in counts.items()
               if c["LDG.128" if inst.startswith("reg") else "LDGSTS"] == 0]
    check(not missing, f"K1 bodies without 16-byte loads / cp.async in "
          f"their SASS: {missing}")


def _k2_instance(mangled: str) -> str:
    """'hopper<bf16, 128>' or 'simt<float, 64>' from a mangled K2 name."""
    m = re.search(r"(hopper|simt)\d+flash_attention_kernelI(f|13__nv_bfloat16)?"
                  r"Li(\d+)E", mangled)
    if not m:
        return mangled
    dtype = "float" if m.group(2) == "f" else "bf16"
    return f"{m.group(1)}<{dtype}, {m.group(3)}>"


def _k3_instance(mangled: str) -> str:
    """'chunked<bf16, 64>' or 'token<float, 16, state>' from a mangled K3
    name."""
    if "rwkv6_scan_chunked_kernel" in mangled:
        return "chunked<bf16, 64>"
    m = re.search(r"rwkv6_scan_token_kernelI(f|13__nv_bfloat16)Li(\d+)"
                  r"ELb([01])E", mangled)
    if not m:
        return mangled
    dtype = "float" if m.group(1) == "f" else "bf16"
    state = ", state" if m.group(3) == "1" else ""
    return f"token<{dtype}, {m.group(2)}{state}>"


def k2_build_report(log: str | None, so_path) -> None:
    """Phase 2, K2: registers, shared memory and spills per instantiation
    (``-Xptxas -v``; ``log`` is None if the library was built before this
    run), dynamic shared memory per launch, and the wgmma and TMA
    instructions in the built library's SASS."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    if log is None:
        print("[build] flash_attention was built before this run: no ptxas "
              "report")
    for name, regs, smem, st, ld, _ in _ptxas_report(log, _k2_instance):
        print(f"[build] flash_attention {name}: {regs} registers, {smem} B "
              f"static shared memory, spill stores/loads {st}/{ld} B")
    lib = ops.load_library("flash_attention")
    print("[build] flash_attention dynamic shared memory per launch: " + ", ".join(
        f"{str(dt)[6:]} D={d} {fa.smem_bytes(lib, dt, d)} B"
        for dt in (torch.float32, torch.bfloat16) for d in fa.HEAD_DIMS))
    counts = _sass_counts(so_path, _k2_instance,
                          ("HGMMA", "UTMALDG", "UTMASTG", "HMMA"))
    if counts is None:
        print("[build] flash_attention SASS: cuobjdump not found; HGMMA / "
              "UTMALDG counts not measured")
        return
    for inst, c in counts.items():
        print(f"[build] flash_attention {inst} SASS: " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
    wg = counts.get("hopper<bf16, 128>", {})
    check(all(wg.get(op, 0) > 0 for op in ("HGMMA", "UTMALDG", "UTMASTG")),
          f"the bf16 D = 128 body lacks wgmma or TMA in its SASS: {wg}")


def k3_build_report(log: str | None, so_path) -> None:
    """Phase 2, K3: registers, shared memory and spills per instantiation,
    dynamic shared memory per launch, and the chunked body's tensor-core
    (HMMA) and asynchronous-copy (LDGSTS) instructions in its SASS; the
    chunked body must hold both and spill nothing."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as _rwkv

    if log is None:
        print("[build] rwkv6_scan was built before this run: no ptxas "
              "report, spills not measured")
    report = _ptxas_report(log, _k3_instance)
    for name, regs, smem, st, ld, frame in report:
        print(f"[build] rwkv6_scan {name}: {regs} registers, {smem} B static "
              f"shared memory, spill stores/loads {st}/{ld} B, stack frame "
              f"{frame} B")
    chunked = [r for r in report if r[0] == "chunked<bf16, 64>"]
    check(log is None or (chunked and chunked[0][3:] == (0, 0, 0)),
          f"the chunked body spills, uses local memory or is missing: "
          f"{chunked}")
    lib = ops.load_library("rwkv6_scan")
    print(f"[build] rwkv6_scan dynamic shared memory per launch: chunked "
          f"{_rwkv.smem_bytes(lib, 'chunked')} B, token (tile {_rwkv.TILE}) "
          + ", ".join(f"D={d} {_rwkv.smem_bytes(lib, 'token', d)} B"
                      for d in _rwkv.HEAD_DIMS))
    counts = _sass_counts(so_path, _k3_instance,
                          ("HMMA", "HGMMA", "LDGSTS", "UTMALDG"))
    check(counts is not None, "cuobjdump not found: the chunked body's SASS "
          "cannot be checked")
    c = counts.get("chunked<bf16, 64>", {})
    print("[build] rwkv6_scan chunked<bf16, 64> SASS: " + ", ".join(
        f"{op} {n}" for op, n in c.items()))
    check(c.get("HMMA", 0) + c.get("HGMMA", 0) > 0
          and c.get("LDGSTS", 0) + c.get("UTMALDG", 0) > 0,
          f"the chunked body lacks tensor-core or asynchronous-copy "
          f"instructions in its SASS: {c}")


def k2_inputs(shape, dtype, dev, *, kind="randn", causal=True, seed=0):
    """q (B, S, H, D), k and v (B, S, KV, D) for K2, drawn N(0, 1) in float32
    with numpy from ``seed`` and cast to ``dtype``, and the scale.  By kind:

      randn     scale D^-0.5: the logits are about N(0, 1), so no row's max
                ever jumps far at a later key tile;
      growth    as randn, but every 16th key from key 128 on is c q_i for a
                query row i of one head of its group (a row of a later query
                tile if causal), c rising from 1.5 to 3 along S: row i's
                logit there is about c sqrt(D), far above the about 3 that
                the randn keys give it;
      scale1    randn at scale 1: the logits are about N(0, D);
      negative  randn at scale -D^-0.5.

    ``growth`` and ``scale1`` make the Hopper body's lazy softmax redo tiles
    exactly (`k2_lazy_redos`); ``negative`` takes the exact softmax on every
    tile.  Where the softmax is that peaked an output row is about one row
    of v, so those two draw v at half scale: outputs stay below 4, where
    one bfloat16 ulp (2^-6) lies inside the absolute 3e-2 (at 4.2 one ulp
    is 2^-5, over it)."""
    b, s, h, kv, d = shape
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(b, s, n, d)).astype(np.float32)
               for n in (h, kv, kv))
    scale = {"randn": d ** -0.5, "growth": d ** -0.5, "scale1": 1.0,
             "negative": -d ** -0.5}[kind]
    if kind == "growth":
        for bi in range(b):
            for kvh in range(kv):
                for j in range(128, s, 16):
                    lo = (j // 128 + 1) * 128 if causal else 0
                    if lo >= s:
                        break
                    i = rng.integers(lo, s)
                    hq = kvh * (h // kv) + rng.integers(h // kv)
                    k[bi, j, kvh] = (1.5 + 1.5 * j / s) * q[bi, i, hq]
    if kind in ("growth", "scale1"):
        v *= 0.5
    return [torch.from_numpy(t).to(dev, dtype) for t in (q, k, v)] + [scale]


def k2_lazy_redos(q, k, scale, causal, margin=0.5):
    """How many (16-row warp, key tile) pairs the Hopper body's lazy softmax
    must redo exactly on these inputs, replaying its rule on the float32
    logits: past the first key tile, a tile with no masked entry (not on
    the diagonal, not ragged) is redone by a warp where some row's max, in
    the log2 domain, is above the running max by more than 8; the running
    max takes the tile's max only on an exact tile.  Counts the pairs where
    that excess is above 8 + ``margin``, clear of summation-order
    differences.  Zero for a negative scale (no lazy tile)."""
    tile, warp, lazy_log2 = 128, 16, 8.0   # kBQ = kBK, rows a warp, kLazyLog2
    if scale <= 0:
        return 0
    b, s, h, _ = q.shape
    kf = k.float().repeat_interleave(h // k.shape[2], dim=2)
    x = torch.einsum("bihd,bjhd->bhij", q.float(), kf)
    x = x * (scale * math.log2(math.e))
    idx = torch.arange(s, device=q.device)
    qt = idx // tile
    if causal:
        x = x.masked_fill(idx[None, :] > idx[:, None], -math.inf)

    def any_in_warp(rows):       # (..., S) -> (..., warps)
        rows = torch.nn.functional.pad(rows, (0, -s % warp))
        return rows.unflatten(-1, (-1, warp)).any(-1)

    m = x[..., :tile].amax(-1)
    redos = 0
    for j in range(1, -(-s // tile)):
        tmax = x[..., tile * j:tile * (j + 1)].amax(-1)
        seen = qt >= j if causal else torch.ones_like(qt, dtype=torch.bool)
        edge = (causal & (qt == j)) | (tile * (j + 1) > s)
        excess = torch.where(seen & ~edge, tmax - m, -math.inf)
        redos += int(any_in_warp(excess > lazy_log2 + margin).sum())
        redo = any_in_warp(excess > lazy_log2).repeat_interleave(warp, -1)
        exact = (seen & edge) | redo[..., :s]
        m = torch.where(exact, torch.maximum(m, tmax), m)
    return redos


def k2_row_err(got, want):
    """The largest error of any output row against that row's own size:
    max |got - want| over the row / the row's root mean square."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    return float((diff / want.pow(2).mean(-1).sqrt().clamp_min(1e-30)).max())


def k2_checks(dev, timer):
    """Phase 11: K2 against its plain version, with times and bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for seed, (name, shape, dtype, causal, kind) in enumerate(K2_CASES):
        b, s, h, kv, d = shape
        q, k, v, scale = k2_inputs(shape, dtype, dev, kind=kind,
                                   causal=causal, seed=seed)

        def kernel():
            return ops.flash_attention(q, k, v, scale=scale, causal=causal)

        def plain():
            return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal)

        launches_before = ops.LAUNCHES["flash_attention"]
        got, want = kernel().float(), plain().float()
        err = float((got - want).abs().max())
        row_err = k2_row_err(got, want)
        redos = k2_lazy_redos(q, k, scale, causal)
        tol, row_tol = K2_TOL[dtype], K2_ROW_TOL[dtype]
        row = dict(case=name, shape=shape, dtype=str(dtype)[6:],
                   causal=causal, err=err, row_err=row_err, redos=redos,
                   ok=(err <= tol and row_err <= row_tol
                       and (redos > 0 or kind not in ("growth", "scale1"))))
        # Bytes: q, k, v read once and out written once.  Operations: the
        # QK^T and PV products over the (query, key) pairs the mask keeps,
        # 2 x 2 D each, at the peak rate of the inputs' type.
        bytes_moved = 2 * (q.numel() + k.numel()) * q.element_size()
        pairs = s * (s + 1) // 2 if causal else s * s
        flops = 4 * b * h * d * pairs
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = flops / (BF16_FLOP_PER_S if dtype == torch.bfloat16
                         else F32_FLOP_PER_S)
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timing = ""
        if name == "serve":
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))

            def library():
                return F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale,
                    enable_gqa=True)

            lib_err = float((library().transpose(1, 2).float() - want)
                            .abs().max())
            check(lib_err <= tol, f"SDPA yardstick disagrees: {lib_err:.3e}")
            for tag, cold in (("cold", True), ("warm", False)):
                row[f"ms_{tag}"] = timer(kernel, cold)
                row[f"plain_ms_{tag}"] = timer(plain, cold, reps=5)
                row[f"library_ms_{tag}"] = timer(library, cold)
            timing = (f" | kernel {row['ms_cold'] * 1e3:.1f}/"
                      f"{row['ms_warm'] * 1e3:.1f} us plain "
                      f"{row['plain_ms_cold']:.2f}/{row['plain_ms_warm']:.2f}"
                      f" ms sdpa {row['library_ms_cold'] * 1e3:.1f}/"
                      f"{row['library_ms_warm'] * 1e3:.1f} us | bound "
                      f"{row['bound_ms'] * 1e3:.1f} us ({row['bound_by']}; "
                      f"{bytes_moved / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)"
                      f" [L2 cold/warm]; sdpa gap {lib_err:.3e}")
        blocks, threads, tiles, tile_rows = fa.grid((b, s, h, d), dtype, sms)
        timing += (f" | {fa.body(dtype, d)} body: grid {blocks} blocks of "
                   f"{threads} threads over {tiles} work tiles of "
                   f"{tile_rows} query rows")
        ops.LAUNCHES["flash_attention"] = launches_before
        rows.append(row)
        print(f"[k2] {name:18s} {'x'.join(map(str, shape)):16s} "
              f"{row['dtype']:8s} {'causal' if causal else 'full':6s} "
              f"scale {scale:.4g} max_abs_err={err:.3e} (tol {tol:g}) "
              f"row_err={row_err:.3e} (tol {row_tol:g}) lazy redos {redos} "
              f"{'ok' if row['ok'] else 'FAIL'}{timing}")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"K2 disagrees with its plain version: {bad}")
    return rows


def serve_full(dev, tag):
    """Phase 8 / 12: a serving path at full width through
    `launch.serve.serve`; its kernel's launches are counted per phase."""
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as _rwkv
    from repro_torch.launch import serve

    arch, kernel = SERVE_PATHS[tag]
    cfg = base.get(arch)
    # Warm-up (cuBLAS handles and plans, the allocator) with a short prompt,
    # before the counted run.
    serve.serve(cfg, batch=SERVE_SHAPE["batch"], prompt_len=64, gen=2, seed=1)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    ops.LAUNCHES[kernel] = 0
    for body in _rwkv.BODIES:
        _rwkv.BODY_LAUNCHES[body] = 0
    res = serve.serve(cfg, **SERVE_SHAPE, seed=0)
    launches = ops.LAUNCHES[kernel]
    bodies = dict(_rwkv.BODY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in res.params.values())
    b, gen = SERVE_SHAPE["batch"], SERVE_SHAPE["gen"]
    check(tuple(res.tokens.shape) == (b, gen), f"ids {tuple(res.tokens.shape)}")
    check(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab,
          "generated ids outside the vocabulary")
    check(bool(torch.isfinite(res.prefill_logits).all()),
          "non-finite prefill logits")
    for name, t in res.prefill_cache.items():
        check(bool(torch.isfinite(t).all()), f"non-finite prefill {name}")
    if cfg.family == "ssm":
        heads = (f"{cfg.rwkv_cfg().n_heads} heads of "
                 f"{cfg.rwkv_cfg().head_dim}")
    else:
        heads = (f"{cfg.n_heads} heads and {cfg.n_kv_heads} kv heads of "
                 f"{cfg.hd}")
    print(f"[{tag}] {cfg.name}: {n_params} parameters ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{str(cfg.dtype)[6:]}); batch {b} x prompt "
          f"{SERVE_SHAPE['prompt_len']} + {gen} generated")
    print(f"[{tag}] prefill {res.prefill_s:.4f} s; decode {res.decode_steps} "
          f"steps x batch {b} in {res.decode_s:.4f} s = "
          f"{res.decode_tokens_per_s:.1f} tok/s; max_memory_allocated "
          f"{peak / 2**30:.3f} GiB")
    print(f"[{tag}] ids, row 0: {res.tokens[0].tolist()}")
    pre, dec = res.prefill_launches[kernel], res.decode_launches[kernel]
    print(f"[{tag}] {kernel} launches on the serving path: {pre} in the "
          f"prefill, {dec} in decode, {launches} in all (expected "
          f"{cfg.n_layers}, one per layer of the prefill)")
    check(pre == cfg.n_layers and dec == 0 and launches == cfg.n_layers,
          f"{kernel} launched {pre} times in the prefill and {dec} in decode, "
          f"expected {cfg.n_layers} and 0")
    if kernel == "rwkv6_scan":
        print(f"[{tag}] rwkv6_scan launches by body: {bodies} (expected all "
              f"{cfg.n_layers} through the chunked body)")
        check(bodies == {"token": 0, "chunked": cfg.n_layers},
              f"rwkv6_scan bodies on the serving path: {bodies}")

    serve_vs_plain(cfg, res, tag, kernel)
    return cfg, res, launches


def _rel_gap(got, want):
    """max |got - want| over max |want|, in float32."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max() / want.abs().max())


def _rel_l2(got, want):
    """||got - want|| over ||want|| (Frobenius) over paired tensors, in
    float32."""
    num = den = 0.0
    for a, b in zip(got, want):
        num += float(torch.linalg.vector_norm(a.float() - b.float())) ** 2
        den += float(torch.linalg.vector_norm(b.float())) ** 2
    return math.sqrt(num / den)


def serve_gaps(cfg, params, prompt, logits, cache, kernel):
    """The serving prefill's precision, from the kernel path's bfloat16
    ``logits`` and ``cache`` (time-mix states, or K/V caches) for
    ``params`` and ``prompt``:

      * f32_*: the same weights (widened, exactly) with float32 activations
        at full depth, kernel against impl="torch";
      * layer_*: the bfloat16 model layer by layer from the same input,
        kernel against impl="torch" (worst layer);
      * bf16_*_kernel / bf16_*_torch: each bfloat16 path's relative L2 gap
        to the float32 impl="torch" run, logits and all layers' caches.

    Gaps named *_max are max |diff| over max |value|.  The launches of
    ``kernel`` this makes are not counted.
    """
    from repro_torch.kernels import ops
    from repro_torch.models import layers, registry
    from repro_torch.models import transformer as T

    launches = ops.LAUNCHES[kernel]
    tokens = {"tokens": prompt}
    g = {}
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    p32 = {k: v.float() for k, v in params.items()}
    bundle32 = registry.build(cfg32)
    dev = prompt.device
    lk32, ck32 = bundle32.prefill_step(p32, tokens, impl="kernel", device=dev)
    lt32, ct32 = bundle32.prefill_step(p32, tokens, impl="torch", device=dev)
    check(ops.LAUNCHES[kernel] == launches + cfg.n_layers,
          "the float32 prefill did not go through the kernel once per layer")
    g["f32_logits_max"] = _rel_gap(lk32, lt32)
    g["f32_cache_max"] = max(_rel_gap(a, b) for name in ck32
                             for a, b in zip(ck32[name], ct32[name]))
    g["f32_same_ids"] = bool(torch.equal(lk32.argmax(-1), lt32.argmax(-1)))
    del p32, lk32, ck32

    lt, ct = registry.build(cfg).prefill_step(params, tokens, impl="torch",
                                              device=dev)
    for name, (lg, c) in (("kernel", (logits, cache)), ("torch", (lt, ct))):
        g[f"bf16_logits_{name}"] = _rel_l2([lg], [lt32])
        g[f"bf16_cache_{name}"] = _rel_l2([c[n] for n in c],
                                          [ct32[n] for n in c])
        g[f"bf16_logits_max_{name}"] = _rel_gap(lg, lt32)
    g["bf16_logits_max_kernel_vs_torch"] = _rel_gap(logits, lt)
    del lt, ct, lt32, ct32

    with torch.no_grad():
        x = layers.embed(T._sub(params, "embed"), prompt).to(cfg.dtype)
        g["layer_out_max"] = g["layer_cache_max"] = 0.0
        for lp in T.layer_params(params, cfg.n_layers):
            xk, ck = T._block(cfg, lp, x, impl="kernel", return_cache=True)
            xt, ct = T._block(cfg, lp, x, impl="torch", return_cache=True)
            g["layer_out_max"] = max(g["layer_out_max"], _rel_gap(xk, xt))
            pairs = zip(ck, ct) if isinstance(ck, tuple) else [(ck, ct)]
            g["layer_cache_max"] = max(g["layer_cache_max"],
                                       *(_rel_gap(a, b) for a, b in pairs))
            x = xk
    ops.LAUNCHES[kernel] = launches
    return g


def serve_vs_plain(cfg, res, tag, kernel):
    """Phase 8 / 12, second half: the serving prefill through the kernel
    against the plain path (impl="torch") on the card, from the same
    weights and prompts (`serve_gaps`).

    The two paths sum in other orders, so their outputs differ in the last
    float32 bits; in bfloat16 that flips the rounding of some activations
    by one ulp, and a deep stack of random layers amplifies such flips, so
    the two bfloat16 paths are not held to each other end to end.  Each is
    held instead to the same weights run with float32 activations: the
    kernel path may be at most SERVE_BF16_RATIO times as far from it as the
    plain path is.  The float32 run and each bfloat16 layer hold the
    kernel to the plain path directly, at limits set from their readings.
    """
    g = serve_gaps(cfg, res.params, res.prompt, res.prefill_logits,
                   res.prefill_cache, kernel)
    what = "state" if cfg.family == "ssm" else "K/V cache"
    print(f"[{tag}] float32 activations, full width and depth: kernel vs "
          f"impl='torch' logits gap/max {g['f32_logits_max']:.3e} (tol "
          f"{SERVE_F32_TOL:g}), worst layer {what} gap/max "
          f"{g['f32_cache_max']:.3e} (tol {SERVE_F32_TOL:g}); same greedy "
          f"ids: {g['f32_same_ids']}")
    print(f"[{tag}] bfloat16, each layer from the same input: worst output "
          f"gap/max {g['layer_out_max']:.3e} (tol {SERVE_LAYER_TOL:g}), "
          f"worst {what} gap/max {g['layer_cache_max']:.3e} (tol "
          f"{SERVE_STATE_TOL:g})")
    print(f"[{tag}] bfloat16 end to end, relative L2 gap to the float32 "
          f"run: logits kernel {g['bf16_logits_kernel']:.3e} vs impl='torch' "
          f"{g['bf16_logits_torch']:.3e}, {what} kernel "
          f"{g['bf16_cache_kernel']:.3e} vs impl='torch' "
          f"{g['bf16_cache_torch']:.3e} (kernel at most "
          f"{SERVE_BF16_RATIO:g}x); logits gap/max kernel "
          f"{g['bf16_logits_max_kernel']:.3e}, impl='torch' "
          f"{g['bf16_logits_max_torch']:.3e}, kernel vs impl='torch' "
          f"{g['bf16_logits_max_kernel_vs_torch']:.3e}")
    check(g["f32_logits_max"] <= SERVE_F32_TOL
          and g["f32_cache_max"] <= SERVE_F32_TOL,
          "float32 prefill: kernel vs impl='torch'")
    check(g["layer_out_max"] <= SERVE_LAYER_TOL
          and g["layer_cache_max"] <= SERVE_STATE_TOL,
          "bfloat16 layers: kernel vs impl='torch'")
    check(g["bf16_logits_kernel"] <= SERVE_BF16_RATIO * g["bf16_logits_torch"]
          and g["bf16_cache_kernel"]
          <= SERVE_BF16_RATIO * g["bf16_cache_torch"],
          "bfloat16 prefill: the kernel path is farther from the float32 "
          "run than impl='torch' allows")


def serve_reference(dev, tag):
    """Phase 9 / 13: the float32 smoke model on the card and on the CPU's
    plain path, from the same weights and prompts."""
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import registry

    arch, kernel = SERVE_PATHS[tag]
    cfg = base.smoke_variant(base.get(arch))
    params = registry.build(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 128),
                           generator=torch.Generator().manual_seed(1))
    kw = dict(batch=4, prompt_len=128, gen=16)
    cpu = serve.serve(cfg, **kw, device="cpu", params=params, tokens=tokens)
    before = ops.LAUNCHES[kernel]
    gpu = serve.serve(cfg, **kw, device=dev,
                      params={k: v.to(dev) for k, v in params.items()},
                      tokens=tokens.to(dev))
    check(ops.LAUNCHES[kernel] == before + cfg.n_layers,
          "the card's smoke run did not go through the kernel")
    ops.LAUNCHES[kernel] = before
    gap = float((gpu.prefill_logits.cpu() - cpu.prefill_logits).abs().max())
    same = bool(torch.equal(gpu.tokens, cpu.tokens))
    print(f"[{tag}-reference] {cfg.name} float32, batch 4 x prompt 128 + 16: "
          f"card ids == CPU plain-path ids: {same}; prefill logits gap "
          f"{gap:.3e}")
    check(same, f"greedy ids differ: card {gpu.tokens.tolist()} vs CPU "
          f"{cpu.tokens.tolist()}")


def profile_serve(cfg, res, tag, kernel):
    """Phase 10 / 14: one full-width prefill and one decode step under
    torch.profiler."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    bundle = registry.build(cfg)
    s = res.prompt.shape[1]
    token = res.tokens[:, :1].to(res.prompt.device)
    cache = serve.grow_cache(res.prefill_cache, s + 1)
    for what, fn in (
            ("prefill", lambda: bundle.prefill_step(
                res.params, {"tokens": res.prompt})),
            ("decode step", lambda: bundle.serve_step(
                res.params, cache, token, s))):
        wall_ms, events = _profiled(fn)
        dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
        if dev_ms <= 0:
            print(f"[{tag}-profile] {what}: wall {wall_ms:.2f} ms, device "
                  f"time not measured (the profiler saw no CUDA kernels)")
            continue
        k_ms = sum(ev.self_device_time_total for ev in events
                   if kernel in ev.key) / 1e3
        print(f"[{tag}-profile] {what}: wall {wall_ms:.2f} ms, device kernels "
              f"{dev_ms:.2f} ms ({100 * dev_ms / wall_ms:.1f}% of wall busy) "
              f"in {sum(ev.count for ev in events)} launches; {kernel} "
              f"{k_ms:.3f} ms = {100 * k_ms / dev_ms:.1f}% of device time")
        for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:12]:
            print(f"[{tag}-profile]   {ev.self_device_time_total / 1e3:9.3f} "
                  f"ms x{ev.count:<5d} {ev.key[:100]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import ops

    # 1. device
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {card} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()} | tf32: matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    logs = ops.build_all()
    build_s = time.perf_counter() - t0
    for name, log in sorted(logs.items()):
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[build] {name}: {len(regs)} kernel instantiations, max "
              f"{max(regs, default=0)} registers, max spill stores "
              f"{max(spills, default=0)} bytes")
    print(f"[build] {len(logs)} kernel source(s) built with nvcc for sm_90a "
          f"in {build_s:.2f} s")
    k1_build_report(logs.get("ra_aggregate"), ops.lib_path("ra_aggregate"))
    k2_build_report(logs.get("flash_attention"),
                    ops.lib_path("flash_attention"))
    k3_build_report(logs.get("rwkv6_scan"), ops.lib_path("rwkv6_scan"))

    # 3. kernels
    timer = cuda_timer(dev)
    rows = k1_checks(dev, K1_SHAPES, timer)
    torch.cuda.synchronize()

    # 4. reference
    reference_check((torch.device("cpu"), dev))

    # 5. slice (the main path)
    sim, scenarios, base = slice_setup(dev)
    launches = run_slice(sim, scenarios, base, torch.cuda.synchronize)
    # R&A launches once per round in each mode, AaYG once per mix.
    expected = 2 * base.n_rounds + base.n_rounds * base.aayg_mixes
    check(launches == expected,
          f"ra_aggregate launched {launches} times on the main path, "
          f"expected {expected}")
    print(f"[slice] ra_aggregate launches on the main path: {launches} "
          f"(expected {expected})")

    # 6. profile
    profile_round(sim, scenarios[SLICE_PROTOCOLS[0]])
    del sim, scenarios

    # 7. k3
    k3_rows = k3_checks(dev, timer)
    torch.cuda.synchronize()

    # 8. serve (the second main path)
    serve_cfg, res, k3_launches = serve_full(dev, "serve")

    # 9. serve-reference
    serve_reference(dev, "serve")

    # 10. serve-profile
    profile_serve(serve_cfg, res, "serve", "rwkv6_scan")
    del res
    torch.cuda.empty_cache()

    # 11. k2
    k2_rows = k2_checks(dev, timer)
    torch.cuda.synchronize()

    # 12. dense-serve (the third main path)
    dense_cfg, res, k2_launches = serve_full(dev, "dense-serve")

    # 13. dense-serve-reference
    serve_reference(dev, "dense-serve")

    # 14. dense-serve-profile
    profile_serve(dense_cfg, res, "dense-serve", "flash_attention")
    del res

    main_row = next(r for r in rows if r["shape"] == "slice"
                    and r["dtype"] == "float32"
                    and r["variant"] == "ra_normalized")
    worst_f32 = max(r["err"] for r in rows if r["dtype"] == "float32")
    check(math.isfinite(main_row["ms_cold"]), "non-finite kernel time")
    kernels = [{
        "name": "ra_aggregate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ra_aggregate.cu",
        "replaces": "src/repro/kernels/ra_aggregate.py:177",
        "launches": launches,
        "max_abs_err": worst_f32,
        "ms": main_row["ms_cold"],
        "ms_warm_l2": main_row["ms_warm"],
        "plain_ms": main_row["plain_ms_cold"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms_cold"],
        "shape": "B=1 N=10 L=412 K=1024 float32, bool mask, L2 cold",
    }]
    k3_row = next(r for r in k3_rows if r["case"] == "serve")
    check(math.isfinite(k3_row["ms_cold"]), "non-finite K3 time")
    kernels.append({
        "name": "rwkv6_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan.py:100",
        "body": k3_row["body"],
        "launches": k3_launches,
        "max_abs_err": max(r["err"] for r in k3_rows
                           if r["dtype"] == "float32"),
        "max_ulp_bf16": max(r["ulp"] for r in k3_rows
                            if r["dtype"] == "bfloat16"),
        "max_state_err": max(r["state_err"] for r in k3_rows),
        "ms": k3_row["ms_cold"],
        "ms_warm_l2": k3_row["ms_warm"],
        "token_body_ms": k3_row["token_ms_cold"],
        "token_body_ms_warm_l2": k3_row["token_ms_warm"],
        "plain_ms": k3_row["plain_ms_cold"],
        "bound_ms": k3_row["bound_ms"],
        "bound_by": k3_row["bound_by"],
        "token_form_bound_ms": k3_row["token_bound_ms"],
        "library_ms": None,
        "shape": "B=8 S=2048 H=32 D=64, bfloat16 r/k/v, float32 w, with "
                 "the final state, L2 cold; max_abs_err over the float32 "
                 "cases (token body)",
    })
    k2_row = next(r for r in k2_rows if r["case"] == "serve")
    check(math.isfinite(k2_row["ms_cold"]), "non-finite K2 time")
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "launches": k2_launches,
        "max_abs_err": max(r["err"] for r in k2_rows
                           if r["dtype"] == "float32"),
        "ms": k2_row["ms_cold"],
        "ms_warm_l2": k2_row["ms_warm"],
        "plain_ms": k2_row["plain_ms_cold"],
        "bound_ms": k2_row["bound_ms"],
        "bound_by": k2_row["bound_by"],
        "library_ms": k2_row["library_ms_cold"],
        "shape": "B=8 S=2048 H=16 KV=2 D=128 bfloat16, causal, L2 cold; "
                 "library: F.scaled_dot_product_attention(is_causal=True, "
                 "enable_gqa=True)",
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
