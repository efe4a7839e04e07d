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
                 D = 64, 128 and 256 bodies must hold all three, the D = 256
                 one spill nothing and take at most 227 KB of shared
                 memory; for K3 the same per
                 instantiation, and the chunked body's HMMA (tensor cores)
                 and LDGSTS (cp.async) counts: both above 0, no spills.
  3. kernels   — K1 `ra_aggregate` in its four variants (two modes, with and
                 without a transmit mask) x {float32, bfloat16} at nine
                 shapes (four of earlier paths, and each that phases 18 and
                 19 launch it at: phase 19 fails if they launch another), held to its plain PyTorch version on the same
                 inputs; prints each shape's launch (body, grid, tiles,
                 resident blocks an SM); times the kernel, the plain
                 version and one library call (`torch.bmm` of precomputed
                 coefficients, B*L folded into its batch) with CUDA
                 events, L2 cold and warm, beside the memory bound.
  4. reference — a quickstart-sized run on the card against the same run on
                 the CPU's plain path, with the same weights and draws:
                 R&A (both modes) and AaYG, then R&A under the top-k and
                 quantizing codecs (the same quantizer uniforms) and under
                 the `loss` sampling policy (`advance_chunk`; the selected
                 masks must be equal).
  5. slice     — the main path: the full-width paper CNN on 28x28x1 data,
                 10 clients on the Table-II network, 3 rounds of each of
                 R&A (both modes), AaYG, C-FL and ideal C-FL; the kernel's
                 launch count is set to 0 just before and read just after.
  6. profile   — one R&A round under torch.profiler: device time by kernel,
                 and K1's own.
  7. slice-codec — the main path of slice 4 at the slice's width, 3 rounds
                 a row: R&A under the top-k and quantizing codecs, AaYG
                 under top-k, C-FL under quantization, R&A with a (3, 10)
                 participation schedule and per-client epochs, under the
                 `loss` and `budget` sampling policies, and with local
                 AdamW; K1's launch counts (all, and those through its
                 transmit-mask variant) are set to 0 just before and must
                 equal what the rows give just after (1 a round for R&A,
                 J for AaYG, 0 for C-FL; the codec rows through the
                 transmit-mask variant); then one profiled R&A round under
                 the quantizer: device time of the codec, the exchange
                 (K1 in it) and the rest (local training and metrics).
  8. k3        — K3 `rwkv6_scan` against its plain PyTorch version (the
                 sequential recurrence), output and final state, naming the
                 body each case ran: the chunked body (bf16, D = 64) at the
                 serving shape, at ragged lengths, on a strided head slice
                 and with decays at, below and partly below the -60/64
                 floor; the token body at two test shapes in float32 and at
                 the floor; times the chunked body, the token body and the
                 plain version at the serving shape with CUDA events, L2
                 cold and warm, beside the bytes bound and the token form's
                 operations bound.
  9. serve     — the second main path: `launch.serve.serve` on rwkv6-1.6b at
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
 10. serve-reference — the float32 smoke rwkv6 served on the card and on the
                 CPU's plain path from the same weights and prompts: the
                 greedy ids must be identical.
 11. serve-profile — one full-width prefill and one decode step under
                 torch.profiler: device time by kernel, launches, K3's share.
 12. k2        — K2 `flash_attention` against its plain PyTorch version
                 (float32 logits and softmax), in absolute error and against
                 each output row's size: at the dense serving shape (B=8,
                 S=2048, H=16, KV=2, D=128, bfloat16, causal), at the
                 reference's test shapes in float32 and bfloat16, one
                 non-causal shape, a ragged bf16 D = 128 shape, a bf16
                 D = 64 one with more work tiles than SMs, inputs whose
                 rows' maxima jump at later key tiles (the Hopper body's
                 lazy softmax must redo tiles there, and the count of such
                 tiles replayed from the logits must be above 0; at D = 64,
                 128 and 256), and a negative scale; then llama3-8b's,
                 starcoder2-3b's and gemma-7b's prefills (gemma at D =
                 256), llama3-8b's
                 under a window of 512, D = 256 in float32 and bf16 at a
                 ragged S, and windows (40, 300, 512, S, past S; causal and
                 full) at D = 64, 128 and 256, a window of S or more
                 bit-equal to none; whisper-base's encoder (full, S =
                 1,500) and decoder and the VLM's prefill (64 heads, GQA 8);
                 times the kernel, the plain version and
                 `F.scaled_dot_product_attention` (the library yardstick,
                 used nowhere in the port; with the boolean window mask
                 under a window) with CUDA events, L2 cold and warm, beside
                 the bound (under a window the pairs it keeps), at each
                 dense prefill shape, and prints the body and the
                 persistent grid.
 13. dense-serve — the third main path: `launch.serve.serve` on qwen2.5-3b at
                 full width and depth (bfloat16, seed 0; 8 prompts of 2048
                 tokens, 32 generated per row); K2's launch count is set to
                 0 just before and must read 36 (one per layer) after the
                 prefill and still 36 after decode, which runs `_sdpa` in
                 plain PyTorch.  Then the same checks as phase 9, kernel
                 against impl="torch", with the K/V caches in place of the
                 states.
 14. dense-serve-reference — the float32 smoke qwen2.5 served on the card
                 and on the CPU's plain path: the greedy ids must be
                 identical.
 15. dense-serve-profile — one full-width prefill and one decode step under
                 torch.profiler: device time by kernel, K2's share.
 16. grid      — the scenario-grid engine (`fl.scenarios.GridRunner`) at the
                 slice's width (paper CNN, 10 clients, 600 samples of
                 28x28x1, 3 rounds, 2 local epochs), three sub-grids:
                 grid12 (examples/sweep_grid.py's axes: 32,768- and
                 400,000-bit Table-II networks x R&A normalized, R&A
                 substitution, AaYG x seeds 0, 1: 3 groups of 4), relays
                 (Fig. 9: ideal C-FL on the Table-II network plus R&A on
                 10 clients with 0 / 7 / 14 / 28 routing-only relays, V
                 padded to 38) and dynamic (R&A under a Markov and a fading
                 link schedule, a (3, 10) sampling schedule, top-k 0.5).
                 K1's launch counts are set to 0 before the three batched
                 runs and must read 15 after them (one a round per R&A
                 group: 9 + 3 + 3; 3 through the transmit-mask variant),
                 each launch's B the group's size (`BATCH_LAUNCHES`).
                 Every batched row is held to the same scenario through
                 `run_sequential` on the card (the same seeds, so the same
                 draws): per-client train loss within 1e-4, accuracy within
                 one test sample.  Prints each sub-grid's wall seconds,
                 scenarios per second and peak device memory, batched and
                 sequential; then one profiled batched round of a grid12
                 group: local training's gradient passes, the exchange and
                 K1 in it, by device time.
 17. serve-tier — the serving tier on phase 16's model, data and statics:
                 (a) `launch.serving.ScenarioServer` (max_batch 4, one
                 bucket of 4) serves grid12's 12 scenarios as 12
                 single-scenario requests from two tenants, a quarter at
                 priority 1; (b) `launch.router.ScenarioRouter.in_process`
                 with two replicas on the card serves the same 12, and the
                 replica owning grid12's first family is killed (its
                 server hard-stopped while it holds a dispatch) after the
                 first delivery: all 12 must deliver exactly once, with a
                 retry; (c) `checkpoint.run_resumable` on the slice's R&A
                 scenario, interrupted after one chunk and resumed.  K1 is
                 launched from the servers' dispatcher threads: its counts
                 are set to 0 before each part and must equal one a round
                 per dispatched group (from the servers' dispatch logs),
                 each launch's B the group's padded size, and one a round
                 of each resumable run.  Served, routed and resumed rows
                 are held to phase 16's `run_sequential` (and the resumed
                 run to an uninterrupted one and to `run_scenario`) within
                 1e-4 in loss and one test sample in accuracy; prints
                 req/s, p50 / p99 latency, mean coalesced scenarios, batch
                 fill, the router's counters, peak device memory, whether
                 the resumed rows are bit-identical and save / restore
                 seconds.

 18. paper-tasks — the paper's other tasks at their full width: first each
                 at a reduced size (ResNet depth 8 width 4 on 16x16, CharRNN
                 hidden 32) for 2 R&A rounds on the card and on the CPU's
                 plain path from the same weights and uniforms (parameters
                 and losses within 1e-4, accuracies equal); then
                 `build_sim` -> `advance_chunk` on the Table-II network
                 (N = 10, seg 1024, 2 local epochs, 3 rounds) of R&A
                 normalized, AaYG and C-FL for ResNet-18 (width 16, 10
                 classes) and ResNet-56 (width 16, 100 classes) on
                 32x32x3 images from `fed_image_classification(d=3072)`,
                 and the CharRNN (embed 8, hidden 256) on the iid and the
                 non-iid `fed_char_stream`; K1's count is set to 0 before
                 each run and must read one a round for R&A and J for AaYG
                 just after; losses finite and R&A's round-3 train loss
                 below round 1's; s/round and peak memory per run; one
                 profiled R&A round per task (local training, K1, the
                 rest).  Last, `registry.sim_model("transformer_nwp")`
                 through `run_grid` with benchmarks/fig_nwp.py's grid (R&A,
                 C-FL, no exchange x 2 seeds; seq 16, seg 64, lr 0.5, 10
                 rounds): K1 10 launches of B = 2.
 19. train     — `launch.train.main` on the card: first K2 and K3 must raise
                 under autograd and `torch.func.grad`; (a) qwen2.5-3b at full
                 width and depth (bf16, 3,085,938,688 parameters, AdamW with
                 float32 moments at lr 3e-5, remat), 3 steps of 8 x 128
                 tokens: the first loss near ln V + d_model 0.02^2 / 2, the
                 last below it, with the caching allocator's device
                 allocations and retries and the share of the bf16 weights
                 that moved; its float32 twin at 3e-5 must fall too, and at
                 lr 3e-4 a bf16 run and its float32 twin must agree within
                 0.15 a step (`train_witness`); then one more step from the same
                 weights under torch.profiler (AdamW update against forward
                 + backward, GEMM kernels); (b) ``--dfl`` at the smoke size,
                 4 clients, 10 steps, an exchange every 5: K1 launched twice
                 through `protocols.ra_round`; K2 and K3 launch no time in
                 either; s/step, tokens/s and peak memory.  Last, one float32 smoke
                 `train_step` of qwen2.5 and rwkv6 on the card against the
                 CPU from the same weights (loss 1e-5; moments 1e-4;
                 parameters 1e-4 where |g| >= 1e-6, within the AdamW step's
                 bound elsewhere).

 20. dense-zoo — llama3-8b, starcoder2-3b and gemma-7b through
                 `launch.serve.serve` at full width and depth (bfloat16,
                 seed 0; 8 prompts of 2048 tokens, 32 generated per row):
                 K2's count set to 0 just before and read just after, 32,
                 30 and 28 (one a prefill layer; gemma's at D = 256 through
                 the Hopper body's 80-key tiles), none in decode; each
                 prefill held to impl="torch" as in phase 13; prefill s, decode tok/s and
                 ms a step (gemma's tied unembedding casts its 3.1 GB table
                 to float32 every step), peak memory, and one profiled
                 prefill and decode step (K2's share).
 21. window    — (a) llama3-8b served at full width under a window of 512
                 (K2 windowed, 32 launches, held to impl="torch"; decode
                 under the window mask against the grown cache), profiled;
                 (b) llama3-8b float32 at full width decoding 288 greedy
                 steps from empty into a wrapped cache of 128 slots
                 (pos = abs % 128, abs_pos, full_cache) against the
                 unwrapped windowed decode on the same tokens: the same
                 ids, logits within 1e-3 of their largest; (c) one step at
                 long_500k's decode (batch 1, 8192 wrapped slots, abs_pos
                 524,287): s a step and peak memory; (d) `train_step` on
                 llama3-8b at full width and 4 layers (bf16, 8 x 512
                 tokens) under attn_impl naive, chunked and flash from the
                 same weights and batches, 3 steps each, losses within
                 0.15 of naive's, no K2 or K3 launch; a float32 smoke
                 flash `train_step` card vs CPU.
 22. moe-hybrid — (a) granite-moe-1b-a400m (32 experts top-8) and
                 hymba-1.5b (attention beside a selective SSM) through
                 `launch.serve.serve` at full width and depth as in phase
                 20: K2 24 and 32 launches (GQA 2 and 5), none in decode;
                 each prefill held to impl="torch" (`serve_vs_plain`; the
                 MoE's paths routed as the float32 impl="torch" run routes,
                 `MoeRoutes`); one profiled prefill and decode step each,
                 split into K2, the MoE's route / dispatch / experts /
                 combine and the SSM's terms / scan (`PROFILE_PARTS`);
                 (b) `launch.train.main` on both at full width and depth,
                 3 AdamW steps of 8 x 128 tokens: loss, aux, s/step,
                 tokens/s, peak memory, no K2 or K3 launch; (c) the float32
                 smoke variants of both and of dbrx-132b (~262 GB in bf16,
                 over the card) served and one `train_step` each, card
                 against the CPU; (d) phase 18's NWP grid with
                 `nwp:granite_moe_1b_a400m` and `nwp:hymba_1_5b` clients,
                 3 rounds, K1 once a round (B = 2).
 23. modal     — (a) whisper-base (enc_dec: 6 encoder layers over 1,500
                 frames, 6 decoder layers) through `launch.serve.serve` at
                 full width and depth (bfloat16, seed 0; 8 prompts of 416
                 tokens + 32 generated, frames a standard normal draw), its
                 cross blocks' gates set from a numpy seed: K2 12 launches in
                 the prefill, 6 of them full (the encoder, S = 1,500) and 6
                 causal, none in decode; the prefill held to impl="torch"
                 (`serve_vs_plain`, encoder and decoder layers alike, the
                 cross K/V among the caches); one profiled prefill and
                 decode step split into K2 by mask, the cross-attention,
                 the GEMMs and the rest; (b) llama-3.2-vision-90b (vlm) at
                 full width and 10 of its 100 layers the same way (K2 8
                 launches at 64 heads over 8, 1,600 patches); (c)
                 `launch.train.main` on whisper-base at full width and depth,
                 3 AdamW steps of 8 x 128 tokens (zero frames, as the
                 reference's), no K2 or K3 launch, then one `train_step`
                 with standard normal frames and the gates set: some
                 encoder leaf's gradient non-zero; (d) both float32 smoke
                 variants served and one `train_step` each, card against
                 the CPU.  Phase 12 holds K2 at the three new shapes.
 24. multi-rank — 10 ranks on the one card over gloo (NCCL needs a card
                 per rank), started by `launch.mesh.spawn`; any rank's
                 failure fails the phase.  First each collective of
                 `launch.mesh` on CUDA tensors against its values; (a)
                 `core.dfl_step.ra_exchange` at the slice's width (rank =
                 client, `init_cnn` from seed m, 412 segments) for each
                 comm, without and with `MULTI_RANK_MASK`, against the
                 single-process `protocols.ra_round_seg` (K1) on the same
                 draws (1e-5; sampled-out ranks bit-equal), then each comm
                 timed (median of 10, barrier to barrier) with the bytes a
                 rank hands to its collectives; (b) one
                 `make_dfl_train_step` round (2 GD steps on each rank's 600
                 samples, the `loss` policy at 0.5) against a
                 single-process replay of every client's steps and
                 `ra_round_seg` under the mask it selects (same selection,
                 1e-4); (c) grid12 through `run_grid` over a (2, 2)
                 ('grid', 'model') mesh of ranks 0-3 against phase 16's
                 `run_sequential` (loss 1e-4, accuracy within one test
                 sample): each model shard launches K1 9 times on its
                 window, (2, 10, 206, 1024), counted per rank; grid
                 seconds and peak memory a rank; (d) `run_resumable` on a
                 (1, 2) mesh of ranks 0-1, stopped after one chunk and
                 resumed against the unbroken run, and its one-chunk
                 checkpoint finished here in one process; (e) phase 17's
                 traffic (grid12's 12 scenarios as 12 requests, 2 tenants,
                 a quarter at priority 1, max_batch 4, one bucket of 4)
                 through `ScenarioServer(devices=[0, 1, 2, 3])` on a
                 4-rank ('grid',) mesh, rank 0 leading, ranks 1-3
                 following; (f) the same through
                 `ScenarioRouter.in_process(n_replicas=2, devices=([0, 1,
                 2, 3], 2))` on the (2, 2) mesh, the owner of grid12's
                 first family held in a dispatch and killed after the first
                 delivery: 12 of 12 delivered once, at least one retry, and
                 the killed replica's followers leave their loop before
                 the survivor's.  Ranks 4-9 build both and idle.  Rows of
                 (e) and (f) held to phase 16's `run_sequential` (loss
                 1e-4, accuracy one test sample); each rank's K1 launches
                 by (B, N, L, K) equal what the leader's dispatch log gives
                 (one a round per dispatched group, J for AaYG, at B = the
                 padded group / the grid rows it spans).  Phase 3 holds K1
                 at every shape phase 24 launches.  REPRO_AGG_IMPL must be
                 unset.
 25. dryrun    — (a) the card against `launch.mesh`'s roofline constants:
                 its name, power limit and SM count must be the H100 SXM
                 80GB's (132 SMs, HBM3) whose published figures they are;
                 (b) `python -m repro_torch.launch.dryrun --arch qwen2.5-3b
                 --shape prefill_32k` on this machine's CPU and torch, in
                 a subprocess started after the build and run beside the
                 card phases (at most DRYRUN_TIMEOUT_S): exit 0 and ok, its
                 terms printed as dry-run estimates; (c) the first
                 whole-step readings, as `mfu` lines that gate nothing:
                 `dryrun.model_flops` of phase 13's qwen2.5-3b prefill
                 (SERVE_SHAPE, inference) and of phase 19's qwen2.5-3b
                 steps (training, the median s/step after step 0) over
                 their seconds times `mesh.PEAK_FLOPS_BF16`.

It then prints the card line, one JSON line describing every ported kernel
(K2's with its launches by path and by mask and its time at each prefill
shape; K1's launches by path include phase 24's, ``multi-rank:*``),
and last a JSON line with the device.  Without CUDA, or without the rest of
the repository beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import atexit
import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
SMEM_PER_BLOCK = 232448     # dynamic shared memory a block may take (227 KB)

# K1 checks: the slice shape, a batched prime-L shape, N > 16 receivers
# (the shared-memory body), and one round of examples/sweep_grid.py's
# 12-scenario grid at the slice's width (per-scenario masks; 405 MB, more
# than the 50 MB L2).  Then every shape phases 18 and 19 launch it at
# (`main` checks that they launch no other): ResNet-18, ResNet-56 and the
# CharRNN at seg 1024, the NWP grid's R&A group (2 seeds, seg 64), and
# `launch.train --dfl`'s 4 smoke qwen2.5 clients (N = 4: its own
# register-body instantiation); then phase 22's NWP grids of the
# `nwp:granite_moe_1b_a400m` and `nwp:hymba_1_5b` clients (2 seeds, seg 64);
# then phase 24's model shards' windows (206 of the slice's 412 segments):
# grid12's groups split over a (2, 2) mesh (2 scenarios a grid row) and
# `run_resumable`'s R&A scenario on a (1, 2) mesh.
K1_SHAPES = [
    ("slice", dict(b=None, n=10, l=412, k=1024)),
    ("batched_primeL", dict(b=4, n=10, l=1181, k=256)),
    ("n33", dict(b=None, n=33, l=64, k=1024)),
    ("grid12", dict(b=12, n=10, l=412, k=1024)),
    ("resnet18", dict(b=None, n=10, l=171, k=1024)),
    ("resnet56", dict(b=None, n=10, l=838, k=1024)),
    ("charrnn", dict(b=None, n=10, l=802, k=1024)),
    ("nwp_grid", dict(b=2, n=10, l=371, k=64)),
    ("train_dfl", dict(b=None, n=4, l=1218, k=1024)),
    ("nwp_granite", dict(b=2, n=10, l=55708, k=64)),
    ("nwp_hymba", dict(b=2, n=10, l=24333, k=64)),
    ("grid12_shard", dict(b=2, n=10, l=206, k=1024)),
    ("slice_shard", dict(b=None, n=10, l=206, k=1024)),
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
# draws them, sliding window or None).  The serving shape is qwen2.5-3b's
# prefill; the next ones are tests/test_kernels.py's; the `growth` and
# `scale1` cases make the Hopper body's lazy softmax redo tiles exactly
# (`k2_lazy_redos` counts them), at D = 64, 128 and 256 (80-key tiles, Q
# read from shared memory by the redo).  Then the other dense serving
# shapes (`K2_TIMED` times them): llama3-8b's, starcoder2-3b's and gemma-7b's
# prefill (D = 256, the Hopper body) and llama3-8b's under phase 21's window
# of 512; phase 22's prefills, granite-moe-1b-a400m's (GQA 2) and
# hymba-1.5b's (GQA 5, 25 heads); phase 23's, whisper-base's encoder
# (bidirectional, S = 1,500 = 11 x 128 + 92: a ragged last tile) and
# decoder prefills (GQA 1 at D = 64) and llama-3.2-vision-90b's (64 query
# heads, GQA 8); D = 256 in float32 and bf16, causal and full, at a ragged S; and
# windows at D = 64, 128 and 256 over S = 2048 (the Hopper body in bf16,
# the first body in float32): below one tile (40), not a
# multiple of 128 (300), phase 21's 512, and S or more, which must equal no
# window bit for bit.
K2_WINDOWS = (40, 300, 512, 2048, 5000)
K2_CASES = [
    ("serve", (8, 2048, 16, 2, 128), torch.bfloat16, True, "randn", None),
    *((f"{'x'.join(map(str, sh))}", sh, dt, True, "randn", None)
      for sh in ((2, 64, 4, 2, 32), (1, 128, 8, 8, 64), (2, 96, 6, 2, 16))
      for dt in (torch.float32, torch.bfloat16)),
    ("full_2x96x6x2x16", (2, 96, 6, 2, 16), torch.float32, False, "randn",
     None),
    ("full_2x96x6x2x16", (2, 96, 6, 2, 16), torch.bfloat16, False, "randn",
     None),
    ("ragged_1x257", (1, 257, 16, 2, 128), torch.bfloat16, True, "randn",
     None),
    ("d64_2x1000", (2, 1000, 16, 2, 64), torch.bfloat16, True, "randn", None),
    ("growth_1x700", (1, 700, 16, 2, 128), torch.bfloat16, True, "growth",
     None),
    ("growth_1x700", (1, 700, 16, 2, 128), torch.bfloat16, False, "growth",
     None),
    ("growth_d64_2x520", (2, 520, 8, 2, 64), torch.bfloat16, True, "growth",
     None),
    ("growth_d64_2x520", (2, 520, 8, 2, 64), torch.bfloat16, False, "growth",
     None),
    ("scale1_1x700", (1, 700, 16, 2, 128), torch.bfloat16, True, "scale1",
     None),
    *((f"{kind}_d256", (1, 700, 8, 2, 256), torch.bfloat16, causal, kind,
       None)
      for kind in ("growth", "scale1") for causal in (True, False)),
    ("negative_1x300", (1, 300, 16, 2, 128), torch.bfloat16, False,
     "negative", None),
    ("llama_serve", (8, 2048, 32, 8, 128), torch.bfloat16, True, "randn",
     None),
    ("starcoder_serve", (8, 2048, 24, 2, 128), torch.bfloat16, True, "randn",
     None),
    ("gemma_serve", (8, 2048, 16, 16, 256), torch.bfloat16, True, "randn",
     None),
    ("llama_window512", (8, 2048, 32, 8, 128), torch.bfloat16, True, "randn",
     512),
    ("granite_serve", (8, 2048, 16, 8, 64), torch.bfloat16, True, "randn",
     None),
    ("hymba_serve", (8, 2048, 25, 5, 64), torch.bfloat16, True, "randn",
     None),
    *((f"d256_2x333{'' if causal else '_full'}", (2, 333, 4, 2, 256), dt,
       causal, "randn", None)
      for dt in (torch.float32, torch.bfloat16) for causal in (True, False)),
    *((f"d{d}_w{w}", (1, 2048, 8, 2, d), torch.bfloat16, True, "randn", w)
      for d in (64, 128, 256) for w in K2_WINDOWS),
    *((f"d{d}_w300_full", (1, 2048, 8, 2, d), torch.bfloat16, False, "randn",
       300) for d in (64, 128, 256)),
    ("d128_w300_f32", (1, 2048, 8, 2, 128), torch.float32, True, "randn", 300),
    ("d256_w40_f32_full", (1, 333, 4, 2, 256), torch.float32, False, "randn",
     40),
    ("growth_w300", (1, 700, 16, 2, 128), torch.bfloat16, True, "growth", 300),
    ("growth_w512", (1, 1100, 16, 2, 128), torch.bfloat16, True, "growth",
     512),
    ("whisper_enc", (8, 1500, 8, 8, 64), torch.bfloat16, False, "randn",
     None),
    ("whisper_dec", (8, 416, 8, 8, 64), torch.bfloat16, True, "randn", None),
    ("vlm_serve", (8, 2048, 64, 8, 128), torch.bfloat16, True, "randn", None),
]
# The cases timed with the L2 cold and warm beside SDPA and the bound: the
# dense prefills at full width, then phase 22's: granite-moe-1b-a400m's
# (GQA 2 at D = 64) and hymba-1.5b's (25 heads over 5 kv heads, GQA 5);
# then phase 23's: whisper-base's encoder and decoder, the VLM's.
K2_TIMED = ("serve", "llama_serve", "starcoder_serve", "gemma_serve",
            "llama_window512", "granite_serve", "hymba_serve", "whisper_enc",
            "whisper_dec", "vlm_serve")
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
SMOKE_TOL = 1e-4        # float32 smoke models, card vs CPU (abs and rel;
                        # `serve_reference`)
SERVE_SERVED_TOL = 0.0  # MoE: the served prefill vs the same kernel path
                        # run layer by layer (the same operations; read 0)
SERVE_MOE_OWN_RATIO = 1.1  # MoE, each path by its own routing: the served
                           # run's flips and cache gap to the float32 run at
                           # most this times impl="torch"'s (read 0.96-1.00
                           # over seeds 0-2)
SERVE_MOE_LOGITS_RATIO = 1.25  # the same for the last position's logits,
                               # 8 rows that flips move more (read 1.01-1.14)
SLICE_PROTOCOLS = [("ra", "ra_normalized"), ("ra", "substitution"),
                   ("aayg", "ra_normalized"), ("cfl", "ra_normalized"),
                   ("ideal_cfl", "ra_normalized")]
# Phase 7 (slice 4): (label, protocol, mode, make_scenario keywords, local
# optimizer).  "schedule" stands for a (3, 10) participation schedule and
# per-client epochs in {1, 2}.
CODEC_ROWS = [
    ("ra+topk0.25", "ra", "ra_normalized",
     dict(codec="topk", compress_ratio=0.25), None),
    ("ra/sub+quant0.25", "ra", "substitution",
     dict(codec="quant", compress_ratio=0.25), None),   # 8-bit values
    ("aayg+topk0.5", "aayg", "ra_normalized",
     dict(codec="topk", compress_ratio=0.5), None),
    ("cfl+quant0.5", "cfl", "ra_normalized",
     dict(codec="quant", compress_ratio=0.5), None),
    ("ra+schedule+epochs", "ra", "ra_normalized", "schedule", None),
    ("ra+loss0.5", "ra", "ra_normalized",
     dict(sampling_policy="loss", select_frac=0.5, codec="none"), None),
    ("ra+budget0.5+topk0.5", "ra", "ra_normalized",
     dict(sampling_policy="budget", select_frac=0.5, codec="topk",
          compress_ratio=0.5), None),
    ("ra+adamw", "ra", "ra_normalized", {}, "adamw"),
]
# Phase 16 (the scenario-grid engine): Fig. 9's relay counts, the Markov
# churn of the dynamic sub-grid, K1's launches over the three sub-grids
# (grid12: 3 groups x 3 rounds; relays: 3, ideal C-FL launches none;
# dynamic: 3, through the transmit-mask variant), and the limit on a batched
# row's per-client train loss against the same scenario run alone (sums
# taken in another order by the grouped convolutions over 3 rounds).
GRID_RELAYS = (0, 7, 14, 28)
GRID_P_DROP = 0.3
GRID_K1_LAUNCHES = 15
GRID_LOSS_TOL = 1e-4
# Phase 17 (the serving tier): the servers' batch cap (one bucket of it),
# their coalescing window, and the bound of every wait on a future.
SERVE_TIER_BATCH = 4
SERVE_TIER_DELAY_S = 0.05
SERVE_TIER_WAIT_S = 600.0
# Phase 18 (the paper's tasks): (label, `smallnets` model, its keywords,
# dataset, the dataset's keywords, full-batch GD learning rate,
# (parameters, segments of 1024) at full width).  The reference's ResNets
# have no normalization layers: ResNet-56's loss at init is in the tens of
# thousands (R&A's round-1 loss reads ~1,600 at 1e-6), and GD diverges
# above a step of about 1e-6; each rate keeps R&A's and AaYG's losses
# finite and falling, the CharRNN's at benchmarks/fig_nwp.py's 0.5.
PAPER_TASKS = [
    ("cifar10-resnet18", "resnet", dict(depth=18, width=16, n_classes=10),
     "image", dict(n_classes=10), 0.005, (174_138, 171)),
    ("cifar100-resnet56", "resnet", dict(depth=56, width=16, n_classes=100),
     "image", dict(n_classes=100), 1e-6, (857_364, 838)),
    ("shakespeare-iid-charrnn", "charrnn", {}, "char", dict(iid=True), 0.5,
     (820_522, 802)),
    ("shakespeare-noniid-charrnn", "charrnn", {}, "char", dict(iid=False),
     0.5, (820_522, 802)),
]
PAPER_PROTOCOLS = [("ra", "ra_normalized"), ("aayg", "ra_normalized"),
                   ("cfl", "ra_normalized")]
# Image samples a client (drawn in [n/2, 3n/2), paper ~5,000): the local
# gradient is one full batch vmapped over the 10 clients, so every client's
# activations sit on the card at once; ResNet-56 peaks near 58 GiB at 1,000
# (29 GiB at 500), so 5,000 would need ~290 GiB.
PAPER_IMAGE_SAMPLES = 1000
PAPER_REDUCED = {"resnet": dict(depth=8, width=4),
                 "charrnn": dict(hidden=32)}
NWP_PROTOCOLS = [("ra", "ra_normalized"), ("cfl", "ra_normalized"),
                 ("none", "ra_normalized")]
# Phase 19 (training): steps of the full-width qwen2.5-3b run; how far its
# first loss may sit from ln V + d_model * 0.02**2 / 2 (a random-init tied
# logit's variance is d_model * 0.02**2 at unit-rms hidden states, so the
# log-sum-exp over V sits that / 2 above ln V); its AdamW rate.  Without
# warm-up AdamW overshoots at full width by the third step at 3e-4 (and
# at `launch.train`'s default 3e-3), with float32 parameters as with
# bf16: `train_witness` holds the bf16 run to a float32 twin at
# TRAIN_TWIN_LR, where bf16 moves most weights, each step's loss within
# TRAIN_TWIN_TOL (read 0.059, PERF.md section 6).  The run of record
# trains at 3e-5, where the loss falls; there `(p32 - lr * delta)` rounds
# back to most bf16 weights unchanged (about a third move; the reference
# casts the same way), so its float32 twin, where every weight moves, must
# fall too.
TRAIN_FULL_STEPS = 3
TRAIN_START_TOL = 0.1
TRAIN_FULL_LR = 3e-5
TRAIN_TWIN_LR = 3e-4
TRAIN_TWIN_TOL = 0.15
# Phase 20 (the dense zoo): the other dense configs, served at full width
# and depth with SERVE_SHAPE.
DENSE_ZOO = ("llama3-8b", "starcoder2-3b", "gemma-7b")
# Phase 21 (the window): (a) llama3-8b's prefill and decode under a window
# of 512; (b) a wrapped cache of 128 slots decoding 2 x 128 + 32 steps from
# empty, in float32 (bf16 roundings that differ with the slots' order would
# flip and grow over 32 layers, as `serve_vs_plain` explains), against the
# unwrapped windowed decode; (c) one step at long_500k's last position;
# (d) `train_step` under the three training attentions on llama3-8b at
# full width and 4 layers (the full depth's state is ~90 GB: bf16 weights
# and gradients, float32 AdamW moments), 8 x 512 tokens, chunks of 128, so
# that the chunked and flash scans run 4 key blocks.
WINDOW = 512
WRAP_WINDOW = 128
WRAP_STEPS = 2 * WRAP_WINDOW + 32
TRAIN_ATTN_DEPTH = 4
TRAIN_ATTN_TOKENS = (8, 512)
TRAIN_ATTN_CHUNK = 128
# Phase 22 (the MoE and hybrid families): the two served (SERVE_SHAPE) and
# trained (TRAIN_FULL_STEPS of 8 x 128 tokens at TRAIN_FULL_LR) at full
# width and depth; dbrx-132b (~262 GB of bf16 weights, over the card's
# 80 GB) only as its float32 smoke variant, card against the CPU, beside
# the other two's; phase 18's NWP grid with each family's sim model as the
# clients, for MOE_HYBRID_NWP_ROUNDS rounds (K1 once a round, B = 2).
MOE_HYBRID = ("granite-moe-1b-a400m", "hymba-1.5b")
MOE_HYBRID_SMOKE = ("granite-moe-1b-a400m", "hymba-1.5b", "dbrx-132b")
MOE_HYBRID_NWP = ("nwp:granite_moe_1b_a400m", "nwp:hymba_1_5b")
MOE_HYBRID_NWP_ROUNDS = 3
# `profile_serve`'s split of the MoE and SSM time: (module, function,
# the `record_function` range it runs in), as `_ranged_parts` takes them.
_MOE, _SSM = "repro_torch.models.moe", "repro_torch.models.ssm"
PROFILE_PARTS = {
    "moe": ((_MOE, "moe_layer", "moe:layer"), (_MOE, "route", "moe:route"),
            (_MOE, "dispatch", "moe:dispatch"),
            (_MOE, "experts", "moe:experts"),
            (_MOE, "combine", "moe:combine")),
    "hybrid": ((_SSM, "ssm_seq", "ssm:seq"), (_SSM, "ssm_step", "ssm:step"),
               (_SSM, "_ssm_terms", "ssm:terms"),
               (_SSM, "ssm_scan", "ssm:scan")),
    # The cross-attention: the prefill's key / value projections and
    # attention (`_sdpa` with its own projections), a decode step's.
    **dict.fromkeys(("enc_dec", "vlm"), (
        ("repro_torch.models.layers", "cross_kv", "xattn"),
        ("repro_torch.models.layers", "cross_attention", "xattn"),
        ("repro_torch.models.transformer", "_decode_xattn", "xattn"))),
}
GEMM_KERNELS = r"gemm|xmma|cutlass|sm90_|nvjet"   # cuBLAS's kernel names
# Phase 23 (the enc-dec and VLM families): whisper-base served at full width
# and depth (1,500 encoder frames, 8 prompts of 416 tokens + 32 generated:
# 448, the Whisper decoder's text context) and trained (TRAIN_FULL_STEPS
# of 8 x 128 tokens); llama-3.2-vision-90b served at full width and
# VLM_LAYERS of its 100 layers (2 groups of 4 self layers + 1 cross layer:
# 19.2 GB of bf16 weights, the whole model's 173 GB being over the card),
# at SERVE_SHAPE.  Every cross block's gate is drawn as zero, which hides
# the cross path (and whisper's encoder) from the logits: every comparison
# of two paths first sets the gates from GATE_SEED (`set_gates`).
MODAL_SERVE = ("whisper-base", "llama-3.2-vision-90b")
WHISPER_SHAPE = dict(batch=8, prompt_len=416, gen=32)
VLM_LAYERS = 10
GATE_SEED = 23
# Phase 25 (the dry run): the one combination run on the CPU beside the
# card phases, its time limit, the SM count of the H100 SXM the roofline
# constants describe (the PCIe card has 114), and the whole-step readings
# phases 13 and 19 leave for it: name -> (config, tokens, seconds).
DRYRUN_ARGS = ("--arch", "qwen2.5-3b", "--shape", "prefill_32k")
DRYRUN_TIMEOUT_S = 900
H100_SXM_SMS = 132
WHOLE_STEP: dict = {}
CODEC_SCHEDULE = (np.random.default_rng(0).random((3, 10)) < 0.7).astype(
    np.float32)
CODEC_EPOCHS = np.array([1, 2] * 5, np.int32)


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

    # Slice 4: the codecs (round_step, the same quantizer uniforms) and
    # the loss policy (advance_chunk: round_step refuses a closed loop).
    for protocol, mode, kw in (
            ("ra", "ra_normalized", dict(codec="topk", compress_ratio=0.3)),
            ("ra", "substitution", dict(codec="quant", compress_ratio=0.25)),
            ("ra", "ra_normalized", dict(sampling_policy="loss",
                                         select_frac=0.5))):
        cfg = simulator.SimConfig(protocol=protocol, mode=mode, seg_len=256,
                                  local_epochs=3, n_rounds=2)
        sims = [simulator.build_sim(
            mlp, smallnets.apply_mlp_clf, data, seg_len=cfg.seg_len,
            local_epochs=cfg.local_epochs, n_rounds=cfg.n_rounds, device=d)
            for d in devices]
        sc = simulator.make_scenario(net, cfg, **kw)
        closed = sc.policy_id is not None
        params0 = mlp(torch.Generator().manual_seed(0))
        states = [sim.init_scan(sc) if closed else
                  {"params": {k: v[None].expand((10,) + tuple(v.shape))
                              for k, v in params0.items()}} for sim in sims]
        n_seg = sims[0].n_segments
        for _ in range(cfg.n_rounds):
            u = torch.from_numpy(rng.random((10, 10, n_seg),
                                            dtype=np.float32))
            uc = torch.from_numpy(rng.random((10, n_seg, cfg.seg_len),
                                             dtype=np.float32))
            outs = []
            for i, sim in enumerate(sims):
                if closed:
                    states[i], m = sim.advance_chunk(states[i], sc, u=[u],
                                                     u_codec=[uc])
                else:
                    states[i], m = sim.round_step(states[i], sc, u=u,
                                                  u_codec=uc)
                outs.append({k: v.cpu() for k, v in m.items()})
            if closed:
                gap = float((states[1]["w"].cpu()
                             - states[0]["w"]).abs().max())
                check(torch.equal(outs[0]["selected"], outs[1]["selected"]),
                      f"loss policy: {devices[1]} selected "
                      f"{outs[1]['selected'].tolist()}, {devices[0]} "
                      f"{outs[0]['selected'].tolist()}")
            else:
                gap = max(float((states[1]["params"][k].cpu()
                                 - states[0]["params"][k]).abs().max())
                          for k in params0)
            loss_gap = float((outs[1]["loss"] - outs[0]["loss"]).abs().max())
            check(gap <= 1e-4 and loss_gap <= 1e-4,
                  f"{protocol}/{mode} {kw}: gap {gap:.2e} / {loss_gap:.2e}")
        print(f"[reference] {protocol}/{mode} {kw}: {devices[1]} == "
              f"{devices[0]} plain path after {cfg.n_rounds} rounds (param "
              f"gap {gap:.2e}, loss gap {loss_gap:.2e}; tol 1e-4)")


def slice_inputs(samples_per_client=600, hw=(28, 28), cnn_kwargs=None):
    """The slice's data, network, model init and base configuration."""
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

    return data, net, init, base


def slice_setup(dev, *, samples_per_client=600, hw=(28, 28),
                cnn_kwargs=None):
    """The slice's simulator and scenarios (phase 5)."""
    from repro_torch.fl import simulator
    from repro_torch.models import smallnets

    data, net, init, base = slice_inputs(samples_per_client, hw, cnn_kwargs)
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


def _profiled(fn, ranges=(), keep=False):
    """(wall ms, CUDA kernel events) of one call of ``fn`` under
    torch.profiler, ending in a device sync.  Kernel events only: CPU-side
    aten ops also report the device time of the kernels they launched, and
    each `record_function` range (``ranges``, the program's ``dfl:``
    spans) has a device-side copy that spans its kernels; both are left
    out.  With ``ranges`` (names of `record_function` ranges opened inside
    ``fn``) it also returns {name: device us of the kernels launched in
    that range}; a name ending in ``*`` sums every CPU event whose name
    starts with the rest (none of which may nest in another).  With
    ``keep`` the profiler comes last."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()

    def matches(key, name):
        return (key.startswith(name[:-1]) if name.endswith("*")
                else key == name)

    def annotation(ev):
        return (getattr(ev, "is_user_annotation", False)
                or ev.key.startswith("dfl:")
                or any(matches(ev.key, name) for name in ranges))

    kernels = [ev for ev in averages
               if ev.device_type.name == "CUDA"
               and ev.self_device_time_total > 0 and not annotation(ev)]
    if not ranges:
        return wall_ms, kernels
    spans = {name: sum(ev.device_time_total for ev in averages
                       if matches(ev.key, name)
                       and ev.device_type.name == "CPU")
             for name in ranges}
    return (wall_ms, kernels, spans, prof) if keep else (wall_ms, kernels,
                                                         spans)


@contextlib.contextmanager
def _ranged_parts(parts):
    """Inside: each function named by ``parts``, triples (module name,
    function name, label), runs in a `record_function` range ``label``
    (for callers that look it up in its module).  Yields the labels."""
    import importlib

    from torch.profiler import record_function

    saved = []
    for mod_name, fn_name, label in parts:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, fn_name)

        def ranged(*args, _orig=orig, _label=label, **kwargs):
            with record_function(_label):
                return _orig(*args, **kwargs)

        saved.append((mod, fn_name, orig))
        setattr(mod, fn_name, ranged)
    try:
        yield tuple(label for _, _, label in parts)
    finally:
        for mod, fn_name, orig in reversed(saved):
            setattr(mod, fn_name, orig)


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


def slice_codec(dev, sync, **inputs):
    """Phase 7: `CODEC_ROWS` at the slice's width (``inputs`` go to
    `slice_inputs`, for a smaller rehearsal); returns (K1 launches, K1
    launches through the transmit-mask variant, the quantizing R&A row's
    simulator and scenario for the profile)."""
    from repro_torch.core import protocols
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra
    from repro_torch.models import smallnets

    data, net, init, base = slice_inputs(**inputs)
    sims = {opt: simulator.build_sim(
        init, smallnets.apply_cnn, data, seg_len=base.seg_len,
        local_epochs=base.local_epochs, n_rounds=base.n_rounds,
        aayg_mixes=base.aayg_mixes, local_optimizer=opt, device=dev)
        for opt in (None, "adamw")}
    rows = []
    for label, protocol, mode, kw, opt in CODEC_ROWS:
        if kw == "schedule":
            kw = dict(participation=CODEC_SCHEDULE, local_epochs=CODEC_EPOCHS)
        cfg = dataclasses.replace(base, protocol=protocol, mode=mode)
        rows.append((label, sims[opt],
                     simulator.make_scenario(net, cfg, **kw).prepare()))
    # Warm-up (cuDNN plans, allocator): one round on each simulator.
    for label, sim, sc in (rows[0], rows[-1]):
        sim.advance_chunk(sim.init_scan(sc), sc)
    sync()

    ops.LAUNCHES["ra_aggregate"] = 0
    for name in _ra.VARIANT_LAUNCHES:
        _ra.VARIANT_LAUNCHES[name] = 0
    results = []
    for label, sim, sc in rows:
        state = sim.init_scan(sc)
        sync()
        out, secs = [], []
        for _ in range(sim.n_chunks):
            t0 = time.perf_counter()
            state, m = sim.advance_chunk(state, sc)
            sync()
            secs.append(time.perf_counter() - t0)
            out.append({k: v.cpu() for k, v in m.items()})
        results.append((label, sim, sc, out, secs))
    launches = ops.LAUNCHES["ra_aggregate"]
    tx_launches = _ra.VARIANT_LAUNCHES["tx"]

    expected = expected_tx = 0
    for label, sim, sc, out, secs in results:
        per_round = {protocols.PROTOCOL_IDS["ra"]: 1,
                     protocols.PROTOCOL_IDS["aayg"]: base.aayg_mixes}.get(
                         sc.protocol_id, 0)
        expected += per_round * base.n_rounds
        if sc.codec_id is not None:
            expected_tx += per_round * base.n_rounds
        acc = torch.stack([r["acc"] for r in out])
        loss = torch.stack([r["loss"] for r in out])
        bias = torch.cat([r["bias"] for r in out])
        check(tuple(acc.shape) == (base.n_rounds, 10)
              and bool(torch.isfinite(acc).all()
                       and torch.isfinite(loss).all()),
              f"{label}: metric shapes {tuple(acc.shape)} or non-finite "
              f"accuracy / loss")
        if sc.protocol_id == protocols.PROTOCOL_IDS["ra"]:
            check(bool(torch.isfinite(bias).all()), f"{label}: non-finite "
                  f"bias {bias.tolist()}")
        sel = ""
        if sc.policy_id is not None:
            chosen = torch.cat([r["selected"] for r in out])
            want = math.ceil(sc.select_frac * 10 - 1e-6)
            check(tuple(chosen.shape) == (base.n_rounds, 10)
                  and bool((chosen.sum(1) == want).all()),
                  f"{label}: selected {chosen.tolist()}, {want} a round "
                  f"expected")
            sel = f" selected/round {[int(c) for c in chosen.sum(1)]}"
        print(f"[slice-codec] {label:21s} acc/round "
              f"{[round(float(a), 4) for a in acc.mean(1)]} loss/round "
              f"{[round(float(x), 4) for x in loss.mean(1)]} bias "
              f"{[round(float(b), 5) for b in bias]}{sel} s/round "
              f"{[round(x, 4) for x in secs]}")
    check(launches == expected and tx_launches == expected_tx,
          f"ra_aggregate launched {launches} times ({tx_launches} through "
          f"the transmit-mask variant) on slice 4's path, expected "
          f"{expected} ({expected_tx})")
    print(f"[slice-codec] ra_aggregate launches on the main path: {launches}"
          f" (expected {expected}), {tx_launches} through the transmit-mask"
          f" variant (expected {expected_tx})")
    quant = next((sim, sc) for label, sim, sc, _o, _s in results
                 if label == "ra/sub+quant0.25")
    return launches, tx_launches, quant


def profile_codec_round(sim, scenario):
    """Phase 7, last: one R&A round under the quantizer, profiled, with the
    codec and the exchange in named ranges."""
    state = sim.init_scan(scenario)
    with _ranged_parts(
            (("repro_torch.core.compression", "encode", "slice-codec:encode"),
             ("repro_torch.core.protocols", "dispatch_round_seg",
              "slice-codec:exchange"))) as ranges:
        wall_ms, events, spans = _profiled(
            lambda: sim.advance_chunk(state, scenario), ranges=ranges)
    dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    k1 = [ev for ev in events if re.search(r"ra_(reg|smem)_kernel", ev.key)]
    k1_us = sum(ev.self_device_time_total for ev in k1)
    codec_ms = spans["slice-codec:encode"] / 1e3
    exch_ms = spans["slice-codec:exchange"] / 1e3
    if dev_ms <= 0 or codec_ms <= 0:
        print(f"[slice-codec] profiled ra+quant round: wall {wall_ms:.2f} ms,"
              f" device split not measured (device kernels {dev_ms:.3f} ms,"
              f" codec range {codec_ms:.3f} ms)")
        return
    print(f"[slice-codec] profiled ra/substitution+quant0.25 round: wall "
          f"{wall_ms:.2f} ms, device kernels {dev_ms:.3f} ms: codec "
          f"{codec_ms:.3f} ms ({100 * codec_ms / dev_ms:.2f}%), exchange "
          f"{exch_ms:.3f} ms of which K1 {k1_us:.1f} us in "
          f"{sum(ev.count for ev in k1)} launch(es), local training and "
          f"metrics {dev_ms - codec_ms - exch_ms:.3f} ms")
    for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:8]:
        print(f"[slice-codec]   {ev.self_device_time_total / 1e3:9.3f} ms "
              f"x{ev.count:<5d} {ev.key[:100]}")


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
    """Phase 8: K3 against its plain version, with times and bounds."""
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
    instructions in the built library's SASS.  Each Hopper instantiation
    (bf16 at D = 64, 128, 256) must hold HGMMA, UTMALDG and UTMASTG and fit
    a block's 227 KB; no D = 256 instantiation may spill."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    if log is None:
        print("[build] flash_attention was built before this run: no ptxas "
              "report")
    report = _ptxas_report(log, _k2_instance)
    for name, regs, smem, st, ld, frame in report:
        print(f"[build] flash_attention {name}: {regs} registers, {smem} B "
              f"static shared memory, spill stores/loads {st}/{ld} B, stack "
              f"frame {frame} B")
    spilled = [row for row in report if row[0].endswith(", 256>") and row[3]]
    check(not spilled, f"K2's D = 256 instantiations spill: {spilled}")
    check(log is None or any(r[0] == "hopper<bf16, 256>" for r in report),
          "K2's hopper<bf16, 256> is missing from the ptxas report")
    lib = ops.load_library("flash_attention")
    print("[build] flash_attention dynamic shared memory per launch: " + ", ".join(
        f"{str(dt)[6:]} D={d} {fa.smem_bytes(lib, dt, d)} B"
        for dt in (torch.float32, torch.bfloat16) for d in fa.HEAD_DIMS))
    smem256 = fa.smem_bytes(lib, torch.bfloat16, 256)
    print(f"[build] flash_attention hopper<bf16, 256>: key tile "
          f"{fa.key_tile(torch.bfloat16, 256)}, {smem256} B dynamic shared "
          f"memory of {SMEM_PER_BLOCK} a block may take")
    check(0 < smem256 <= SMEM_PER_BLOCK,
          f"hopper<bf16, 256> takes {smem256} B of shared memory")
    print("[build] flash_attention first body, blocks an SM: " + ", ".join(
        f"{str(dt)[6:]} D={d} {fa.simt_blocks_per_sm(lib, dt, d)}"
        for dt in (torch.float32, torch.bfloat16) for d in fa.HEAD_DIMS
        if fa.body(dt, d) == "simt"))
    check(fa.simt_blocks_per_sm(lib, torch.bfloat16, 256) == 0,
          "the first body still serves bf16 at D = 256")
    counts = _sass_counts(so_path, _k2_instance,
                          ("HGMMA", "UTMALDG", "UTMASTG", "HMMA"))
    if counts is None:
        print("[build] flash_attention SASS: cuobjdump not found; HGMMA / "
              "UTMALDG counts not measured")
        return
    for inst, c in counts.items():
        print(f"[build] flash_attention {inst} SASS: " + ", ".join(
            f"{op} {n}" for op, n in c.items()))
    for d in (64, 128, 256):
        wg = counts.get(f"hopper<bf16, {d}>", {})
        check(all(wg.get(op, 0) > 0 for op in ("HGMMA", "UTMALDG", "UTMASTG")),
              f"the bf16 D = {d} body lacks wgmma or TMA in its SASS: {wg}")


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


def k2_inputs(shape, dtype, dev, *, kind="randn", causal=True, seed=0,
              window=None):
    """q (B, S, H, D), k and v (B, S, KV, D) for K2, drawn N(0, 1) in float32
    with numpy from ``seed`` and cast to ``dtype``, and the scale.  By kind:

      randn     scale D^-0.5: the logits are about N(0, 1), so no row's max
                ever jumps far at a later key tile;
      growth    as randn, but every 16th key from key 128 on is c q_i for a
                query row i of one head of its group (a row of a later query
                tile if causal, and under ``window`` one that sees the key),
                c rising from 1.5 to 3 along S: row i's logit there is about
                c sqrt(D), far above the about 3 that the randn keys give it;
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
                    hi = s if window is None else min(s, j + window)
                    if lo >= s:
                        break
                    if lo >= hi:
                        continue
                    i = rng.integers(lo, hi)
                    hq = kvh * (h // kv) + rng.integers(h // kv)
                    k[bi, j, kvh] = (1.5 + 1.5 * j / s) * q[bi, i, hq]
    if kind in ("growth", "scale1"):
        v *= 0.5
    return [torch.from_numpy(t).to(dev, dtype) for t in (q, k, v)] + [scale]


def k2_lazy_redos(q, k, scale, causal, margin=0.5, window=None):
    """How many (16-row warp, key tile) pairs the Hopper body's lazy softmax
    must redo exactly on these inputs, replaying its rule on the float32
    logits over its 128-row work tiles and its key tiles
    (`flash_attention.key_tile`: 128 keys, 80 at D = 256): a work tile's
    first key tile (the first its ``window`` reaches, 0 without one) is
    exact; after it, a tile with no masked entry (no key past the work
    tile's first row under the causal mask, not ragged, not crossed by the
    window's left edge, and not the tile where the last row's window
    starts) is redone by a warp where some row's max, in the log2 domain,
    is above the running max by more than 8; the running max takes the
    tile's max only on an exact tile.  Counts the pairs where that excess
    is above 8 + ``margin``, clear of summation-order differences.  Zero
    for a negative scale (no lazy tile) and where the first body serves
    (no lazy softmax)."""
    from repro_torch.kernels import flash_attention as fa

    b, s, h, d = q.shape
    if scale <= 0 or fa.body(q.dtype, d) != "wgmma":
        return 0
    qtile, ktile = fa.BLOCK["wgmma"][0], fa.key_tile(q.dtype, d)
    warp, lazy_log2 = 16, 8.0        # rows a warp, kLazyLog2
    w = 2**31 - 1 if window is None else window
    kf = k.float().repeat_interleave(h // k.shape[2], dim=2)
    x = torch.einsum("bihd,bjhd->bhij", q.float(), kf)
    x = x * (scale * math.log2(math.e))
    idx = torch.arange(s, device=q.device)
    q0 = idx // qtile * qtile            # each row's work tile's first row
    j0 = (q0 - w + 1).clamp_min(0) // ktile
    imax = (q0 + qtile - 1).clamp_max(s - 1)
    if causal:
        x = x.masked_fill(idx[None, :] > idx[:, None], -math.inf)
    x = x.masked_fill(idx[:, None] - idx[None, :] >= w, -math.inf)

    def any_in_warp(rows):       # (..., S) -> (..., warps)
        rows = torch.nn.functional.pad(rows, (0, -s % warp))
        return rows.unflatten(-1, (-1, warp)).any(-1)

    m = torch.full(x.shape[:-1], -math.inf, device=q.device)
    redos = 0
    for j in range(-(-s // ktile)):
        tmax = x[..., ktile * j:ktile * (j + 1)].amax(-1)
        seen = (j >= j0) & ((imax // ktile >= j) if causal else True)
        reach = imax - ktile * j
        edge = ((causal & (ktile * (j + 1) - 1 > q0)) | (ktile * (j + 1) > s)
                | (reach >= w) | ((reach == w - 1) & (j > j0)) | (j == j0))
        excess = torch.where(seen & ~edge, tmax - m, -math.inf)
        redos += int(any_in_warp(excess > lazy_log2 + margin).sum())
        redo = any_in_warp(excess > lazy_log2).repeat_interleave(warp, -1)
        exact = (seen & edge) | redo[..., :s]
        m = torch.where(exact, torch.maximum(m, tmax), m)
    return redos


def k2_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the causal and window masks keep: row i sees
    min(i + 1, W) keys causally, and S - max(0, i - W + 1) in full."""
    w = s if window is None else min(window, s)
    if causal:
        return w * (w + 1) // 2 + (s - w) * w
    return s * s - (s - w) * (s - w + 1) // 2


def k2_window_mask(s: int, causal: bool, window: int, dev) -> torch.Tensor:
    """SDPA's boolean mask (True = attend) for the causal and window mask."""
    idx = torch.arange(s, device=dev)
    mask = idx[:, None] - idx[None, :] < window
    return mask & (idx[:, None] >= idx[None, :]) if causal else mask


def k2_row_err(got, want):
    """The largest error of any output row against that row's own size:
    max |got - want| over the row / the row's root mean square."""
    want = want.float()
    diff = (got.float() - want).abs().amax(-1)
    return float((diff / want.pow(2).mean(-1).sqrt().clamp_min(1e-30)).max())


def k2_checks(dev, timer):
    """Phase 12: K2 against its plain version, with times and bounds."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for seed, (name, shape, dtype, causal, kind, window) in enumerate(
            K2_CASES):
        b, s, h, kv, d = shape
        q, k, v, scale = k2_inputs(shape, dtype, dev, kind=kind,
                                   causal=causal, seed=seed, window=window)

        def kernel(window=window):
            return ops.flash_attention(q, k, v, scale=scale, causal=causal,
                                       window=window)

        def plain():
            return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                           window=window)

        launches_before = ops.LAUNCHES["flash_attention"]
        got, want = kernel().float(), plain().float()
        err = float((got - want).abs().max())
        row_err = k2_row_err(got, want)
        redos = k2_lazy_redos(q, k, scale, causal, window=window)
        tol, row_tol = K2_TOL[dtype], K2_ROW_TOL[dtype]
        # A window of S or more masks nothing: the kernel must give what it
        # gives with no window, bit for bit.
        same = (bool(torch.equal(got, kernel(None).float()))
                if window is not None and window >= s else None)
        row = dict(case=name, shape=shape, dtype=str(dtype)[6:],
                   causal=causal, window=window, err=err, row_err=row_err,
                   redos=redos, body=fa.body(dtype, d),
                   ok=(err <= tol and row_err <= row_tol and same is not False
                       and (redos > 0 or kind not in ("growth", "scale1"))))
        # Bytes: q, k, v read once and out written once.  Operations: the
        # QK^T and PV products over the (query, key) pairs the causal and
        # window masks keep, 2 x 2 D each, at the peak rate of the inputs'
        # type.
        bytes_moved = 2 * (q.numel() + k.numel()) * q.element_size()
        pairs = k2_pairs(s, causal, window)
        flops = 4 * b * h * d * pairs
        t_bytes = bytes_moved / HBM_BYTES_PER_S
        t_ops = flops / (BF16_FLOP_PER_S if dtype == torch.bfloat16
                         else F32_FLOP_PER_S)
        row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
        row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        timing = "" if same is None else f" | bit-equal to no window: {same}"
        if name in K2_TIMED:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            mask = (None if window is None else
                    k2_window_mask(s, causal, window, dev))

            def library():
                if mask is None:
                    return F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, scale=scale,
                        enable_gqa=True)
                return F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, scale=scale, enable_gqa=True)

            lib_err = float((library().transpose(1, 2).float() - want)
                            .abs().max())
            check(lib_err <= tol, f"SDPA yardstick disagrees: {lib_err:.3e}")
            for tag, cold in (("cold", True), ("warm", False)):
                row[f"ms_{tag}"] = timer(kernel, cold)
                row[f"plain_ms_{tag}"] = timer(plain, cold, reps=5)
                row[f"library_ms_{tag}"] = timer(library, cold)
            timing += (f" | kernel {row['ms_cold'] * 1e3:.1f}/"
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
              f"window {window} "
              f"scale {scale:.4g} max_abs_err={err:.3e} (tol {tol:g}) "
              f"row_err={row_err:.3e} (tol {row_tol:g}) lazy redos {redos} "
              f"{'ok' if row['ok'] else 'FAIL'}{timing}")
    bad = [r for r in rows if not r["ok"]]
    check(not bad, f"K2 disagrees with its plain version: {bad}")
    return rows


def k2_per_prefill(cfg) -> dict:
    """K2's launches in one prefill of ``cfg``, by mask: one a decoder
    self-attention layer causal, one an encoder layer full (enc_dec); the
    vlm's cross blocks run the plain attention."""
    from repro_torch.models import transformer as T

    if cfg.family == "enc_dec":
        return {"causal": cfg.n_layers, "full": cfg.n_enc_layers}
    if cfg.family == "vlm":
        g, ns = T.vlm_groups(cfg)
        return {"causal": g * ns, "full": 0}
    return {"causal": cfg.n_layers, "full": 0}


def set_gates(params, seed=GATE_SEED) -> list:
    """Set every cross block's ``gate`` leaf (drawn as zero, so that the
    cross path, and for enc_dec the encoder, would not reach the logits)
    to a uniform draw in [0.5, 1.0] from numpy ``seed``, in place.
    Returns the values set, by leaf."""
    rng = np.random.default_rng(seed)
    out = []
    for name, leaf in params.items():
        if name.split(".")[-1] == "gate":
            vals = rng.uniform(0.5, 1.0, size=tuple(leaf.shape))
            leaf.copy_(torch.from_numpy(vals))
            out.append((name, [round(float(v), 4) for v in
                               leaf.float().flatten().tolist()]))
    return out


# K2's launches by mask on each served path, by "tag:model" (`serve_full`).
K2_SERVED_MASKS: dict[str, dict] = {}


def serve_full(dev, tag, arch=None, window=None, cfg=None, shape=None):
    """Phase 9 / 13 / 20 / 21 / 22 / 23: a serving path at full width
    through `launch.serve.serve` (``arch``, default the tag's in
    `SERVE_PATHS`, or the config ``cfg``, under ``window``, at ``shape``,
    default `SERVE_SHAPE`); its kernel's launches are counted per phase (K2's
    also by mask).  A modal family's weights are drawn from the served
    seed as `serve` draws them, with every gate set (`set_gates`)."""
    from repro_torch import resolve_device
    from repro_torch.configs import base
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import rwkv6_scan as _rwkv
    from repro_torch.launch import serve
    from repro_torch.models import registry

    if arch is None and cfg is None:
        arch, kernel = SERVE_PATHS[tag]
    else:
        kernel = "flash_attention"
    if cfg is None:
        cfg = base.get(arch)
    shape = SERVE_SHAPE if shape is None else shape
    modal = registry.needs_modal(cfg)
    # Warm-up (cuBLAS handles and plans, the allocator) with a short prompt,
    # before the counted run.
    serve.serve(cfg, batch=shape["batch"], prompt_len=64, gen=2, seed=1,
                window=window)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    params = None
    if modal:
        params = registry.build(cfg).init(
            torch.Generator(resolve_device(dev)).manual_seed(
                serve._seeds(0)[0]), device=dev)
        gates = set_gates(params)
        print(f"[{tag}] {cfg.name}: gates set uniform in [0.5, 1.0] from "
              f"numpy seed {GATE_SEED}: {gates}")
    ops.LAUNCHES[kernel] = 0
    for key in fa.MASK_LAUNCHES:
        fa.MASK_LAUNCHES[key] = 0
    for body in _rwkv.BODIES:
        _rwkv.BODY_LAUNCHES[body] = 0
    res = serve.serve(cfg, **shape, seed=0, window=window, params=params)
    launches = ops.LAUNCHES[kernel]
    masks = dict(fa.MASK_LAUNCHES)
    bodies = dict(_rwkv.BODY_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    del params
    n_params = sum(t.numel() for t in res.params.values())
    b, gen = shape["batch"], shape["gen"]
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
    if cfg.family == "moe":
        heads += (f", {cfg.n_experts} experts top-{cfg.top_k} (capacity "
                  f"factor {cfg.capacity_factor:g}, groups of "
                  f"{cfg.moe_group_size})")
    elif cfg.family == "hybrid":
        heads += (f", SSM d_inner {cfg.ssm_cfg().d_inner} d_state "
                  f"{cfg.d_state}")
    elif cfg.family == "enc_dec":
        heads += (f", {cfg.n_enc_layers} encoder layers over "
                  f"{cfg.enc_seq} frames")
    elif cfg.family == "vlm":
        heads += (f", a cross layer every {cfg.cross_attn_every} over "
                  f"{cfg.n_modal_tokens} patches")
    print(f"[{tag}] {cfg.name}: {n_params} parameters ({cfg.n_layers} layers, "
          f"d {cfg.d_model}, {heads}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.act}, {str(cfg.dtype)[6:]}); batch {b} x prompt "
          f"{shape['prompt_len']} + {gen} generated; window {window}")
    print(f"[{tag}] prefill {res.prefill_s:.4f} s; decode {res.decode_steps} "
          f"steps x batch {b} in {res.decode_s:.4f} s = "
          f"{res.decode_tokens_per_s:.1f} tok/s "
          f"({1e3 * res.decode_s / max(res.decode_steps, 1):.2f} ms a step); "
          f"max_memory_allocated {peak / 2**30:.3f} GiB")
    print(f"[{tag}] ids, row 0: {res.tokens[0].tolist()}")
    pre, dec = res.prefill_launches[kernel], res.decode_launches[kernel]
    expected = (k2_per_prefill(cfg) if kernel == "flash_attention"
                else {"causal": cfg.n_layers, "full": 0})
    n_expected = sum(expected.values())
    print(f"[{tag}] {kernel} launches on the serving path: {pre} in the "
          f"prefill, {dec} in decode, {launches} in all (expected "
          f"{n_expected}, one per self-attention layer of the prefill)")
    check(pre == n_expected and dec == 0 and launches == n_expected,
          f"{kernel} launched {pre} times in the prefill and {dec} in decode, "
          f"expected {n_expected} and 0")
    if kernel == "rwkv6_scan":
        print(f"[{tag}] rwkv6_scan launches by body: {bodies} (expected all "
              f"{cfg.n_layers} through the chunked body)")
        check(bodies == {"token": 0, "chunked": cfg.n_layers},
              f"rwkv6_scan bodies on the serving path: {bodies}")
    else:
        print(f"[{tag}] flash_attention at head dim {cfg.hd} runs the "
              f"{fa.body(cfg.dtype, cfg.hd)} body; launches by mask {masks} "
              f"(expected {expected})")
        check(masks == expected, f"flash_attention by mask: {masks}, "
              f"expected {expected}")
        K2_SERVED_MASKS[f"{tag}:{cfg.name}"] = masks

    serve_vs_plain(cfg, res, tag, kernel, window)
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


class MoeRoutes:
    """`models.moe.route` as `serve_gaps` runs it.  Routing is a top-k: a
    last-bit difference in the router's input can swap a token's k-th
    expert for its (k+1)-th and move the capacity drops behind it, a jump
    no limit on the two paths' gap could hold.  So under ``mode("record")``
    a call routes as usual and keeps its expert choices; under any other
    label a call counts the tokens whose own top-k set differs from the
    kept one (`flips` / `tokens` by label) and routes by the kept choices
    with its own router probabilities (`moe.assign`: the same drops, gates
    from its own input), or with ``own=True`` by its own choices, as
    `moe.route` does."""

    def __init__(self):
        self.label = None
        self.own = False
        self.idx = None
        self.flips = {}
        self.tokens = {}

    @contextlib.contextmanager
    def installed(self):
        from repro_torch.models import moe as M

        orig = M.route

        def route(params, cfg, xt, cap):
            if self.label is None:
                return orig(params, cfg, xt, cap)
            if self.label == "record":
                r = orig(params, cfg, xt, cap)
                self.idx = r.idx
                return r
            probs = M.router_probs(params, xt)
            own = M.top_k(probs, cfg.top_k)
            differ = (own.sort(-1).values
                      != self.idx.sort(-1).values).any(-1)
            self.flips[self.label] = (self.flips.get(self.label, 0)
                                      + int(differ.sum()))
            self.tokens[self.label] = (self.tokens.get(self.label, 0)
                                       + differ.numel())
            return M.assign(probs, own if self.own else self.idx, cap)

        M.route = route
        try:
            yield self
        finally:
            M.route = orig

    @contextlib.contextmanager
    def mode(self, label, own=False):
        self.label, self.own = label, own
        try:
            yield
        finally:
            self.label, self.own = None, False


def serve_gaps(cfg, params, prompt, logits, cache, kernel, window=None,
               modal=None):
    """The serving prefill's precision, from the kernel path's bfloat16
    ``logits`` and ``cache`` (time-mix states, or K/V caches) for
    ``params`` and ``prompt`` (and a modal family's ``modal`` embeddings)
    under ``window``:

      * f32_*: the same weights (widened, exactly) with float32 activations
        at full depth, kernel against impl="torch";
      * layer_*: the bfloat16 model layer by layer from the same input,
        kernel against impl="torch" (worst layer; an encoder layer's output
        is its side stream);
      * bf16_*_kernel / bf16_*_torch: each bfloat16 path's relative L2 gap
        to the float32 impl="torch" run, logits and all layers' caches.

    Gaps named *_max are max |diff| over max |value|.  A "layer" is a step
    of `transformer.units`: an encoder layer, the encoder's norm, a decoder
    layer, a vlm self layer or cross block.  For the moe family
    the paths above route each layer's tokens as the float32 impl="torch"
    run routes them (`MoeRoutes`; ``routes`` counts, per path, the tokens
    whose own choice differs), and a fifth path, the bfloat16 kernel path
    end to end under that routing, stands in for the served ``logits``
    and ``cache`` in bf16_*_kernel.  Two more bfloat16 paths route by
    their own choices, as the served run does: the kernel path, which the
    served run must equal (served_*_max), and impl="torch"; bf16_*_own_*
    are their relative L2 gaps to the float32 run, the served run's
    standing for the kernel's.  The paths run layer by layer side by side, each layer's float32
    weights widened as it comes and every cache compared and dropped at
    once, so that a model
    whose float32 weights and caches would not fit beside its bfloat16 ones
    (gemma-7b: 34 GB and 15 GB a cache set) is held the same way.  The
    launches of ``kernel`` this makes are not counted.
    """
    from repro_torch.kernels import ops
    from repro_torch.models import layers
    from repro_torch.models import transformer as T

    launches = ops.LAUNCHES[kernel]
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    g = {"f32_cache_max": 0.0, "layer_out_max": 0.0, "layer_cache_max": 0.0}
    sq = dict.fromkeys(("cache_kernel", "cache_torch", "cache_own_kernel",
                        "cache_own_torch", "cache_ref"), 0.0)
    moe = cfg.family == "moe"
    if moe:
        g["served_cache_max"] = 0.0
    routes = MoeRoutes()

    def routed(label, own=False):
        return routes.mode(label, own) if moe else contextlib.nullcontext()

    def step(c, kind, lp, stream, impl):
        x, src, kept, _ = T.apply_unit(c, kind, lp, *stream, impl=impl,
                                       window=window)
        return (x, src), kept

    def worst(key, gaps):
        g[key] = max([g[key], *gaps])

    with torch.no_grad(), routes.installed():
        emb = layers.embed(T._sub(params, "embed"), prompt).to(cfg.dtype)
        # Each path's (decoder stream, side stream): the side stream is the
        # modal input (float32 in the float32 run), None for the others.
        f32k = f32t = (emb.float(), T._modal(cfg32, modal, cast=True))
        bt = bk = be = ok = ot = (emb, T._modal(cfg, modal, cast=True))
        del emb
        for kind, lp, at in T.units(params, cfg):
            names = T.cache_names(cfg, kind)
            lp32 = {k: v.float() for k, v in lp.items()}
            with routed("record"):
                f32t, ct32 = step(cfg32, kind, lp32, f32t, "torch")
            with routed("f32 kernel"):
                f32k, ck32 = step(cfg32, kind, lp32, f32k, "kernel")
            del lp32
            worst("f32_cache_max", [_rel_gap(a, b) for a, b in zip(ck32, ct32)])
            del ck32
            with routed("bf16 torch"):
                bt, cbt = step(cfg, kind, lp, bt, "torch")
            served = [T._at(cache[n], at) for n in names]
            if moe:
                with routed("bf16 kernel"):
                    be, cbe = step(cfg, kind, lp, be, "kernel")
                with routed("bf16 kernel own", own=True):
                    ok, cok = step(cfg, kind, lp, ok, "kernel")
                worst("served_cache_max",
                      [_rel_gap(a, b) for a, b in zip(served, cok)])
                with routed("bf16 torch own", own=True):
                    ot, cot = step(cfg, kind, lp, ot, "torch")
                pairs = {"cache_kernel": list(cbe),
                         "cache_own_kernel": served,
                         "cache_own_torch": [c.to(cfg.dtype) for c in cot]}
                del cbe, cok, cot
            else:
                pairs = {"cache_kernel": served}
            pairs["cache_torch"] = [c.to(cfg.dtype) for c in cbt]
            for key, got in pairs.items():
                for a, b in zip(got, ct32):
                    sq[key] += float(torch.linalg.vector_norm(
                        a.float() - b.float())) ** 2
            sq["cache_ref"] += sum(float(torch.linalg.vector_norm(b)) ** 2
                                   for b in ct32)
            del cbt, ct32, pairs
            with routed("bf16 layer kernel"):
                sk, ck = step(cfg, kind, lp, bk, "kernel")
            with routed("bf16 layer torch"):
                st, ct = step(cfg, kind, lp, bk, "torch")
            worst("layer_out_max", [_rel_gap(a, b) for a, b in zip(sk, st)
                                    if b is not None])
            worst("layer_cache_max", [_rel_gap(a, b) for a, b in zip(ck, ct)])
            bk = sk
            del st, ck, ct
        norm = T._norm(cfg)
        final = T._sub(params, "final_norm")
        table = T._sub(params, "embed")
        final32 = {k: v.float() for k, v in final.items()}
        lk32, lt32 = (layers.unembed(table, norm(final32, x[0][:, -1]))
                      for x in (f32k, f32t))
        lt = layers.unembed(table, norm(final, bt[0][:, -1]))
        if moe:
            lok, lot = (layers.unembed(table, norm(final, x[0][:, -1]))
                        for x in (ok, ot))
            g["served_logits_max"] = _rel_gap(logits, lok)
            g["routes"] = {label: (routes.flips[label], routes.tokens[label])
                           for label in routes.flips}
            own = {"own_kernel": logits, "own_torch": lot}
            logits = layers.unembed(table, norm(final, be[0][:, -1]))
    passes = 4 if moe else 2
    per = (sum(k2_per_prefill(cfg).values()) if kernel == "flash_attention"
           else cfg.n_layers)
    check(ops.LAUNCHES[kernel] == launches + passes * per,
          f"the {passes} kernel paths of serve_gaps did not go through the "
          f"kernel once per layer each")
    g["f32_logits_max"] = _rel_gap(lk32, lt32)
    g["f32_same_ids"] = bool(torch.equal(lk32.argmax(-1), lt32.argmax(-1)))
    for name, lg in (("kernel", logits), ("torch", lt),
                     *(own.items() if moe else ())):
        g[f"bf16_logits_{name}"] = _rel_l2([lg], [lt32])
        g[f"bf16_cache_{name}"] = math.sqrt(sq[f"cache_{name}"]
                                            / sq["cache_ref"])
        g[f"bf16_logits_max_{name}"] = _rel_gap(lg, lt32)
    g["bf16_logits_max_kernel_vs_torch"] = _rel_gap(logits, lt)
    ops.LAUNCHES[kernel] = launches
    return g


def serve_vs_plain(cfg, res, tag, kernel, window=None):
    """Phase 9 / 13 / 20 / 21, second half: the serving prefill through the
    kernel against the plain path (impl="torch") on the card, from the same
    weights and prompts, under the same ``window`` (`serve_gaps`).

    The two paths sum in other orders, so their outputs differ in the last
    float32 bits; in bfloat16 that flips the rounding of some activations
    by one ulp, and a deep stack of random layers amplifies such flips, so
    the two bfloat16 paths are not held to each other end to end.  Each is
    held instead to the same weights run with float32 activations: the
    kernel path may be at most SERVE_BF16_RATIO times as far from it as the
    plain path is.  The float32 run and each bfloat16 layer hold the
    kernel to the plain path directly, at limits set from their readings.
    A MoE's served run must equal its kernel path run layer by layer, and
    routed by their own choices it may flip and stray at most
    SERVE_MOE_OWN_RATIO (its logits SERVE_MOE_LOGITS_RATIO) times as much
    as impl="torch" does.
    """
    on_card = res.prompt.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    g = serve_gaps(cfg, res.params, res.prompt, res.prefill_logits,
                   res.prefill_cache, kernel, window, res.modal)
    if on_card:
        print(f"[{tag}] the comparisons below held "
              f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB at their "
              f"peak (the served weights included; each layer's float32 "
              f"copy made as it comes)")
    what = {"ssm": "state", "hybrid": "K/V cache and SSM state",
            "enc_dec": "self and cross K/V cache",
            "vlm": "self and cross K/V cache"}.get(cfg.family, "K/V cache")
    if "routes" in g:
        flips = ", ".join(f"{label} {n} of {t}" for label, (n, t)
                          in g["routes"].items())
        print(f"[{tag}] MoE routing: tokens whose own top-{cfg.top_k} set "
              f"differs from the float32 impl='torch' run's, summed over "
              f"layers: {flips}")
        print(f"[{tag}] MoE, each path by its own routing: the served run vs "
              f"the bf16 kernel path layer by layer, logits gap/max "
              f"{g['served_logits_max']:.3e}, worst layer K/V cache gap/max "
              f"{g['served_cache_max']:.3e} (tol {SERVE_SERVED_TOL:g}); "
              f"relative L2 gap to the float32 run: logits served "
              f"{g['bf16_logits_own_kernel']:.3e} vs impl='torch' "
              f"{g['bf16_logits_own_torch']:.3e}, K/V cache served "
              f"{g['bf16_cache_own_kernel']:.3e} vs impl='torch' "
              f"{g['bf16_cache_own_torch']:.3e} (served at most "
              f"{SERVE_MOE_LOGITS_RATIO:g}x in logits, {SERVE_MOE_OWN_RATIO:g}x "
              f"in cache and in flips); below, every path routes as the "
              f"float32 impl='torch' run does")
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
    if "routes" in g:
        flips = {label: n for label, (n, _) in g["routes"].items()}
        check(g["served_logits_max"] <= SERVE_SERVED_TOL
              and g["served_cache_max"] <= SERVE_SERVED_TOL,
              "MoE: the served prefill differs from the kernel path run "
              "layer by layer")
        check(flips["bf16 kernel own"]
              <= SERVE_MOE_OWN_RATIO * flips["bf16 torch own"]
              and g["bf16_logits_own_kernel"]
              <= SERVE_MOE_LOGITS_RATIO * g["bf16_logits_own_torch"]
              and g["bf16_cache_own_kernel"]
              <= SERVE_MOE_OWN_RATIO * g["bf16_cache_own_torch"],
              "MoE, own routing: the served run routes or lands farther from "
              "the float32 run than impl='torch' allows")


def serve_reference(dev, tag, arch=None):
    """Phase 10 / 14 / 22 (c) / 23 (d): the float32 smoke variant of
    ``arch`` (default the tag's in `SERVE_PATHS`) through
    `launch.serve.serve` (batch 4 x prompt 128 + 16) on the card, its
    kernel once a prefill self-attention layer, and on the CPU's plain
    path from the same weights, prompts (and modal embeddings, the gates
    set): the same greedy ids, and the prefill logits and every cache leaf
    within SMOKE_TOL."""
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import registry
    from repro_torch.models import transformer as T

    if arch is None:
        arch, kernel = SERVE_PATHS[tag]
    else:
        kernel = "flash_attention"
    cfg = base.smoke_variant(base.get(arch))
    params = registry.build(cfg).init(torch.Generator().manual_seed(0),
                                      device="cpu")
    tokens = torch.randint(0, cfg.vocab, (4, 128),
                           generator=torch.Generator().manual_seed(1))
    modal = None
    if registry.needs_modal(cfg):
        set_gates(params)
        modal = torch.randn((4, T.modal_len(cfg), cfg.d_model),
                            generator=torch.Generator().manual_seed(2))
    kw = dict(batch=4, prompt_len=128, gen=16)
    cpu = serve.serve(cfg, **kw, device="cpu", params=params, tokens=tokens,
                      modal=modal)
    before = ops.LAUNCHES[kernel]
    gpu = serve.serve(cfg, **kw, device=dev,
                      params={k: v.to(dev) for k, v in params.items()},
                      tokens=tokens.to(dev),
                      modal=None if modal is None else modal.to(dev))
    per = (sum(k2_per_prefill(cfg).values()) if kernel == "flash_attention"
           else cfg.n_layers)
    check(ops.LAUNCHES[kernel] == before + per,
          f"{arch} smoke: the card's prefill did not launch {kernel} once a "
          f"self-attention layer")
    ops.LAUNCHES[kernel] = before
    wants = {"logits": cpu.prefill_logits, **cpu.prefill_cache}
    gots = {"logits": gpu.prefill_logits, **gpu.prefill_cache}
    worst = {name: float(((gots[name].cpu() - want).abs()
                          - SMOKE_TOL * want.abs()).max())
             for name, want in wants.items()}
    same = bool(torch.equal(gpu.tokens.cpu(), cpu.tokens))
    print(f"[{tag}-reference] {cfg.name} float32 ({cfg.n_layers} layers, d "
          f"{cfg.d_model}), batch 4 x prompt 128 + 16: card ids == CPU "
          f"plain-path ids: {same}; max |gap| - {SMOKE_TOL:g} |CPU| by leaf "
          f"(must be <= {SMOKE_TOL:g}): "
          + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    check(same, f"greedy ids differ: card {gpu.tokens.tolist()} vs CPU "
          f"{cpu.tokens.tolist()}")
    check(all(v <= SMOKE_TOL for v in worst.values()),
          f"{arch} smoke: card vs CPU")


@contextlib.contextmanager
def _k2_masks():
    """Inside: the mask of each `ops.flash_attention` call is kept in call
    order, "causal" or "full" (an encoder's).  Yields that list.  The
    profiler ties no range to K2's ctypes launch, and CUDA events around it
    would also time the card waiting for a host-bound launch, so
    `_k2_us_by_mask` pairs the list with the profiled K2 kernels in time
    order."""
    from repro_torch.kernels import ops

    orig = ops.flash_attention
    masks = []

    def kept(*args, causal=True, **kwargs):
        masks.append("causal" if causal else "full")
        return orig(*args, causal=causal, **kwargs)

    ops.flash_attention = kept
    try:
        yield masks
    finally:
        ops.flash_attention = orig


def _k2_us_by_mask(prof, masks) -> dict | None:
    """K2's device us by mask: the profiled K2 kernels in start order paired
    with ``masks`` (`_k2_masks`); None when their counts differ."""
    kernels = sorted((ev for ev in prof.events()
                      if ev.device_type.name == "CUDA"
                      and "flash_attention" in ev.name),
                     key=lambda ev: ev.time_range.start)
    if len(kernels) != len(masks):
        return None
    out = {"causal": 0.0, "full": 0.0}
    for mask, ev in zip(masks, kernels):
        out[mask] += ev.time_range.elapsed_us()
    return out


def _range_kernel_us(prof, label: str, pattern: str) -> float:
    """Device us of the kernels matching ``pattern`` launched inside the
    ``label`` ranges of ``prof``, from its event tree."""
    def walk(ev):
        return (sum(k.duration for k in ev.kernels
                    if re.search(pattern, k.name, re.I))
                + sum(walk(child) for child in ev.cpu_children))

    return sum(walk(ev) for ev in prof.events() if ev.name == label)


def profile_serve(cfg, res, tag, kernel, window=None):
    """Phase 11 / 15 / 20 / 21 / 22 / 23: one full-width prefill and one
    decode step under torch.profiler (under ``window``); for the moe,
    hybrid and modal families also the device time in each of
    `PROFILE_PARTS`' ranges; for the modal families K2 by mask (an
    encoder's, full; a decoder's, causal), the cross-attention, the GEMMs
    outside it and the rest."""
    from repro_torch.launch import serve
    from repro_torch.models import registry

    bundle = registry.build(cfg)
    s = res.prompt.shape[1]
    token = res.tokens[:, :1].to(res.prompt.device)
    cache = serve.grow_cache(res.prefill_cache, s + 1)
    batch = {"tokens": res.prompt}
    modal = registry.needs_modal(cfg)
    if modal:
        batch["modal_embeds"] = res.modal
    for what, fn in (
            ("prefill", lambda: bundle.prefill_step(
                res.params, batch, window=window)),
            ("decode step", lambda: bundle.serve_step(
                res.params, cache, token, s, window=window))):
        with contextlib.ExitStack() as stack:
            ranges = tuple(dict.fromkeys(stack.enter_context(
                _ranged_parts(PROFILE_PARTS.get(cfg.family, ())))))
            if modal:
                masks = stack.enter_context(_k2_masks())
            out = _profiled(fn, ranges=ranges, keep=modal)
        wall_ms, events = out[:2]
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
        if ranges:
            spans = out[2]
            print(f"[{tag}-profile] {what}: device ms by range (a range holds "
                  f"those nested in it): " + ", ".join(
                      f"{name} {spans[name] / 1e3:.3f} "
                      f"({100 * spans[name] / 1e3 / dev_ms:.1f}%)"
                      for name in ranges))
        if modal:
            modal_split(tag, what, cfg, out[2], out[3],
                        _k2_us_by_mask(out[3], masks), events, dev_ms)
        for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:12]:
            print(f"[{tag}-profile]   {ev.self_device_time_total / 1e3:9.3f} "
                  f"ms x{ev.count:<5d} {ev.key[:100]}")


def modal_split(tag, what, cfg, spans, prof, k2_us, events, dev_ms) -> None:
    """Phase 23's split of a profiled prefill or decode step: K2 by mask
    (``k2_us``, `_k2_us_by_mask`; its sum alone where that is None), the
    cross-attention (its projections included), the GEMMs outside it and
    the rest, in device ms and shares of the device time."""
    gemm_us = sum(ev.self_device_time_total for ev in events
                  if re.search(GEMM_KERNELS, ev.key, re.I)
                  and "flash_attention" not in ev.key)
    in_xattn = _range_kernel_us(prof, "xattn", GEMM_KERNELS)
    k2_all = sum(ev.self_device_time_total for ev in events
                 if "flash_attention" in ev.key)
    parts = ({"k2 (launches and kernels did not pair; by mask not "
              "measured)": k2_all} if k2_us is None else
             {"k2 encoder (full)": k2_us["full"],
              "k2 decoder (causal)": k2_us["causal"]})
    parts.update({"cross-attention": spans["xattn"],
                  "GEMMs outside cross-attention": gemm_us - in_xattn})
    parts["the rest"] = dev_ms * 1e3 - sum(parts.values())
    print(f"[{tag}-profile] {cfg.name} {what} split: " + ", ".join(
        f"{name} {us / 1e3:.3f} ms ({100 * us / 1e3 / dev_ms:.1f}%)"
        for name, us in parts.items())
        + f"; the cross-attention's own GEMMs {in_xattn / 1e3:.3f} ms")


def _reset_k1_counts():
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra

    ops.LAUNCHES["ra_aggregate"] = 0
    for key in _ra.VARIANT_LAUNCHES:
        _ra.VARIANT_LAUNCHES[key] = 0
    _ra.BATCH_LAUNCHES.clear()
    _ra.SHAPE_LAUNCHES.clear()


@contextlib.contextmanager
def _k1_shapes(seen: set):
    """Inside: each K1 launch adds its (B, N, L, K) and dtype to ``seen``."""
    from repro_torch.kernels import ra_aggregate as _ra

    orig = _ra.launch

    def recording(lib, w4, *args, **kwargs):
        seen.add((tuple(w4.shape), w4.dtype))
        return orig(lib, w4, *args, **kwargs)

    _ra.launch = recording
    try:
        yield
    finally:
        _ra.launch = orig


def _k1_counts():
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra

    return ops.LAUNCHES["ra_aggregate"], dict(sorted(
        _ra.BATCH_LAUNCHES.items()))


def grid12_grid():
    """sweep_grid's 12 scenarios: two packet lengths x R&A (both modes) and
    AaYG x two seeds."""
    from repro_torch.core import topology
    from repro_torch.fl import scenarios

    return scenarios.ScenarioGrid.product(
        networks=[(f"pkt{bits}", topology.paper_network(packet_len_bits=bits))
                  for bits in (32768, 400_000)],
        protocols=[("ra", "ra_normalized"), ("ra", "substitution"),
                   ("aayg", "ra_normalized")],
        seeds=[0, 1])


def grid_grids():
    """Phase 16's three sub-grids at the slice's width: (name, grid)."""
    from repro_torch.core import topology
    from repro_torch.fl import scenarios

    grid = scenarios.ScenarioGrid
    table_ii = topology.paper_network(packet_len_bits=32768)
    grid12 = grid12_grid()
    relays = grid.concat(
        grid.product(networks=[("standard", table_ii)],
                     protocols=[("ideal_cfl", "ra_normalized")]),
        grid.product(networks=[
            (f"relays{r}", topology.paper_network_with_relays(
                r, edge_density=0.15, tx_power_dbm=17.0,
                packet_len_bits=32768))
            for r in GRID_RELAYS]))
    dynamic = grid.product(
        schedules=[
            ("markov", topology.markov_link_schedule(
                table_ii, 3, p_drop=GRID_P_DROP, seed=0)),
            ("fading", topology.fading_per_schedule(table_ii, 3, seed=0))],
        participation=[("half", scenarios.sampling_schedule(10, 3, 0.5,
                                                            seed=0))],
        codecs=[("topk", "topk", 0.5)])
    return [("grid12", grid12), ("relays", relays), ("dynamic", dynamic)]


def grid_phase(dev, sync, **inputs):
    """Phase 16: the scenario-grid engine at the slice's width.  Returns
    (K1 launches, those through the transmit-mask variant, launches by
    batch size, the runner and grid12 for the profile, and grid12's
    `run_sequential` result for phase 17)."""
    import warnings

    from repro_torch.core import protocols
    from repro_torch.fl import scenarios, simulator
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra
    from repro_torch.models import smallnets

    data, _net, init, base = slice_inputs(**inputs)
    runner = scenarios.GridRunner(init, smallnets.apply_cnn, data, base,
                                  device=dev)
    grids = grid_grids()
    # grid12's 400,000-bit PER packets against 32,768-bit segments.
    warnings.filterwarnings("ignore",
                            category=simulator.PacketLengthMismatchWarning)
    expected, expected_tx, expected_b = 0, 0, {}
    for name, grid in grids:
        print(f"[grid] {name}: {len(grid)} scenarios, V = "
              f"{grid.scenarios.link_eps.shape[-1]}, groups "
              f"{[len(g) for g in runner._index_groups(grid)]}; programs "
              f"built: {runner.warmup(grid)}")
        for idx in runner._index_groups(grid):
            sc = grid.scenario(idx[0])
            per_round = {protocols.PROTOCOL_IDS["ra"]: 1,
                         protocols.PROTOCOL_IDS["aayg"]: base.aayg_mixes}.get(
                             sc.protocol_id, 0)
            expected += per_round * base.n_rounds
            if sc.codec_id is not None:
                expected_tx += per_round * base.n_rounds
            if per_round:
                expected_b[len(idx)] = (expected_b.get(len(idx), 0)
                                        + per_round * base.n_rounds)
        runner.run(grid)                 # warm-up: cuDNN plans, allocator
    sync()

    _reset_k1_counts()
    batched = {}
    for name, grid in grids:
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        res = runner.run(grid)
        sync()
        batched[name] = (res, time.perf_counter() - t0,
                         torch.cuda.max_memory_allocated(dev))
    launches = ops.LAUNCHES["ra_aggregate"]
    tx_launches = _ra.VARIANT_LAUNCHES["tx"]
    by_batch = dict(sorted(_ra.BATCH_LAUNCHES.items()))
    check(launches == expected and tx_launches == expected_tx
          and by_batch == dict(sorted(expected_b.items()))
          and launches == GRID_K1_LAUNCHES,
          f"ra_aggregate launched {launches} times on the grid path "
          f"({tx_launches} through the transmit-mask variant; by batch size "
          f"{by_batch}), expected {expected} ({expected_tx}; "
          f"{expected_b})")
    print(f"[grid] ra_aggregate launches on the grid path: {launches} "
          f"(expected {expected}; one per round per group, not per "
          f"scenario), {tx_launches} through the transmit-mask variant "
          f"(expected {expected_tx}); launches by batch size B: {by_batch}")

    test_n = len(data.test_y)
    seqs = {}
    for name, grid in grids:
        res, secs, peak = batched[name]
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        seq = seqs[name] = runner.run_sequential(grid)
        sync()
        seq_secs = time.perf_counter() - t0
        seq_peak = torch.cuda.max_memory_allocated(dev)
        check(res.acc.shape == (len(grid), base.n_rounds, 10)
              and bool(np.isfinite(res.acc).all()
                       and np.isfinite(res.loss).all()),
              f"{name}: metric shapes {res.acc.shape} or non-finite values")
        loss_gap = float(np.abs(res.loss - seq.loss).max())
        acc_gap = float(np.abs(res.acc - seq.acc).max())
        check(loss_gap <= GRID_LOSS_TOL and acc_gap <= 1.0 / test_n + 1e-6,
              f"{name}: batched rows depart from run_sequential: loss "
              f"{loss_gap:.3e} (tol {GRID_LOSS_TOL:g}), accuracy "
              f"{acc_gap:.4f} (tol 1/{test_n})")
        rounds = len(grid) * base.n_rounds
        print(f"[grid] {name}: batched {secs:.4f} s ({len(grid) / secs:.3f} "
              f"scenarios/s, {secs / base.n_rounds:.4f} s a round of the "
              f"grid), peak {peak / 2**30:.3f} GiB | run_sequential "
              f"{seq_secs:.4f} s ({len(grid) / seq_secs:.3f} scenarios/s, "
              f"{seq_secs / rounds:.4f} s a scenario-round), peak "
              f"{seq_peak / 2**30:.3f} GiB | speedup "
              f"{seq_secs / secs:.3f}x | max |loss gap| {loss_gap:.3e}, "
              f"max acc gap {acc_gap:.4f}")
        for i, label in enumerate(res.labels):
            bias = res.bias[i, -1]
            print(f"[grid]   {label:40s} final acc {res.mean_acc[i, -1]:.4f}"
                  f" loss {res.loss[i, -1].mean():.4f} bias "
                  f"{'n/a' if bias != bias else f'{bias:.5f}'}")
    return launches, tx_launches, by_batch, runner, grids[0][1], \
        seqs["grid12"]


def profile_grid_round(runner, grid):
    """Phase 16, last: one batched round of a grid12 group (R&A normalized,
    G = 4) of ``runner``'s sim under torch.profiler.  Local training's
    forward passes run in the program's ``dfl:local_train`` spans around
    each gradient evaluation; their backward passes run on the autograd
    engine's device thread, outside it, and are read from its
    ``evaluate_function`` events; the exchange is the ``dfl:exchange``
    span around `protocols.dispatch_round_seg`, K1 its kernel's events."""
    from repro_torch.fl import scenarios

    psim = runner.sim
    idx = runner._index_groups(grid)[0]
    axes, args = scenarios._hoist_uniform(grid.take(idx).scenarios)
    sb = psim.prepare_batch(args, axes)
    state = psim.init_scan_batch(sb)
    psim.advance_chunk_batch(state, sb)          # warm-up
    backward = "autograd::engine::evaluate_function*"
    wall_ms, events, spans = _profiled(
        lambda: psim.advance_chunk_batch(state, sb),
        ranges=("dfl:local_train", "dfl:exchange", backward))
    dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    k1 = [ev for ev in events if re.search(r"ra_(reg|smem)_kernel", ev.key)]
    k1_us = sum(ev.self_device_time_total for ev in k1)
    fwd_ms = spans["dfl:local_train"] / 1e3
    bwd_ms = spans[backward] / 1e3
    train_ms = fwd_ms + bwd_ms
    exch_ms = spans["dfl:exchange"] / 1e3
    if dev_ms <= 0 or train_ms <= 0:
        print(f"[grid-profile] one batched round: wall {wall_ms:.2f} ms, "
              f"device split not measured (device kernels {dev_ms:.3f} ms, "
              f"local-training range {train_ms:.3f} ms)")
        return
    print(f"[grid-profile] one batched round of {grid.labels[idx[0]]!r}'s "
          f"group (G = {len(idx)}): wall {wall_ms:.2f} ms, device kernels "
          f"{dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}% of wall busy): "
          f"local training's gradient passes {train_ms:.3f} ms "
          f"({100 * train_ms / dev_ms:.1f}%: forward {fwd_ms:.3f}, "
          f"backward {bwd_ms:.3f}), exchange {exch_ms:.3f} ms of "
          f"which K1 {k1_us:.1f} us in {sum(ev.count for ev in k1)} "
          f"launch(es), the rest (updates, metrics) "
          f"{dev_ms - train_ms - exch_ms:.3f} ms")
    for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:8]:
        print(f"[grid-profile]   {ev.self_device_time_total / 1e3:9.3f} ms "
              f"x{ev.count:<5d} {ev.key[:100]}")


def _expected_k1(runner, probes, base):
    """K1 launches of the dispatches the probes logged: one a round per R&A
    group (J per AaYG round), each of B = the group's padded size."""
    from repro_torch.core import protocols
    from repro_torch.fl import scenarios

    total, by_b, groups = 0, {}, 0
    for probe in probes:
        for grid, pad in probe.ran:
            for idx in runner._index_groups(grid):
                groups += 1
                per_round = {protocols.PROTOCOL_IDS["ra"]: 1,
                             protocols.PROTOCOL_IDS["aayg"]:
                             base.aayg_mixes}.get(
                                 grid.scenario(idx[0]).protocol_id, 0)
                if per_round:
                    b = scenarios._bucket_target(len(idx), pad)
                    total += per_round * base.n_rounds
                    by_b[b] = by_b.get(b, 0) + per_round * base.n_rounds
    return total, dict(sorted(by_b.items())), groups


def _hold_to_sequential(tag, labels, results, seq, test_n):
    """Each served row against the same scenario of phase 16's
    `run_sequential`: loss within GRID_LOSS_TOL, accuracy within one test
    sample.  Returns the largest gaps."""
    loss_gap = acc_gap = 0.0
    for lbl, res in zip(labels, results):
        check(res.labels == [lbl], f"{tag}: {lbl} came back as {res.labels}")
        i = seq.labels.index(lbl)
        check(bool(np.isfinite(res.loss).all() and np.isfinite(res.acc).all()),
              f"{tag}: {lbl}: non-finite values")
        loss_gap = max(loss_gap, float(np.abs(res.loss[0] - seq.loss[i]).max()))
        acc_gap = max(acc_gap, float(np.abs(res.acc[0] - seq.acc[i]).max()))
    check(loss_gap <= GRID_LOSS_TOL and acc_gap <= 1.0 / test_n + 1e-6,
          f"{tag}: served rows depart from run_sequential: loss "
          f"{loss_gap:.3e} (tol {GRID_LOSS_TOL:g}), accuracy {acc_gap:.4f} "
          f"(tol 1/{test_n})")
    return loss_gap, acc_gap


def serve_tier_phase(dev, sync, runner, grid12, seq12, **inputs):
    """Phase 17: the serving tier on the card (see the module docstring).
    ``runner`` / ``grid12`` / ``seq12`` come from phase 16; ``inputs`` as
    `grid_phase` takes them.  Returns K1's launches by path."""
    import tempfile
    import threading
    import warnings

    sys.path.insert(0, str(ROOT / "tests"))
    from _torch_serving_faults import install, kill_replica

    from repro_torch.checkpoint import checkpoint
    from repro_torch.core import topology
    from repro_torch.fl import simulator
    from repro_torch.launch import router, serving
    from repro_torch.models import smallnets

    warnings.filterwarnings("ignore",
                            category=simulator.PacketLengthMismatchWarning)
    data, _net, init, base = slice_inputs(**inputs)
    test_n = len(data.test_y)
    # grid12's 400,000-bit PER packets against 32,768-bit segments, as in
    # phase 16: admitted, not refused.
    serve_cfg = serving.ServeConfig(max_batch=SERVE_TIER_BATCH,
                                    batch_buckets=(SERVE_TIER_BATCH,),
                                    max_delay_s=SERVE_TIER_DELAY_S,
                                    strict_packet_check=False)
    requests = [grid12.take([i]) for i in range(len(grid12))]
    labels = [r.labels[0] for r in requests]

    def submit_all(target):
        futures = [target.submit(r, priority=int(i % 4 == 0),
                                 tenant=f"tenant{i % 2}")
                   for i, r in enumerate(requests)]
        return futures

    out = {}
    t_phase = time.perf_counter()
    # (a) one server.
    server = serving.ScenarioServer(init, smallnets.apply_cnn, data, base,
                                    serve=serve_cfg, device=dev)
    built = server.warmup(grid12, *requests)
    probe = install(server)
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_k1_counts()
    t0 = time.perf_counter()
    with server:
        futures = submit_all(server)
        results = [f.result(timeout=SERVE_TIER_WAIT_S) for f in futures]
    secs = time.perf_counter() - t0
    launches, by_b = _k1_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want, want_b, groups = _expected_k1(runner, [probe], base)
    check(launches == want and by_b == want_b,
          f"serve: ra_aggregate launched {launches} times (by batch size "
          f"{by_b}) from the dispatcher thread; the dispatch log gives "
          f"{want} ({want_b})")
    loss_gap, acc_gap = _hold_to_sequential("serve", labels, results, seq12,
                                            test_n)
    snap = server.tracker.snapshot()
    print(f"[serve-tier] server: {len(requests)} requests (3 at priority 1, "
          f"2 tenants), {built} program(s) built by warmup; {probe.calls} "
          f"dispatches of {[len(g) for g, _ in probe.ran]} scenarios, "
          f"{groups} groups; {secs:.4f} s, {len(requests) / secs:.3f} req/s; "
          f"latency p50 {snap['serve/latency_s_p50']:.4f} s p99 "
          f"{snap['serve/latency_s_p99']:.4f} s; mean coalesced "
          f"{snap['serve/coalesced_scenarios_mean']:.3f} scenarios, batch "
          f"fill {snap['grid/batch_fill_mean']:.3f}; peak "
          f"{peak / 2**30:.3f} GiB; K1 launches {launches} (expected {want}; "
          f"by B {by_b}); max |loss gap| {loss_gap:.3e}, max acc gap "
          f"{acc_gap:.4f} vs run_sequential")
    out["serve"] = launches

    # (b) two in-process replicas behind a router; kill the owner of
    # grid12's first family while it holds a dispatch.
    rt = router.ScenarioRouter.in_process(
        init, smallnets.apply_cnn, data, base, n_replicas=2,
        serve=serve_cfg, device=dev,
        route=router.RouterConfig(max_attempts=4, backoff_base_s=0.01,
                                  breaker_cooldown_s=0.3, heartbeat_s=0.05,
                                  attempt_timeout_s=SERVE_TIER_WAIT_S))
    victim = rt._ring.preference(router.grid_signature(requests[0]))[0]
    owned = sum(rt._ring.preference(router.grid_signature(r))[0] == victim
                for r in requests)
    # More than one batch of the victim's requests: hold its second
    # dispatch (the first delivery may then be its own first); else hold
    # its first, and the other replica delivers first.
    hold_at = 1 if owned > SERVE_TIER_BATCH else 0
    release = threading.Event()
    probes = {}
    for name, rep in rt.replicas.items():
        plan = ({} if name != victim else dict(
            stall_on={hold_at: release},
            raise_on={hold_at: RuntimeError(f"{name} killed")}))
        probes[name] = install(rep.server, **plan)
    built = rt.warmup(requests, fanout=2)
    sync()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_k1_counts()
    t0 = time.perf_counter()
    delivered = threading.Event()
    try:
        with rt:
            futures = submit_all(rt)
            for f in futures:
                f.add_done_callback(lambda _f: delivered.set())
            check(delivered.wait(SERVE_TIER_WAIT_S)
                  and probes[victim].stalled.wait(SERVE_TIER_WAIT_S),
                  "router: no first delivery, or the victim never held "
                  "its dispatch")
            first_done = sum(f.done() for f in futures)
            kill_replica(rt.replicas[victim], release)
            results = [f.result(timeout=SERVE_TIER_WAIT_S) for f in futures]
    finally:
        release.set()
        rt.stop(drain=False)
    secs = time.perf_counter() - t0
    launches, by_b = _k1_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want, want_b, groups = _expected_k1(runner, probes.values(), base)
    snap = rt.tracker.snapshot()
    served = sum(snap.get(f"router/replica/{n}/served", 0) for n in probes)
    check(all(f.done() for f in futures) and snap["router/requests"] == 12
          and served == 12 and snap.get("router/retries", 0) >= 1,
          f"router: requests {snap.get('router/requests')}, served {served}, "
          f"retries {snap.get('router/retries', 0)}")
    check(launches == want and by_b == want_b,
          f"router: ra_aggregate launched {launches} times (by batch size "
          f"{by_b}) from two dispatcher threads; the dispatch logs give "
          f"{want} ({want_b})")
    loss_gap, acc_gap = _hold_to_sequential("router", labels, results, seq12,
                                            test_n)
    counters = {k.removeprefix("router/"): snap[k] for k in sorted(snap)
                if k.startswith("router/") and not k.startswith(
                    "router/latency") and "/healthy" not in k}
    print(f"[serve-tier] router: 2 replicas, {built} program(s) built by "
          f"warmup; killed {victim} (owner of {owned} of 12, held its "
          f"dispatch {hold_at}) after {first_done} deliveries; dispatches "
          f"{ {n: [len(g) for g, _ in p.ran] for n, p in probes.items()} }; "
          f"{secs:.4f} s, {len(requests) / secs:.3f} req/s; latency p50 "
          f"{snap['router/latency_s_p50']:.4f} s p99 "
          f"{snap['router/latency_s_p99']:.4f} s; peak {peak / 2**30:.3f} "
          f"GiB; K1 launches {launches} (expected {want}; by B {by_b}); "
          f"max |loss gap| {loss_gap:.3e}, max acc gap {acc_gap:.4f} vs "
          f"run_sequential")
    print(f"[serve-tier] router counters: {counters}")
    out["router"] = launches

    # (c) the resumable loop on the slice's R&A normalized scenario.
    sim = runner.sim
    sc = simulator.make_scenario(
        topology.paper_network(packet_len_bits=base.packet_len_bits),
        dataclasses.replace(base, protocol="ra", mode="ra_normalized"))
    with tempfile.TemporaryDirectory() as d:
        _reset_k1_counts()
        t0 = time.perf_counter()
        full = checkpoint.run_resumable(sim, sc, ckpt_dir=f"{d}/full",
                                        save_every=1)
        t1 = time.perf_counter()
        check(checkpoint.run_resumable(sim, sc, ckpt_dir=f"{d}/cut",
                                       save_every=1, stop_after=1) is None
              and checkpoint.latest_step(f"{d}/cut") == 0,
              "resumable: stop_after=1 did not stop after chunk 0")
        resumed = checkpoint.run_resumable(sim, sc, ckpt_dir=f"{d}/cut",
                                           save_every=1)
        t2 = time.perf_counter()
        launches, _ = _k1_counts()
        want = (sim.n_chunks + 1 + (sim.n_chunks - 1)) * sim.eval_every
        check(launches == want,
              f"resumable: ra_aggregate launched {launches} times, expected "
              f"{want} (one a round of each run)")
        # A second uninterrupted run: are the card's rows reproducible
        # from run to run at all?
        again = checkpoint.run_resumable(sim, sc, ckpt_dir=f"{d}/again")
        ref = {k: v.numpy() for k, v in sim.run_scenario(sc).items()}
        state = checkpoint._saved_state(sim.init_scan(sc.prepare().to(dev)))
        sync()
        t3 = time.perf_counter()
        checkpoint.save(f"{d}/one", state, step=0)
        t4 = time.perf_counter()
        checkpoint.restore(f"{d}/one", state)
        sync()
        t5 = time.perf_counter()
    readings = []
    for other, tag in ((full, "uninterrupted"), (again, "uninterrupted "
                       "again"), (ref, "run_scenario")):
        gap = float(np.abs(resumed["loss"] - other["loss"]).max())
        agap = float(np.abs(resumed["acc"] - other["acc"]).max())
        check(gap <= GRID_LOSS_TOL and agap <= 1.0 / test_n + 1e-6
              and resumed["loss"].shape == (sim.n_chunks, 10),
              f"resumable: resumed rows depart from {tag}: loss {gap:.3e}, "
              f"accuracy {agap:.4f}")
        same = all(np.array_equal(resumed[k], other[k], equal_nan=True)
                   for k in other)
        readings.append(f"{tag}: bit for bit {same}, max |loss gap| "
                        f"{gap:.3e}")
    run_to_run = all(np.array_equal(full[k], again[k], equal_nan=True)
                     for k in full)
    print(f"[serve-tier] resumable: R&A normalized, {sim.n_chunks} chunks, "
          f"save_every 1; uninterrupted {t1 - t0:.4f} s, stop_after=1 then "
          f"resume {t2 - t1:.4f} s; K1 launches {launches} (expected "
          f"{want}); resumed vs {'; vs '.join(readings)}; two "
          f"uninterrupted runs bit for bit: {run_to_run}; one save of the "
          f"round state ({state['w'].numel() * 4 / 2**20:.1f} MiB) "
          f"{t4 - t3:.4f} s, restore {t5 - t4:.4f} s")
    out["resumable"] = launches
    print(f"[serve-tier] phase 17 took {time.perf_counter() - t_phase:.2f} s")
    return out


# ---------------------------------------------------------------------------
# Phases 18-19: the paper's tasks and training (slice 7)
# ---------------------------------------------------------------------------
def _reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak_gib(dev) -> float:
    """Peak device memory since `_reset_peak`; NaN on the CPU."""
    if dev.type != "cuda":
        return float("nan")
    return torch.cuda.max_memory_allocated(dev) / 2**30


def _sync_of(dev):
    return (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" \
        else (lambda: None)


def paper_task_data(kind: str, *, hw: int = 32,
                    image_samples: int = PAPER_IMAGE_SAMPLES,
                    char_kw=None, **kw):
    """A task's federated data: the CIFAR stand-in as (hw, hw, 3) NHWC
    images from `fed_image_classification(d=hw*hw*3)`, or the Shakespeare
    stand-in `fed_char_stream` (its defaults: seq 32, vocab 90)."""
    from repro_torch.data import synthetic

    if kind == "image":
        data = synthetic.fed_image_classification(
            n_clients=10, d=hw * hw * 3, samples_per_client=image_samples,
            **kw)
        shape = (-1, hw, hw, 3)
        return dataclasses.replace(
            data, train_x=[x.reshape(shape) for x in data.train_x],
            test_x=data.test_x.reshape(shape))
    return synthetic.fed_char_stream(**kw, **(char_kw or {}))


def _task_model(model: str, mkw: dict, overrides=None):
    from repro_torch.models import registry

    sm = registry.sim_model(model)
    kw = {**mkw, **(overrides or {})}
    return (lambda g: sm.init_fn(g, **kw)), sm.apply_fn


def paper_tasks_reference(devices):
    """Phase 18, first: each task at a reduced size (ResNet depth 8 width 4
    on 16x16, CharRNN hidden 32) for 2 R&A rounds on ``devices[1]`` and on
    ``devices[0]``'s plain path, from the same weights and uniforms:
    parameters and per-client losses within 1e-4, accuracies equal."""
    from repro_torch.core import topology
    from repro_torch.fl import simulator

    net = topology.paper_network(packet_len_bits=32768)
    cfg = simulator.SimConfig(protocol="ra", seg_len=256, local_epochs=2,
                              n_rounds=2)
    rng = np.random.default_rng(0)
    for label, model, mkw, kind, dkw, lr, _ in PAPER_TASKS:
        init, apply_fn = _task_model(model, mkw, PAPER_REDUCED[model])
        data = paper_task_data(kind, hw=16, image_samples=16,
                               char_kw=dict(sequences_per_client=8,
                                            test_sequences=32), **dkw)
        sims = [simulator.build_sim(
            init, apply_fn, data, seg_len=cfg.seg_len,
            local_epochs=cfg.local_epochs, n_rounds=cfg.n_rounds, device=d)
            for d in devices]
        sc = simulator.make_scenario(net, dataclasses.replace(cfg, lr=lr))
        params0 = init(torch.Generator().manual_seed(0))
        states = [{"params": {k: v[None].expand((10,) + tuple(v.shape))
                              for k, v in params0.items()}} for _ in sims]
        test_n = data.test_y.size        # tokens: every position counts
        for _ in range(cfg.n_rounds):
            u = torch.from_numpy(rng.random((10, 10, sims[0].n_segments),
                                            dtype=np.float32))
            outs = []
            for i, sim in enumerate(sims):
                states[i], m = sim.round_step(states[i], sc, u=u)
                outs.append({k: v.cpu() for k, v in m.items()})
            gap = max(float((states[1]["params"][k].cpu()
                             - states[0]["params"][k].cpu()).abs().max())
                      for k in params0)
            loss_gap = float((outs[1]["loss"] - outs[0]["loss"]).abs().max())
            # Equal accuracies: the same count of right test labels (the
            # means are summed in another order on the card).
            right = [torch.round(o["acc"].double() * test_n) for o in outs]
            check(gap <= 1e-4 and loss_gap <= 1e-4
                  and torch.equal(right[0], right[1]),
                  f"{label} reduced: {devices[1]} vs {devices[0]}: param gap "
                  f"{gap:.2e}, loss gap {loss_gap:.2e}, right test labels "
                  f"{right[1].tolist()} / {right[0].tolist()}")
        print(f"[paper-tasks] {label} reduced ({PAPER_REDUCED[model]}): "
              f"{devices[1]} == {devices[0]} plain path after "
              f"{cfg.n_rounds} R&A rounds (param gap {gap:.2e}, loss gap "
              f"{loss_gap:.2e}, the same right test labels; tol 1e-4)")


def profile_task_round(label, build, scenario):
    """One R&A round of a task under torch.profiler: local training's
    gradient passes (forward in the range, backward on the autograd
    engine's thread), the exchange with K1 in it, and the rest (metrics,
    updates); the ranges are the program's own phase spans."""
    psim = build()
    state = psim.init_scan(scenario)
    psim.advance_chunk(state, scenario)          # warm-up
    backward = "autograd::engine::evaluate_function*"
    wall_ms, events, spans = _profiled(
        lambda: psim.advance_chunk(state, scenario),
        ranges=("dfl:local_train", "dfl:exchange", backward))
    dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    k1 = [ev for ev in events if re.search(r"ra_(reg|smem)_kernel", ev.key)]
    k1_ms = sum(ev.self_device_time_total for ev in k1) / 1e3
    train_ms = (spans["dfl:local_train"] + spans[backward]) / 1e3
    exch_ms = spans["dfl:exchange"] / 1e3
    if dev_ms <= 0 or train_ms <= 0:
        print(f"[paper-tasks] {label} profiled R&A round: wall "
              f"{wall_ms:.2f} ms, device split not measured (device kernels "
              f"{dev_ms:.3f} ms, local-training ranges {train_ms:.3f} ms)")
        return None
    print(f"[paper-tasks] {label} profiled R&A round: wall {wall_ms:.2f} ms,"
          f" device kernels {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}% "
          f"of wall busy): local training {train_ms:.3f} ms "
          f"({100 * train_ms / dev_ms:.2f}%), K1 {1e3 * k1_ms:.1f} us in "
          f"{sum(ev.count for ev in k1)} launch(es) "
          f"({100 * k1_ms / dev_ms:.4f}%), the rest of the exchange "
          f"{exch_ms - k1_ms:.3f} ms, the rest (metrics, updates) "
          f"{dev_ms - train_ms - exch_ms:.3f} ms")
    for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:5]:
        print(f"[paper-tasks]   {ev.self_device_time_total / 1e3:9.3f} ms "
              f"x{ev.count:<5d} {ev.key[:100]}")
    return k1_ms / dev_ms


def paper_tasks_phase(dev, *, image_samples=PAPER_IMAGE_SAMPLES, hw=32,
                      overrides=None, char_kw=None, profile=True):
    """Phase 18: `build_sim` -> `advance_chunk` of each `PAPER_TASKS` task
    on the Table-II network, 3 rounds of each `PAPER_PROTOCOLS` protocol;
    K1's count is set to 0 before each run and must equal one a round for
    R&A and J for AaYG just after.  ``overrides`` ({model: keywords}) and
    the data sizes shrink it for a CPU rehearsal.  Returns K1's launches."""
    import functools

    from repro_torch.core import protocols, topology
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops

    sync = _sync_of(dev)
    base = simulator.SimConfig(seg_len=1024, local_epochs=2, n_rounds=3,
                               seed=0)
    net = topology.paper_network(packet_len_bits=base.packet_len_bits)
    total = 0
    for label, model, mkw, kind, dkw, lr, widths in PAPER_TASKS:
        t_task = time.perf_counter()
        init, apply_fn = _task_model(model, mkw, (overrides or {}).get(model))
        data = paper_task_data(kind, hw=hw, image_samples=image_samples,
                               char_kw=char_kw, **dkw)
        build = functools.partial(
            simulator.build_sim, init, apply_fn, data, seg_len=base.seg_len,
            local_epochs=base.local_epochs, n_rounds=base.n_rounds,
            aayg_mixes=base.aayg_mixes, device=dev)
        sim = build()
        n_params = sum(v.numel() for v in
                       init(torch.Generator().manual_seed(0)).values())
        if not overrides:
            check((n_params, sim.n_segments) == widths,
                  f"{label}: {n_params} parameters in {sim.n_segments} "
                  f"segments, expected {widths}")
        print(f"[paper-tasks] {label}: {n_params} parameters, "
              f"{sim.n_segments} segments of {sim.seg_len}, lr {lr:g}; 10 "
              f"clients x "
              f"{max(len(x) for x in data.train_x)} padded samples of "
              f"{tuple(data.train_x[0].shape[1:])}, {len(data.test_y)} test")
        scenarios = {pm: simulator.make_scenario(net, dataclasses.replace(
            base, protocol=pm[0], mode=pm[1], lr=lr)).prepare()
            for pm in PAPER_PROTOCOLS}
        first = scenarios[PAPER_PROTOCOLS[0]]
        sim.advance_chunk(sim.init_scan(first), first)   # warm-up
        sync()
        for pm in PAPER_PROTOCOLS:
            sc = scenarios[pm]
            _reset_k1_counts()
            _reset_peak(dev)
            state = sim.init_scan(sc)
            sync()
            secs, rows = [], []
            for _ in range(sim.n_chunks):
                t0 = time.perf_counter()
                state, m = sim.advance_chunk(state, sc)
                sync()
                secs.append(time.perf_counter() - t0)
                rows.append({k: v.cpu() for k, v in m.items()})
            launches = ops.LAUNCHES["ra_aggregate"]
            peak = _peak_gib(dev)
            per_round = {protocols.PROTOCOL_IDS["ra"]: 1,
                         protocols.PROTOCOL_IDS["aayg"]: base.aayg_mixes}.get(
                             sc.protocol_id, 0)
            want = per_round * base.n_rounds
            check(launches == want, f"{label} {pm}: ra_aggregate launched "
                  f"{launches} times, expected {want}")
            total += launches
            loss = torch.stack([r["loss"] for r in rows])
            acc = torch.stack([r["acc"] for r in rows])
            check(tuple(loss.shape) == (base.n_rounds, 10)
                  and bool(torch.isfinite(loss).all()
                           and torch.isfinite(acc).all()),
                  f"{label} {pm}: metric shape {tuple(loss.shape)} or "
                  f"non-finite values")
            mean_loss = loss.mean(1)
            if pm[0] == "ra":
                check(float(mean_loss[-1]) < float(mean_loss[0]),
                      f"{label}: R&A's round-3 train loss "
                      f"{float(mean_loss[-1]):.4f} is not below round 1's "
                      f"{float(mean_loss[0]):.4f}")
            print(f"[paper-tasks] {label} {pm[0]:4s}/{pm[1]}: s/round "
                  f"{[round(x, 4) for x in secs]}, peak {peak:.3f} GiB, K1 "
                  f"launches {launches} (expected {want}); loss/round "
                  f"{[round(float(x), 4) for x in mean_loss]} acc/round "
                  f"{[round(float(x), 4) for x in acc.mean(1)]}")
        if profile:
            profile_task_round(label, build, first)
        del sim, scenarios
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        print(f"[paper-tasks] {label} took "
              f"{time.perf_counter() - t_task:.2f} s")
    return total


def nwp_grid_phase(dev, *, sequences=32, n_rounds=10,
                   model_name="transformer_nwp", tag="paper-tasks"):
    """Phase 18, last (and phase 22 (d)): `registry.sim_model(model_name)`
    (default the tiny "transformer_nwp") on the non-iid char stream
    through `run_grid` with benchmarks/fig_nwp.py's grid (R&A, C-FL and no
    exchange x 2 seeds on the Table-II network at 17 dBm and 25,000-bit
    packets; seq 16, seg 64, lr 0.5, 1 local epoch).  K1 launches once a
    round for the R&A group, at B = 2.  Returns them."""
    import warnings

    from repro_torch.core import topology
    from repro_torch.data import synthetic
    from repro_torch.fl import scenarios, simulator
    from repro_torch.models import registry

    sync = _sync_of(dev)
    model = registry.sim_model(model_name, vocab=90)
    data = synthetic.fed_char_stream(
        n_clients=10, vocab=90, seq_len=16, sequences_per_client=sequences,
        test_sequences=2 * sequences, iid=False, seed=0)
    cfg = simulator.SimConfig(n_rounds=n_rounds, seg_len=64, local_epochs=1,
                              lr=0.5)
    net = topology.make_network(
        topology.TABLE_II_COORDS, edge_density=0.5, packet_len_bits=25_000,
        n_clients=10, tx_power_dbm=17.0)
    grid = scenarios.ScenarioGrid.product(
        networks=[("tab2", net)], protocols=NWP_PROTOCOLS, seeds=range(2))
    warnings.filterwarnings("ignore",
                            category=simulator.PacketLengthMismatchWarning)
    runner = scenarios.GridRunner(model.init_fn, model.apply_fn, data, cfg,
                                  device=dev)
    runner.run(grid)                              # warm-up
    sync()
    _reset_k1_counts()
    _reset_peak(dev)
    t0 = time.perf_counter()
    res = runner.run(grid)
    sync()
    secs = time.perf_counter() - t0
    launches, by_batch = _k1_counts()
    check(launches == n_rounds and by_batch == {2: n_rounds},
          f"{model_name} grid: ra_aggregate launched {launches} times "
          f"(by batch size {by_batch}), expected {n_rounds} of B = 2")
    check(bool(np.isfinite(res.loss).all() and np.isfinite(res.acc).all()),
          f"{model_name} grid: non-finite values")
    n_params = sum(v.numel() for v in
                   model.init_fn(torch.Generator().manual_seed(0)).values())
    print(f"[{tag}] {model_name} ({n_params} parameters, "
          f"{runner.sim.n_segments} segments of 64) through run_grid: "
          f"{len(grid)} scenarios x {n_rounds} rounds in {secs:.4f} s "
          f"({len(grid) / secs:.3f} scenarios/s), peak {_peak_gib(dev):.3f} "
          f"GiB, K1 launches {launches} (by B {by_batch})")
    for label, one in res.items():
        print(f"[{tag}]   {label:28s} final token acc "
              f"{float(one.mean_acc[-1]):.4f} loss "
              f"{float(one.loss_per_client[-1].mean()):.4f}")
    return launches


def _adamw_gap(got: dict, want: dict, grads: dict, lr: float,
               wd: float = 0.1) -> tuple[float, int]:
    """One AdamW step of two runs from the same weights: the largest gap
    where the gradient stands above float32 noise (|g| >= 1e-6), and how
    many parameters departed by more than 1e-4 elsewhere; every gap must
    stay within the step's bound 2 lr (1 + wd |p|) (a first Adam step is
    g / (|g| + eps) lr, which last-bit gradient differences flip where
    |g| ~ eps)."""
    worst, departed = 0.0, 0
    for name, w in want.items():
        g = got[name].detach().float().cpu()
        w = w.detach().float().cpu()
        gap = (g - w).abs()
        clear = grads[name].abs() >= 1e-6
        if bool(clear.any()):
            worst = max(worst, float(gap[clear].max()))
        check(bool((gap <= 2 * lr * (1 + wd * w.abs()) + 1e-6).all()),
              f"{name}: an AdamW step apart by more than its bound")
        departed += int((gap[~clear] > 1e-4).sum())
    return worst, departed


def train_step_reference(devices, cases=(("qwen2.5-3b", {}),
                                         ("rwkv6-1.6b", {}))):
    """Phase 19, last (and phases 21 (d), 22 (c), 23 (d)): one float32
    smoke `train_step` (AdamW, lr 3e-4) of each case's architecture (its
    smoke config with the case's overrides) on ``devices[1]`` and on
    ``devices[0]`` from the same weights and tokens (and modal embeddings,
    the gates set): loss within 1e-5, moments within 1e-4,
    parameters within 1e-4 where the gradient is above float32 noise
    (`_adamw_gap`)."""
    from repro_torch.configs import base as cfgbase
    from repro_torch.models import registry
    from repro_torch.models import transformer as T

    for arch, overrides in cases:
        cfg = dataclasses.replace(cfgbase.smoke_variant(cfgbase.get(arch)),
                                  **overrides)
        bundle = registry.build(cfg)
        params0 = bundle.init(torch.Generator().manual_seed(0), device="cpu")
        batch = {"tokens": torch.from_numpy(np.random.default_rng(3).integers(
            0, cfg.vocab, size=(4, 64)))}
        if registry.needs_modal(cfg):
            set_gates(params0)
            batch["modal_embeds"] = torch.from_numpy(
                np.random.default_rng(4).normal(size=(
                    4, T.modal_len(cfg), cfg.d_model)).astype(np.float32))
        leaves = {k: v.clone().requires_grad_() for k, v in params0.items()}
        loss, _ = bundle.loss_fn(leaves, batch, device="cpu")
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        outs = []
        for d in devices:
            params = {k: v.clone().to(d) for k, v in params0.items()}
            state = {"params": params, "opt": bundle.optimizer.init(params)}
            outs.append(bundle.train_step(
                state, {k: v.to(d) for k, v in batch.items()}, device=d))
        (s0, m0), (s1, m1) = outs
        loss_gap = abs(float(m1["loss"]) - float(m0["loss"]))
        mom_gap = max(float((s1["opt"][n][k].cpu() - s0["opt"][n][k]).abs()
                            .max()) for n in ("m", "v") for k in params0)
        worst, departed = _adamw_gap(s1["params"], s0["params"], grads, 3e-4)
        check(loss_gap <= 1e-5 and mom_gap <= 1e-4 and worst <= 1e-4,
              f"{arch} smoke train_step: {devices[1]} vs {devices[0]}: loss "
              f"gap {loss_gap:.2e}, moments {mom_gap:.2e}, parameters "
              f"{worst:.2e}")
        print(f"[train] float32 smoke {arch} {overrides or ''} train_step: "
              f"{devices[1]} == "
              f"{devices[0]} (loss gap {loss_gap:.2e}, moments gap "
              f"{mom_gap:.2e}, parameters gap {worst:.2e} where |g| >= 1e-6; "
              f"{departed} parameters with |g| < 1e-6 apart by more than "
              f"1e-4, within the step's bound)")


def refuse_autograd_check(dev):
    """K2 and K3 on the card raise where a gradient would flow, under
    autograd and under `torch.func.grad`, and run under no_grad."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q, k, v = rnd(1, 64, 4, 64), rnd(1, 64, 2, 64), rnd(1, 64, 2, 64)
    r, kk, vv = rnd(1, 32, 2, 64), rnd(1, 32, 2, 64), rnd(1, 32, 2, 64)
    w = -torch.rand((1, 32, 2, 64), generator=gen, device=dev)
    u = rnd(2, 64, dtype=torch.float32)
    calls = {
        "flash_attention": lambda x: ops.flash_attention(
            x, k, v, scale=0.125, causal=True, device=dev),
        "rwkv6_scan": lambda x: ops.rwkv6_scan(x, kk, vv, w, u, device=dev),
    }
    inputs = {"flash_attention": q, "rwkv6_scan": r}
    for name, call in calls.items():
        x = inputs[name]
        with torch.no_grad():
            call(x.clone().requires_grad_())
        for how, fn in (
                ("autograd", lambda: call(x.clone().requires_grad_())),
                ("torch.func.grad", lambda: torch.func.grad(
                    lambda t: call(t).float().sum())(x))):
            try:
                out = fn()
            except RuntimeError as err:
                check("no backward" in str(err),
                      f"{name} under {how} raised {err}")
                continue
            check(False, f"{name} under {how} returned "
                  f"{type(out).__name__} (grad_fn {out.grad_fn}) instead "
                  f"of raising")
    print("[train] K2 flash_attention and K3 rwkv6_scan raise under "
          "autograd and under torch.func.grad on the card, and run under "
          "no_grad")


def profile_train_step(dev, cfg):
    """Phase 19: one full-width train step (after a warm-up step, from the
    same weights and batch as `launch.train.main`'s first) under
    torch.profiler: the forward and backward against the AdamW update (a
    range around `registry._update_leafwise`), bf16 / float32 products
    (GEMM kernels) against the rest."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.models import registry

    bundle = registry.build(cfg, lr=TRAIN_FULL_LR)
    state = registry.init_state(
        bundle, torch.Generator(dev).manual_seed(0), device=dev)
    batches = pipeline.lm_batches(
        synthetic.lm_token_stream(vocab=cfg.vocab, n_tokens=200_000), 8, 128)
    batch = {"tokens": torch.from_numpy(next(batches)[:, :-1]).to(dev)}
    state, _ = bundle.train_step(state, batch, device=dev)     # warm-up
    with _ranged_parts((("repro_torch.models.registry", "_update_leafwise",
                         "train:optimizer"),)) as ranges:
        wall_ms, events, spans = _profiled(
            lambda: bundle.train_step(state, batch, device=dev),
            ranges=ranges)
    del state
    dev_ms = sum(ev.self_device_time_total for ev in events) / 1e3
    opt_ms = spans["train:optimizer"] / 1e3
    gemm = [ev for ev in events if re.search(GEMM_KERNELS, ev.key, re.I)]
    gemm_ms = sum(ev.self_device_time_total for ev in gemm) / 1e3
    if dev_ms <= 0:
        print(f"[train-profile] one full-width step: wall {wall_ms:.2f} ms, "
              f"device time not measured (the profiler saw no CUDA kernels)")
        return
    print(f"[train-profile] one full-width qwen2.5-3b step (8 x 128 tokens): "
          f"wall {wall_ms:.2f} ms, device kernels {dev_ms:.3f} ms "
          f"({100 * dev_ms / wall_ms:.1f}% of wall busy) in "
          f"{sum(ev.count for ev in events)} launches: AdamW update "
          f"{opt_ms:.3f} ms ({100 * opt_ms / dev_ms:.1f}%), forward + "
          f"backward {dev_ms - opt_ms:.3f} ms, of which GEMM kernels "
          f"{gemm_ms:.3f} ms ({100 * gemm_ms / dev_ms:.1f}% of device time)")
    for ev in sorted(events, key=lambda x: -x.self_device_time_total)[:10]:
        print(f"[train-profile]   {ev.self_device_time_total / 1e3:9.3f} ms "
              f"x{ev.count:<5d} {ev.key[:100]}")


def _full_train_losses(dev, cfg, lr: float, dtype) -> tuple[list, float]:
    """`TRAIN_FULL_STEPS` steps of `registry.train_step` on ``cfg`` with
    ``dtype`` parameters at ``lr``, from `launch.train.main`'s weights and
    batches (seed 0, 8 x 128 tokens): the losses and the share of the
    parameters that moved."""
    from repro_torch.data import pipeline, synthetic
    from repro_torch.models import registry

    cfg = dataclasses.replace(cfg, dtype=dtype)
    bundle = registry.build(cfg, lr=lr)
    state = registry.init_state(
        bundle, torch.Generator(dev).manual_seed(0), device=dev)
    batches = pipeline.lm_batches(
        synthetic.lm_token_stream(vocab=cfg.vocab, n_tokens=200_000), 8, 128)
    losses = []
    for _ in range(TRAIN_FULL_STEPS):
        batch = {"tokens": torch.from_numpy(next(batches)[:, :-1]).to(dev)}
        state, m = bundle.train_step(state, batch, device=dev)
        losses.append(float(m["loss"]))
    moved = _moved_share(dev, cfg, state["params"])
    del state
    torch.cuda.empty_cache()
    return losses, moved


def _moved_share(dev, cfg, params: dict) -> float:
    """The share of ``params``' entries that differ from `launch.train`'s
    seed-0 draw of them."""
    from repro_torch.models import registry

    init = registry.build(cfg).init(torch.Generator(dev).manual_seed(0),
                                    device=dev)
    moved = sum(int((params[k] != v).sum()) for k, v in init.items())
    return moved / sum(v.numel() for v in init.values())


def train_witness(dev, cfg, losses: list, start: float) -> None:
    """Phase 19 (a), its float32 twins at full width and depth: at
    `TRAIN_FULL_LR` the twin's loss must fall as the bf16 run's did; at
    `TRAIN_TWIN_LR`, where bf16 moves most weights, a bf16 run and its twin
    must agree within `TRAIN_TWIN_TOL` at every step (both overshoot
    there, so the overshoot is AdamW's, not bf16's)."""
    f32, _ = _full_train_losses(dev, cfg, TRAIN_FULL_LR, torch.float32)
    check(all(math.isfinite(x) for x in f32)
          and abs(f32[0] - start) <= TRAIN_START_TOL and f32[-1] < f32[0],
          f"qwen2.5-3b float32 twin at lr {TRAIN_FULL_LR:g}: losses {f32}")
    print(f"[train] (a) float32 twin at lr {TRAIN_FULL_LR:g}: losses "
          f"{[round(x, 4) for x in f32]} (bf16 {[round(x, 4) for x in losses]})")
    pair = {dt: _full_train_losses(dev, cfg, TRAIN_TWIN_LR, dt)
            for dt in (torch.bfloat16, torch.float32)}
    (b16, moved), (f32, _) = pair.values()
    gap = max(abs(a - b) for a, b in zip(b16, f32))
    check(all(math.isfinite(x) for x in b16 + f32) and gap <= TRAIN_TWIN_TOL,
          f"qwen2.5-3b at lr {TRAIN_TWIN_LR:g}: bf16 losses {b16} against "
          f"float32 {f32} (tol {TRAIN_TWIN_TOL})")
    print(f"[train] (a) at lr {TRAIN_TWIN_LR:g}: bf16 losses "
          f"{[round(x, 4) for x in b16]} ({100 * moved:.2f} % of the "
          f"parameters changed), float32 {[round(x, 4) for x in f32]}: "
          f"largest gap {gap:.4f} (tol {TRAIN_TWIN_TOL}); the last above the "
          f"first: bf16 {b16[-1] > b16[0]}, float32 {f32[-1] > f32[0]}")


def train_phase(dev):
    """Phase 19: `launch.train.main` twice on the card: (a) qwen2.5-3b at
    full width and depth (bf16, AdamW with float32 moments, remat), 3
    steps of 8 x 128 tokens; (b) the ``--dfl`` loop at the smoke size, 4
    clients, 10 steps, an exchange every 5 (K1 twice, through
    `protocols.ra_round`).  Training never launches K2 or K3.  Returns K1's
    launches of (b)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    refuse_autograd_check(dev)
    other = {k: ops.LAUNCHES[k] for k in ("flash_attention", "rwkv6_scan")}
    torch.cuda.empty_cache()
    _reset_peak(dev)
    mem0 = torch.cuda.memory_stats(dev)
    t0 = time.perf_counter()
    out = train.main(["--arch", "qwen2.5-3b", "--full-config", "--steps",
                      str(TRAIN_FULL_STEPS), "--batch", "8", "--seq", "128",
                      "--lr", str(TRAIN_FULL_LR)])
    wall = time.perf_counter() - t0
    peak = _peak_gib(dev)
    mem1 = torch.cuda.memory_stats(dev)
    mallocs, retries = (mem1.get(k, 0) - mem0.get(k, 0) for k in
                        ("num_device_alloc", "num_alloc_retries"))
    losses, step_s = out["losses"], out["step_s"]
    vocab, d_model = out["cfg"].vocab, out["cfg"].d_model
    start = math.log(vocab) + d_model * 0.02 ** 2 / 2
    check(out["n_params"] == 3_085_938_688,
          f"qwen2.5-3b: {out['n_params']} parameters")
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - start) <= TRAIN_START_TOL
          and losses[-1] < losses[0],
          f"qwen2.5-3b full training: losses {losses} (step 0 expected "
          f"within {TRAIN_START_TOL} of {start:.4f}, the last below it)")
    moved = _moved_share(dev, out["cfg"], out["params"])
    steady = step_s[1:]
    WHOLE_STEP["train"] = (out["cfg"], out["tokens_per_step"],
                           statistics.median(steady))
    tok_s = [out["tokens_per_step"] / s for s in steady]
    print(f"[train] (a) qwen2.5-3b full config, {out['n_params']} parameters"
          f" (bf16, AdamW float32 moments, remat): losses "
          f"{[round(x, 4) for x in losses]} (ln V + d 0.02^2 / 2 = "
          f"{start:.4f}, ln V = {math.log(vocab):.4f}); s/step "
          f"{[round(x, 4) for x in step_s]} (step 0 includes first-use "
          f"setup); tokens/s after step 0 {[round(x, 1) for x in tok_s]}; "
          f"peak {peak:.3f} GiB; main() {wall:.2f} s; the caching allocator "
          f"took {mallocs} device allocations and {retries} retries "
          f"(frees cache and allocates again); {100 * moved:.2f} % of the "
          f"bf16 parameters changed over the {TRAIN_FULL_STEPS} steps at lr "
          f"{TRAIN_FULL_LR:g}")
    cfg = out["cfg"]
    del out
    torch.cuda.empty_cache()
    train_witness(dev, cfg, losses, start)
    profile_train_step(dev, cfg)
    torch.cuda.empty_cache()

    _reset_k1_counts()
    _reset_peak(dev)
    out = train.main(["--dfl", "--clients", "4", "--steps", "10",
                      "--rounds-per-exchange", "5"])
    launches = ops.LAUNCHES["ra_aggregate"]
    check(launches == out["k1_launches"] == 2,
          f"--dfl: ra_aggregate launched {launches} times "
          f"({out['k1_launches']} by main), expected 2 (one a ra_round)")
    check(all(math.isfinite(x) for x in out["losses"]),
          "--dfl: non-finite losses")
    print(f"[train] (b) --dfl, {out['cfg'].name} ({out['n_params']} "
          f"parameters), 4 clients x 10 steps of 8 x 128 tokens, ra_round "
          f"every 5: round losses {[round(x, 4) for x in out['round_losses']]}"
          f", median s/step {statistics.median(out['step_s']):.4f} "
          f"({out['tokens_per_step'] / statistics.median(out['step_s']):.1f}"
          f" tokens/s), peak {_peak_gib(dev):.3f} GiB, K1 launches "
          f"{launches} (expected 2)")
    check(all(ops.LAUNCHES[k] == n for k, n in other.items()),
          f"training launched K2 or K3: {other} -> "
          f"{ {k: ops.LAUNCHES[k] for k in other} }")
    train_step_reference((torch.device("cpu"), dev))
    return launches


# ---------------------------------------------------------------------------
# Phases 20-21: the dense zoo and the sliding window (slice 8)
# ---------------------------------------------------------------------------
def dense_zoo_phase(dev) -> dict:
    """Phase 20: llama3-8b, starcoder2-3b and gemma-7b served at full width
    and depth (`serve_full`: K2 once a prefill layer, at D = 256 for gemma;
    each prefill held to impl="torch"), each with one profiled prefill and
    decode step.  Returns K2's launches by architecture."""
    launches = {}
    for arch in DENSE_ZOO:
        cfg, res, launches[arch] = serve_full(dev, "dense-zoo", arch=arch)
        profile_serve(cfg, res, "dense-zoo", "flash_attention")
        del res
        torch.cuda.empty_cache()
    return launches


def wrapped_cache_check(dev) -> None:
    """Phase 21 (b): llama3-8b at full width in float32, a wrapped cache of
    `WRAP_WINDOW` slots (`init_cache(window=)`) from empty for
    `WRAP_STEPS` greedy steps (pos = abs % W, abs_pos = abs, full_cache once
    every slot holds a key), against the unwrapped windowed decode (a cache
    of `WRAP_STEPS` slots, the window mask) fed the same tokens: the same
    greedy ids, logits within SERVE_F32_TOL of their largest."""
    from repro_torch.configs import base
    from repro_torch.models import registry

    cfg = dataclasses.replace(base.get("llama3-8b"), dtype=torch.float32)
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator(dev).manual_seed(0), device=dev)
    b, w, n = SERVE_SHAPE["batch"], WRAP_WINDOW, WRAP_STEPS
    tok0 = torch.randint(0, cfg.vocab, (b, 1), device=dev,
                         generator=torch.Generator(dev).manual_seed(1))
    wrapped = bundle.init_cache(b, n, window=w, device=dev)
    check(tuple(wrapped["k"].shape) == (cfg.n_layers, b, w, cfg.n_kv_heads,
                                        cfg.hd),
          f"wrapped cache {tuple(wrapped['k'].shape)}")
    slots = wrapped["k"]
    _reset_peak(dev)
    logits, tok = [], tok0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(n):
        lg, wrapped = bundle.serve_step(params, wrapped, tok, a % w, window=w,
                                        abs_pos=a, full_cache=a >= w - 1,
                                        device=dev)
        logits.append(lg[:, -1])
        tok = lg[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    wrapped_s = time.perf_counter() - t0
    check(wrapped["k"] is slots, "the wrapped cache was not written in place")
    flat = bundle.init_cache(b, n, device=dev)
    tok, worst, same = tok0, 0.0, True
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for a in range(n):
        lg, flat = bundle.serve_step(params, flat, tok, a, window=w,
                                     device=dev)
        worst = max(worst, _rel_gap(lg[:, -1], logits[a]))
        same &= bool(torch.equal(lg[:, -1].argmax(-1), logits[a].argmax(-1)))
        tok = logits[a].argmax(-1)[:, None]
    flat_s = time.perf_counter() - t0
    peak = _peak_gib(dev)
    print(f"[window] (b) wrapped cache, llama3-8b float32 full width: {w} "
          f"slots, {n} steps x batch {b} from empty, {wrapped_s / n * 1e3:.2f}"
          f" ms a step; the unwrapped windowed decode ({n} slots) "
          f"{flat_s / n * 1e3:.2f} ms a step (with the comparison); same "
          f"greedy ids: {same}; worst logits gap/max {worst:.3e} (tol "
          f"{SERVE_F32_TOL:g}); peak {peak:.3f} GiB")
    check(same and worst <= SERVE_F32_TOL,
          f"wrapped vs unwrapped windowed decode: same ids {same}, logits "
          f"gap {worst:.3e}")
    del params, wrapped, flat, logits
    torch.cuda.empty_cache()


def long_context_step(dev) -> None:
    """Phase 21 (c): one decode step of llama3-8b (bf16, full width) at
    long_500k's shape: batch 1 at abs_pos 524,287, with the cache length,
    window and full_cache that `launch.dryrun.decode_plan` gives it
    (`LONG_CONTEXT_WINDOW` wrapped slots, full of keys)."""
    from repro_torch.configs import base
    from repro_torch.launch import dryrun
    from repro_torch.models import registry

    shape = base.INPUT_SHAPES["long_500k"]
    cfg = base.get("llama3-8b")
    cache_len, w, full_cache = dryrun.decode_plan(cfg, shape)
    b, abs_pos = shape.global_batch, shape.seq_len - 1
    bundle = registry.build(cfg)
    params = bundle.init(torch.Generator(dev).manual_seed(0), device=dev)
    gen = torch.Generator(dev).manual_seed(2)
    cache = bundle.init_cache(b, cache_len, window=w, device=dev)
    for t in cache.values():
        t.copy_(torch.randn(t.shape, generator=gen, device=dev))
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=gen, device=dev)
    _reset_peak(dev)

    def step():
        return bundle.serve_step(params, cache, tok, abs_pos % cache_len,
                                 window=w, abs_pos=abs_pos,
                                 full_cache=full_cache, device=dev)[0]

    step()                       # warm-up: the same slot, the same value
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = step()
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    check(tuple(logits.shape) == (b, 1, cfg.vocab)
          and bool(torch.isfinite(logits).all()),
          f"long_500k step: logits {tuple(logits.shape)}")
    print(f"[window] (c) long_500k decode step, llama3-8b bf16: batch {b}, "
          f"{w} wrapped slots ({sum(t.numel() * t.element_size() for t in cache.values()) / 2**30:.3f}"
          f" GiB of K/V), abs_pos {abs_pos}, full_cache {full_cache}: "
          f"{step_s:.4f} s a "
          f"step; peak {_peak_gib(dev):.3f} GiB")
    del params, cache
    torch.cuda.empty_cache()


def train_attention_check(dev) -> None:
    """Phase 21 (d): `registry.build(...).train_step` on llama3-8b at full
    width and `TRAIN_ATTN_DEPTH` layers (bf16, AdamW at TRAIN_FULL_LR) under
    attn_impl naive, chunked and flash, from the same weights and batches,
    3 steps each: losses finite and within TRAIN_TWIN_TOL of naive's at
    every step; K2 and K3 launch no time.  Then a float32 smoke llama3
    `train_step` under flash against the CPU."""
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.models import registry

    cfg0 = dataclasses.replace(base.get("llama3-8b"),
                               n_layers=TRAIN_ATTN_DEPTH,
                               attn_chunk=TRAIN_ATTN_CHUNK)
    params0 = registry.build(cfg0).init(torch.Generator(dev).manual_seed(0),
                                        device=dev)
    gen = torch.Generator(dev).manual_seed(3)
    batches = [torch.randint(0, cfg0.vocab, TRAIN_ATTN_TOKENS, generator=gen,
                             device=dev) for _ in range(3)]
    other = {k: ops.LAUNCHES[k] for k in ("flash_attention", "rwkv6_scan")}
    losses = {}
    for impl in ("naive", "chunked", "flash"):
        bundle = registry.build(dataclasses.replace(cfg0, attn_impl=impl),
                                lr=TRAIN_FULL_LR)
        params = {k: v.clone() for k, v in params0.items()}
        state = {"params": params, "opt": bundle.optimizer.init(params)}
        torch.cuda.empty_cache()
        _reset_peak(dev)
        losses[impl], step_s = [], []
        for tokens in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = bundle.train_step(state, {"tokens": tokens},
                                         device=dev)
            losses[impl].append(float(m["loss"]))
            step_s.append(time.perf_counter() - t0)
        print(f"[window] (d) llama3-8b full width, {TRAIN_ATTN_DEPTH} layers, "
              f"{TRAIN_ATTN_TOKENS[0]} x {TRAIN_ATTN_TOKENS[1]} tokens, "
              f"attn_impl={impl} (chunk {TRAIN_ATTN_CHUNK}): losses "
              f"{[round(x, 4) for x in losses[impl]]}, s/step "
              f"{[round(x, 4) for x in step_s]}, peak {_peak_gib(dev):.3f} "
              f"GiB")
        del state, params
    gap = max(abs(a - b) for impl in ("chunked", "flash")
              for a, b in zip(losses[impl], losses["naive"]))
    print(f"[window] (d) largest loss gap to naive {gap:.4f} (tol "
          f"{TRAIN_TWIN_TOL})")
    check(all(math.isfinite(x) for ls in losses.values() for x in ls)
          and gap <= TRAIN_TWIN_TOL, f"training attentions: {losses}")
    check(all(ops.LAUNCHES[k] == n for k, n in other.items()),
          "training launched K2 or K3")
    del params0
    torch.cuda.empty_cache()
    train_step_reference((torch.device("cpu"), dev),
                         cases=(("llama3-8b", dict(attn_impl="flash",
                                                   attn_chunk=16)),))


def window_phase(dev) -> int:
    """Phase 21: the sliding window on the card ((a)-(d), see the
    constants above).  Returns K2's launches on (a)'s serving path."""
    cfg, res, launches = serve_full(dev, "window", arch="llama3-8b",
                                    window=WINDOW)
    profile_serve(cfg, res, "window", "flash_attention", window=WINDOW)
    del res
    torch.cuda.empty_cache()
    wrapped_cache_check(dev)
    long_context_step(dev)
    train_attention_check(dev)
    return launches


# ---------------------------------------------------------------------------
# Phase 22: the MoE and hybrid families (slice 9)
# ---------------------------------------------------------------------------
def moe_hybrid_train(dev) -> None:
    """Phase 22 (b): `launch.train.main` on each of `MOE_HYBRID` at full
    width and depth (bf16, AdamW with float32 moments), TRAIN_FULL_STEPS
    steps of 8 x 128 tokens at TRAIN_FULL_LR: losses finite, the first
    within TRAIN_START_TOL of ln V + d_model 0.02^2 / 2 (as phase 19's),
    the MoE's aux finite and positive; K2 and K3 launch no time."""
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    other = {k: ops.LAUNCHES[k] for k in ("flash_attention", "rwkv6_scan")}
    for arch in MOE_HYBRID:
        torch.cuda.empty_cache()
        _reset_peak(dev)
        t0 = time.perf_counter()
        out = train.main(["--arch", arch, "--full-config", "--steps",
                          str(TRAIN_FULL_STEPS), "--batch", "8", "--seq",
                          "128", "--lr", str(TRAIN_FULL_LR)])
        wall = time.perf_counter() - t0
        cfg, losses, auxes = out["cfg"], out["losses"], out["auxes"]
        start = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
        check(all(math.isfinite(x) for x in losses + auxes)
              and abs(losses[0] - start) <= TRAIN_START_TOL,
              f"{arch} full training: losses {losses}, aux {auxes} (step 0 "
              f"expected within {TRAIN_START_TOL} of {start:.4f})")
        if cfg.family == "moe":
            check(all(x > 0 for x in auxes), f"{arch}: aux {auxes}")
        tok_s = [out["tokens_per_step"] / x for x in out["step_s"][1:]]
        print(f"[moe-hybrid] (b) {arch} full config, {out['n_params']} "
              f"parameters (bf16, AdamW float32 moments, remat "
              f"{cfg.remat}), {TRAIN_FULL_STEPS} steps of 8 x 128 tokens at "
              f"lr {TRAIN_FULL_LR:g}: losses {[round(x, 4) for x in losses]} "
              f"(ln V + d 0.02^2 / 2 = {start:.4f}; the last below the "
              f"first: {losses[-1] < losses[0]}), aux "
              f"{[round(x, 4) for x in auxes]}; s/step "
              f"{[round(x, 4) for x in out['step_s']]} (step 0 includes "
              f"first-use setup); tokens/s after step 0 "
              f"{[round(x, 1) for x in tok_s]}; peak {_peak_gib(dev):.3f} "
              f"GiB; main() {wall:.2f} s")
        del out
    torch.cuda.empty_cache()
    check(all(ops.LAUNCHES[k] == n for k, n in other.items()),
          f"training launched K2 or K3: {other} -> "
          f"{ {k: ops.LAUNCHES[k] for k in other} }")
    print("[moe-hybrid] (b) K2 and K3 launched no time in either training "
          "run")


def moe_hybrid_phase(dev) -> tuple[dict, dict]:
    """Phase 22: (a) `MOE_HYBRID` served at full width and depth
    (`serve_full`: K2 once a prefill layer, none in decode; each prefill
    held to impl="torch" by `serve_vs_plain`), each with one profiled
    prefill and decode step split by `PROFILE_PARTS`; (b) trained
    (`moe_hybrid_train`); (c) `MOE_HYBRID_SMOKE`'s float32 smoke variants
    served and one `train_step` each, card against the CPU; (d) phase 18's
    NWP grid with each of `MOE_HYBRID_NWP` as the clients.  Returns K2's
    launches by architecture and K1's by grid."""
    k2 = {}
    for arch in MOE_HYBRID:
        cfg, res, k2[arch] = serve_full(dev, "moe-hybrid", arch=arch)
        profile_serve(cfg, res, "moe-hybrid", "flash_attention")
        del res
        torch.cuda.empty_cache()
    moe_hybrid_train(dev)
    for arch in MOE_HYBRID_SMOKE:
        serve_reference(dev, "moe-hybrid", arch)
    train_step_reference((torch.device("cpu"), dev),
                         cases=tuple((arch, {}) for arch in MOE_HYBRID_SMOKE))
    k1 = {}
    for name in MOE_HYBRID_NWP:
        k1[name] = nwp_grid_phase(dev, n_rounds=MOE_HYBRID_NWP_ROUNDS,
                                  model_name=name, tag="moe-hybrid")
        torch.cuda.empty_cache()
    return k2, k1


# ---------------------------------------------------------------------------
# Phase 23: the enc-dec and VLM families (slice 10)
# ---------------------------------------------------------------------------
def modal_train(dev) -> None:
    """Phase 23 (c): whisper-base through `launch.train.main` at full width
    and depth (bf16, AdamW with float32 moments), TRAIN_FULL_STEPS steps of
    8 x 128 tokens at TRAIN_FULL_LR, fed zero frames as the reference's
    `launch/train.py` feeds them: losses finite, the first within
    TRAIN_START_TOL of ln V + d_model 0.02^2 / 2; K2 and K3 launch no time.
    Zero frames stay zero through the encoder (a layernorm of zeros is its
    bias, zero at init), so that run cannot show the encoder learning: one
    more `train_step` from fresh weights with standard normal frames and
    the gates set must give some encoder leaf a non-zero gradient."""
    from repro_torch import resolve_device
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import registry
    from repro_torch.models import transformer as T

    arch = MODAL_SERVE[0]
    other = {k: ops.LAUNCHES[k] for k in ("flash_attention", "rwkv6_scan")}
    torch.cuda.empty_cache()
    _reset_peak(dev)
    t0 = time.perf_counter()
    out = train.main(["--arch", arch, "--full-config", "--steps",
                      str(TRAIN_FULL_STEPS), "--batch", "8", "--seq", "128",
                      "--lr", str(TRAIN_FULL_LR)])
    wall = time.perf_counter() - t0
    cfg, losses = out["cfg"], out["losses"]
    start = math.log(cfg.vocab) + cfg.d_model * 0.02 ** 2 / 2
    check(all(math.isfinite(x) for x in losses)
          and abs(losses[0] - start) <= TRAIN_START_TOL,
          f"{arch} full training: losses {losses} (step 0 expected within "
          f"{TRAIN_START_TOL} of {start:.4f})")
    tok_s = [out["tokens_per_step"] / x for x in out["step_s"][1:]]
    print(f"[modal] (c) {arch} full config, {out['n_params']} parameters "
          f"(bf16, AdamW float32 moments, remat {cfg.remat}), "
          f"{TRAIN_FULL_STEPS} steps of 8 x 128 tokens and 8 x "
          f"{cfg.enc_seq} zero frames at lr {TRAIN_FULL_LR:g}: losses "
          f"{[round(x, 4) for x in losses]} (ln V + d 0.02^2 / 2 = "
          f"{start:.4f}; the last below the first: {losses[-1] < losses[0]})"
          f"; s/step {[round(x, 4) for x in out['step_s']]} (step 0 includes "
          f"first-use setup); tokens/s after step 0 "
          f"{[round(x, 1) for x in tok_s]}; peak {_peak_gib(dev):.3f} GiB; "
          f"main() {wall:.2f} s")
    del out
    torch.cuda.empty_cache()

    bundle = registry.build(cfg, lr=TRAIN_FULL_LR)
    params = bundle.init(torch.Generator(resolve_device(dev)).manual_seed(0),
                         device=dev)
    gates = set_gates(params)
    rng = np.random.default_rng(GATE_SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
                 0, cfg.vocab, size=(8, 128))).to(dev),
             "modal_embeds": torch.from_numpy(rng.normal(size=(
                 8, T.modal_len(cfg), cfg.d_model)).astype(np.float32)
                 ).to(dev, cfg.dtype)}
    with torch.enable_grad():
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        total, _ = bundle.loss_fn(leaves, batch, device=dev)
        grads = dict(zip(leaves, torch.autograd.grad(
            total, list(leaves.values()))))
    del leaves, total
    norms = {prefix: math.sqrt(sum(
        float(torch.linalg.vector_norm(g.float())) ** 2
        for k, g in grads.items() if k.startswith(prefix)))
        for prefix in ("enc_layers.", "enc_norm.", "layers.xattn.",
                       "layers.gate", "layers.attn.", "embed.")}
    nonzero = sorted(k for k, g in grads.items()
                     if k.startswith("enc_layers.") and bool(g.any()))
    del grads
    state = {"params": params, "opt": bundle.optimizer.init(params)}
    state, metrics = bundle.train_step(state, batch, device=dev)
    print(f"[modal] (c) one train_step with N(0, 1) frames and gates "
          f"{[v for _, v in gates]}: loss {float(metrics['loss']):.4f}; "
          f"gradient norms by part "
          + ", ".join(f"{k} {v:.4e}" for k, v in norms.items())
          + f"; {len(nonzero)} enc_layers leaves with a non-zero gradient")
    check(math.isfinite(float(metrics["loss"])) and nonzero
          and norms["enc_layers."] > 0,
          f"{arch}: no encoder leaf has a non-zero gradient")
    del state, params, batch
    torch.cuda.empty_cache()
    check(all(ops.LAUNCHES[k] == n for k, n in other.items()),
          f"training launched K2 or K3: {other} -> "
          f"{ {k: ops.LAUNCHES[k] for k in other} }")
    print("[modal] (c) K2 and K3 launched no time in training")


def modal_phase(dev) -> dict:
    """Phase 23: (a) whisper-base served at full width and depth
    (`serve_full` at WHISPER_SHAPE: K2 12 launches a prefill, 6 full in
    the encoder; the gates set; the prefill held to impl="torch" by
    `serve_vs_plain`), one profiled prefill and decode step; (b)
    llama-3.2-vision-90b at full width and VLM_LAYERS layers the same way
    (K2 8 launches, GQA 8 over 64 heads); (c) whisper-base trained
    (`modal_train`); (d) both configs' float32 smoke variants served and
    one `train_step` each, card against the CPU.  Returns K2's launches by
    architecture."""
    from repro_torch.configs import base

    k2 = {}
    for arch in MODAL_SERVE:
        cfg = base.get(arch)
        shape = WHISPER_SHAPE
        if cfg.family == "vlm":
            cfg, shape = dataclasses.replace(cfg, n_layers=VLM_LAYERS), None
        cfg, res, k2[arch] = serve_full(dev, "modal", cfg=cfg, shape=shape)
        profile_serve(cfg, res, "modal", "flash_attention")
        del res
        torch.cuda.empty_cache()
    modal_train(dev)
    for arch in MODAL_SERVE:
        serve_reference(dev, "modal", arch)
    train_step_reference((torch.device("cpu"), dev),
                         cases=tuple((arch, {}) for arch in MODAL_SERVE))
    return k2


# Phase 24: the multi-rank path.  Every rank is a process on the one card;
# NCCL needs a card per rank, so the ranks meet over gloo.
MULTI_RANK_WORLD = 10                   # (a), (b): one rank per client
MULTI_RANK_GRID = ([0, 1, 2, 3], 2)     # (c): a (2, 2) ('grid', 'model') mesh
MULTI_RANK_RESUME = ([0, 1], 2)         # (d): a (1, 2) mesh
MULTI_RANK_MASK = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0, 1], np.float32)
MULTI_RANK_REPEATS = 10                 # timed exchanges per comm
MULTI_RANK_SEED = 24                    # the exchanges' shared uniforms
MULTI_RANK_TOL = 1e-5                   # (a) vs protocols.ra_round_seg
MULTI_RANK_DFL_TOL = 1e-4               # (b) vs the single-process replay
MULTI_RANK_SERVE = [0, 1, 2, 3]         # (e): a 4-rank ('grid',) mesh
MULTI_RANK_ROUTER = ([0, 1, 2, 3], 2)   # (f): 2 replicas on the (2, 2) mesh
MULTI_RANK_TIMEOUT_S = 480.0


def _mr_sync(dev):
    import torch.distributed as dist

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dist.barrier()


def _mr_probe(dev) -> None:
    """Phase 24, first: each collective of `launch.mesh` on this rank's
    tensors (CUDA tensors over gloo on the card) against its values."""
    import torch.distributed as dist
    from repro_torch.launch import mesh

    r, w = dist.get_rank(), dist.get_world_size()
    x = torch.arange(w * 3, dtype=torch.float32, device=dev) + 100 * r
    rows = [torch.arange(3, dtype=torch.float32) + 3 * r + 100 * q
            for q in range(w)]
    got = {"all_to_all": mesh.all_to_all(x),
           "reduce_scatter": mesh.reduce_scatter(x),
           "all_reduce": mesh.all_reduce(torch.full((4,), r + 1.0,
                                                    device=dev)),
           "all_gather": mesh.all_gather(torch.full((2,), float(r),
                                                    device=dev))}
    want = {"all_to_all": torch.cat(rows), "reduce_scatter": sum(rows),
            "all_reduce": torch.full((4,), w * (w + 1) / 2),
            "all_gather": torch.arange(float(w)).repeat_interleave(2)}
    for name, t in got.items():
        check(t.device == x.device and torch.equal(t.cpu(), want[name]),
              f"[multi-rank] rank {r}: {name} on {dev} returned "
              f"{t.cpu().tolist()}, expected {want[name].tolist()}")


def _mr_clients(n, cnn_kwargs=None, hw=(28, 28)):
    """Client m's parameters: `init_cnn` drawn from seed m."""
    from repro_torch.models import smallnets

    return [smallnets.init_cnn(torch.Generator().manual_seed(m),
                               in_hw=tuple(hw), **(cnn_kwargs or {}))
            for m in range(n)]


def _mr_exchange(dev, me, clients, p, rho, u, seg_len) -> dict:
    """Phase 24 (a) on one rank: `ra_exchange` for each comm, without and
    with `MULTI_RANK_MASK`, against the single-process
    `protocols.ra_round_seg` (K1) on the same draws; then each comm timed
    (no mask), barrier to barrier."""
    from repro_torch.core import dfl_step, protocols
    from repro_torch.launch import mesh

    names = sorted(clients[0])
    stacked = {k: torch.stack([c[k] for c in clients]).to(dev) for k in names}
    mine = {k: v.to(dev) for k, v in clients[me].items()}
    mask = torch.from_numpy(MULTI_RANK_MASK).to(dev)
    w_seg, spec, m_params = protocols._to_segments(stacked, seg_len)
    want = {}
    for mname, part in (("none", None), ("mask", mask)):
        out, _e = protocols.ra_round_seg(w_seg, p, rho, 0, part, u=u,
                                         agg_impl="kernel")
        want[mname] = {k: v[me] for k, v in protocols._from_segments(
            out, spec, m_params).items()}
    del stacked, w_seg
    res = {"err": 0.0, "bytes": {}, "secs": {}}
    for comm in dfl_step.COMMS:
        for mname, part in (("none", None), ("mask", mask)):
            mesh.reset_counters()
            got = dfl_step.ra_exchange(mine, p, rho, seg_len=seg_len,
                                       comm=comm, participation=part, u=u)
            err = max(float((got[k] - want[mname][k]).abs().max())
                      for k in names)
            res["err"] = max(res["err"], err)
            check(err <= MULTI_RANK_TOL,
                  f"[multi-rank] rank {me} {comm}/{mname}: max |err| "
                  f"{err:.3e} vs ra_round_seg (tol {MULTI_RANK_TOL:g})")
            if part is not None and MULTI_RANK_MASK[me] == 0:
                check(all(torch.equal(got[k], mine[k]) for k in names),
                      f"[multi-rank] rank {me} {comm}: sampled out, but its "
                      f"parameters changed")
            res["bytes"][comm] = sum(mesh.WIRE_BYTES.values())
        secs = []
        for _ in range(MULTI_RANK_REPEATS):
            _mr_sync(dev)
            t0 = time.perf_counter()
            dfl_step.ra_exchange(mine, p, rho, seg_len=seg_len, comm=comm,
                                 u=u)
            _mr_sync(dev)
            secs.append(time.perf_counter() - t0)
        res["secs"][comm] = statistics.median(secs)
    return res


def _mr_dfl_round(dev, me, clients, data, p, rho, u, seg_len, lr) -> dict:
    """Phase 24 (b) on one rank: one `make_dfl_train_step` round (2
    full-batch GD steps on this rank's shard, the `loss` policy at 0.5),
    against a single-process replay of every client's steps followed by
    `ra_round_seg` under the mask the replay selects."""
    from repro_torch.core import dfl_step, protocols, selection
    from repro_torch.models.smallnets import apply_cnn, ce_loss

    n = len(clients)
    shards = [(torch.from_numpy(data.train_x[m]).to(dev),
               torch.from_numpy(data.train_y[m]).to(dev)) for m in range(n)]

    def local_step(x, y, kept=None):
        def loss_fn(params):
            return ce_loss(apply_cnn(params, x), y)

        def step(state, _batch):
            g, loss = torch.func.grad_and_value(loss_fn)(state["params"])
            params = {k: v - lr * g[k] for k, v in state["params"].items()}
            if kept is not None:
                kept[:] = [params]
            return dict(state, params=params), {"loss": loss.detach()}

        return step

    # The replay first (it also warms cuDNN for the timed round): every
    # client's two steps in this process.
    trained, losses, norms = [], [], []
    for m in range(n):
        step = local_step(*shards[m])
        st = {"params": {k: v.to(dev) for k, v in clients[m].items()}}
        ls = []
        for _ in range(2):
            st, met = step(st, None)
            ls.append(met["loss"])
        trained.append(st["params"])
        losses.append(torch.stack(ls).mean())
        norms.append(torch.sqrt(sum(
            ((st["params"][k] - clients[m][k].to(dev)) ** 2).sum()
            for k in sorted(st["params"]))))
    kept = []
    fn = dfl_step.make_dfl_train_step(
        local_step(*shards[me], kept), p=p, seg_len=seg_len,
        n_local_steps=2, selection_policy="loss", select_frac=0.5)
    start = {k: v.to(dev) for k, v in clients[me].items()}
    _mr_sync(dev)
    t0 = time.perf_counter()
    new, metrics = fn({"params": start}, None, rho, u=u)
    _mr_sync(dev)
    secs = time.perf_counter() - t0

    signals = selection.SelectionSignals(loss=torch.stack(losses),
                                         upd_norm=torch.stack(norms))
    mask = selection.select_clients(
        selection.POLICY_IDS["loss"], torch.ones(n, device=dev), signals,
        p, rho[:n, :n], 0.5)
    names = sorted(clients[0])
    stacked = {k: torch.stack([t[k] for t in trained]) for k in names}
    w_seg, spec, m_params = protocols._to_segments(stacked, seg_len)
    out, _e = protocols.ra_round_seg(w_seg, p, rho, 0, mask, u=u,
                                     agg_impl="kernel")
    want = {k: v[me] for k, v in protocols._from_segments(
        out, spec, m_params).items()}
    gap = max(float((new["params"][k] - want[k]).abs().max()) for k in names)
    check(gap <= MULTI_RANK_DFL_TOL,
          f"[multi-rank] rank {me}: dfl round departs from the replay by "
          f"{gap:.3e} (tol {MULTI_RANK_DFL_TOL:g})")
    kept_own = all(torch.equal(new["params"][k], kept[0][k]) for k in names)
    check(kept_own == (float(mask[me]) == 0.0),
          f"[multi-rank] rank {me}: selected by the replay "
          f"{bool(mask[me])}, but kept its own parameters {kept_own}")
    check(tuple(metrics["loss"].shape) == (2,), "dfl round: 2 loss rows")
    return {"gap": gap, "secs": secs, "mask": mask.cpu().numpy()}


def _mr_grid(dev, data, init, base) -> dict:
    """Phase 24 (c) on one rank: grid12 through `run_grid` over the
    (2, 2) mesh of ranks `MULTI_RANK_GRID` (the other ranks build the
    mesh with them and sit it out)."""
    import warnings

    from repro_torch.fl import scenarios, simulator
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra
    from repro_torch.models import smallnets

    warnings.filterwarnings("ignore",
                            category=simulator.PacketLengthMismatchWarning)
    grid12 = grid12_grid()
    _reset_k1_counts()
    _reset_peak(dev)
    _mr_sync(dev)
    t0 = time.perf_counter()
    res = scenarios.run_grid(init, smallnets.apply_cnn, data, grid12,
                             base, device=dev, devices=MULTI_RANK_GRID)
    _mr_sync(dev)
    out = {"secs": time.perf_counter() - t0, "peak_gib": _peak_gib(dev),
           "k1": ops.LAUNCHES["ra_aggregate"],
           "k1_by_shape": dict(_ra.SHAPE_LAUNCHES)}
    if res is not None:
        out["result"] = (res.labels, res.acc, res.loss, res.bias)
    return out


def _mr_resumable(dev, data, init, net, base, ckpt_dir) -> dict | None:
    """Phase 24 (d) on one rank: the slice's R&A scenario through
    `run_resumable` on the (1, 2) mesh of ranks `MULTI_RANK_RESUME`,
    unbroken and stopped after one chunk then resumed; a third run stops
    after one chunk, for the parent to finish in one process."""
    import os

    from repro_torch.checkpoint import checkpoint
    from repro_torch.fl import simulator
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra
    from repro_torch.launch import mesh
    from repro_torch.models import smallnets

    ranks, dm = MULTI_RANK_RESUME
    pair = mesh.grid_model_mesh(ranks, model_shards=dm, device=dev)
    if pair.coords is None:
        return None
    sim = simulator.build_sim(
        init, smallnets.apply_cnn, data, seg_len=base.seg_len,
        local_epochs=base.local_epochs, n_rounds=base.n_rounds,
        device=dev, model_shards=dm, mesh=pair)
    sc = simulator.make_scenario(net, dataclasses.replace(
        base, protocol="ra", mode="ra_normalized"))
    _reset_k1_counts()
    t0 = time.perf_counter()
    unbroken = checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "unbroken"), mesh=pair)
    stopped = checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "resumed"),
        stop_after=1, mesh=pair)
    resumed = checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "resumed"), mesh=pair)
    checkpoint.run_resumable(
        sim, sc, ckpt_dir=os.path.join(ckpt_dir, "to_single"),
        stop_after=1, mesh=pair)
    secs = time.perf_counter() - t0
    check(stopped is None, "run_resumable(stop_after=1) finished the run")
    loss_gap = float(np.abs(resumed["loss"] - unbroken["loss"]).max())
    acc_gap = float(np.abs(resumed["acc"] - unbroken["acc"]).max())
    test_n = len(data.test_y)
    check(loss_gap <= GRID_LOSS_TOL and acc_gap <= 1.0 / test_n + 1e-6,
          f"[multi-rank] rank {pair.rank}: resumed run departs from the "
          f"unbroken one: loss {loss_gap:.3e}, accuracy {acc_gap:.4f}")
    return {"unbroken": unbroken, "loss_gap": loss_gap, "acc_gap": acc_gap,
            "secs": secs, "k1": ops.LAUNCHES["ra_aggregate"],
            "k1_by_shape": dict(_ra.SHAPE_LAUNCHES),
            "l_local": sim.local_segments}


# The discrete ids that split a dispatch into groups of one program each
# (grid12's scenarios differ only in the protocol and the mode).
_MR_GROUP_IDS = ("protocol_id", "mode_id", "aggregator", "codec_id",
                 "policy_id")


def _mr_expected_k1(runner, ran, mesh, base, segments) -> dict:
    """Each rank of ``mesh``'s K1 launches by (B, N, L, K) for the
    dispatches ``ran`` ((grid, pad_to) each), by this script's own rule:
    a dispatch splits into one group per distinct `_MR_GROUP_IDS`, a
    group of g scenarios pads to the smallest bucket >= g, and a group
    padded to G rows spans d = min(G, grid rows) grid rows of G / d
    scenarios each, whose every model shard launches once a round (J for
    AaYG) on its window.  The group count is checked against the
    runner's own partition."""
    from repro_torch.core import protocols

    rows, dm = mesh.ranks.shape if mesh.ranks.ndim == 2 else (
        mesh.ranks.size, 1)
    l_local = -(-segments // dm)
    n = runner.sim.n_clients
    out = {int(r): {} for r in mesh.ranks.flat}
    for grid, pad in ran:
        groups = {}
        for i in range(len(grid)):
            sc = grid.scenario(i)
            groups.setdefault(tuple(getattr(sc, f) for f in _MR_GROUP_IDS),
                              []).append(sc.protocol_id)
        check(len(groups) == len(runner._index_groups(grid)),
              f"[multi-rank] a dispatch of {grid.labels} forms "
              f"{len(groups)} groups by its ids, the runner "
              f"{len(runner._index_groups(grid))}")
        buckets = sorted((pad,) if isinstance(pad, int) else pad)
        for members in groups.values():
            fits = [b for b in buckets if b >= len(members)]
            check(bool(fits), f"[multi-rank] a group of {len(members)} "
                  f"fits no bucket of {buckets}")
            g = fits[0]
            per_round = {protocols.PROTOCOL_IDS["ra"]: 1,
                         protocols.PROTOCOL_IDS["aayg"]: base.aayg_mixes}.get(
                             members[0], 0)
            d = min(g, rows)
            key = (-(-g // d), n, l_local, base.seg_len)
            for r in mesh.ranks.reshape(rows, dm)[:d].flat:
                counts = out[int(r)]
                counts[key] = counts.get(key, 0) + per_round * base.n_rounds
    return out


def _mr_serve_setup(dev):
    """(e) and (f)'s serving config and requests; puts tests/ on the path
    for their fault helpers (`tests/_torch_serving_faults.py`)."""
    import warnings

    from repro_torch.fl import simulator
    from repro_torch.launch import serving

    sys.path.insert(0, str(ROOT / "tests"))
    warnings.filterwarnings("ignore",
                            category=simulator.PacketLengthMismatchWarning)
    serve_cfg = serving.ServeConfig(max_batch=SERVE_TIER_BATCH,
                                    batch_buckets=(SERVE_TIER_BATCH,),
                                    max_delay_s=SERVE_TIER_DELAY_S,
                                    strict_packet_check=False)
    grid12 = grid12_grid()
    return serve_cfg, [grid12.take([i]) for i in range(len(grid12))]


def _mr_submit_all(target, requests):
    return [target.submit(r, priority=int(i % 4 == 0), tenant=f"tenant{i % 2}")
            for i, r in enumerate(requests)]


def _mr_serve(dev, data, init, base, segments) -> dict:
    """Phase 24 (e) on one rank: phase 17's traffic through a server over
    the 4-rank ('grid',) mesh `MULTI_RANK_SERVE` (every rank builds it;
    rank 0 leads, ranks 1-3 follow, the others idle)."""
    serve_cfg, requests = _mr_serve_setup(dev)
    from _torch_serving_faults import install
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra
    from repro_torch.launch import serving
    from repro_torch.models import smallnets

    server = serving.ScenarioServer(init, smallnets.apply_cnn, data, base,
                                    serve=serve_cfg, device=dev,
                                    devices=MULTI_RANK_SERVE)
    _reset_k1_counts()
    _reset_peak(dev)
    _mr_sync(dev)
    built = server.warmup(grid12_grid(), *requests)
    probe = install(server) if server.is_leader else None
    out = {"role": server.role}
    t0 = time.perf_counter()
    server.start()
    if server.is_leader:
        futures = _mr_submit_all(server, requests)
        out["results"] = [f.result(timeout=SERVE_TIER_WAIT_S)
                          for f in futures]
        out["secs"] = time.perf_counter() - t0
    server.stop()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out.update(k1=ops.LAUNCHES["ra_aggregate"],
               k1_by_shape=dict(_ra.SHAPE_LAUNCHES), peak_gib=_peak_gib(dev),
               released_at=server.released_at)
    if server.is_leader:
        snap = server.tracker.snapshot()
        out.update(
            built=built, dispatches=[len(g) for g, _ in probe.ran],
            expected=_mr_expected_k1(server.runner, probe.ran, server.mesh,
                                     base, segments),
            stats={k: snap[k] for k in (
                "serve/latency_s_p50", "serve/latency_s_p99",
                "serve/coalesced_scenarios_mean", "grid/batch_fill_mean")})
    return out


def _mr_router(dev, data, init, base, segments) -> dict:
    """Phase 24 (f) on one rank: phase 17 (b)'s router, its two replicas
    over the (2, 2) mesh `MULTI_RANK_ROUTER`; on the leader the owner of
    grid12's first family holds a dispatch and is killed after the first
    delivery."""
    import threading

    serve_cfg, requests = _mr_serve_setup(dev)
    from _torch_serving_faults import install, kill_replica
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra
    from repro_torch.launch import router
    from repro_torch.models import smallnets

    rt = router.ScenarioRouter.in_process(
        init, smallnets.apply_cnn, data, base, n_replicas=2,
        serve=serve_cfg, device=dev, devices=MULTI_RANK_ROUTER,
        route=router.RouterConfig(max_attempts=4, backoff_base_s=0.01,
                                  breaker_cooldown_s=0.3, heartbeat_s=0.05,
                                  attempt_timeout_s=SERVE_TIER_WAIT_S))
    out = {"kind": type(rt).__name__}
    leader = isinstance(rt, router.ScenarioRouter)
    if leader:
        victim = rt._ring.preference(router.grid_signature(requests[0]))[0]
        owned = sum(rt._ring.preference(router.grid_signature(r))[0]
                    == victim for r in requests)
        # More than one batch of the victim's requests: hold its second
        # dispatch; else its first, and the other replica delivers first.
        hold_at = 1 if owned > SERVE_TIER_BATCH else 0
        release = threading.Event()
        probes = {name: install(rep.server, **({} if name != victim else dict(
            stall_on={hold_at: release},
            raise_on={hold_at: RuntimeError(f"{name} killed")})))
            for name, rep in rt.replicas.items()}
    built = rt.warmup(requests, fanout=2)
    _reset_k1_counts()
    _reset_peak(dev)
    _mr_sync(dev)
    t0 = time.perf_counter()
    if not leader:
        with rt:
            pass                      # until the leader releases both
    else:
        delivered = threading.Event()
        try:
            rt.start()
            futures = _mr_submit_all(rt, requests)
            for f in futures:
                f.add_done_callback(lambda _f: delivered.set())
            check(delivered.wait(SERVE_TIER_WAIT_S)
                  and probes[victim].stalled.wait(SERVE_TIER_WAIT_S),
                  "[multi-rank] (f) no first delivery, or the victim never "
                  "held its dispatch")
            first_done = sum(f.done() for f in futures)
            kill_replica(rt.replicas[victim], release)
            out["results"] = [f.result(timeout=SERVE_TIER_WAIT_S)
                              for f in futures]
            out["secs"] = time.perf_counter() - t0
            out["stopping_at"] = time.time()
        finally:
            release.set()
            rt.stop(drain=False)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    out.update(k1=ops.LAUNCHES["ra_aggregate"],
               k1_by_shape=dict(_ra.SHAPE_LAUNCHES), peak_gib=_peak_gib(dev),
               released_at={n: r.server.released_at
                            for n, r in rt.replicas.items()})
    if leader:
        snap = rt.tracker.snapshot()
        ran = [x for p in probes.values() for x in p.ran]
        out.update(
            built=built, victim=victim, owned=owned, hold_at=hold_at,
            first_done=first_done,
            dispatches={n: [len(g) for g, _ in p.ran]
                        for n, p in probes.items()},
            expected=_mr_expected_k1(rt.replicas[victim].server.runner, ran,
                                     rt.replicas[victim].server.mesh, base,
                                     segments),
            served=sum(snap.get(f"router/replica/{n}/served", 0)
                       for n in probes),
            counters={k.removeprefix("router/"): snap[k] for k in sorted(snap)
                      if k.startswith("router/") and not k.startswith(
                          "router/latency") and "/healthy" not in k},
            stats={k: snap[k] for k in ("router/latency_s_p50",
                                        "router/latency_s_p99")})
    return out


def multi_rank_rank(rank: int, ckpt_dir: str, samples_per_client=600,
                    hw=(28, 28), cnn_kwargs=None) -> dict:
    """Phase 24's body in each of the `MULTI_RANK_WORLD` ranks (spawned by
    `launch.mesh.spawn`): the collectives' probe, then (a)-(f)."""
    from repro_torch.core import routing
    from repro_torch.launch import mesh

    dev = mesh.rank_device()
    marks = [("start", time.perf_counter())]
    data, net, init, base = slice_inputs(samples_per_client, hw, cnn_kwargs)
    n = data.n_clients
    _mr_probe(dev)
    marks.append(("setup+probe", time.perf_counter()))
    clients = _mr_clients(n, cnn_kwargs, hw)
    p = torch.tensor(data.weights(), dtype=torch.float32, device=dev)
    rho = routing.e2e_success(net.link_eps)[0].to(dev)
    m_params = sum(v.numel() for v in clients[0].values())
    l = -(-m_params // base.seg_len)
    u = torch.rand((n, n, l), generator=torch.Generator().manual_seed(
        MULTI_RANK_SEED)).to(dev)
    out = {"params": m_params, "segments": l}
    out["exchange"] = _mr_exchange(dev, rank, clients, p, rho, u,
                                   base.seg_len)
    marks.append(("a", time.perf_counter()))
    out["dfl"] = _mr_dfl_round(dev, rank, clients, data, p, rho, u,
                               base.seg_len, base.lr)
    marks.append(("b", time.perf_counter()))
    del clients
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["grid"] = _mr_grid(dev, data, init, base)
    marks.append(("c", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["resumable"] = _mr_resumable(dev, data, init, net, base, ckpt_dir)
    marks.append(("d", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["serve"] = _mr_serve(dev, data, init, base, l)
    marks.append(("e", time.perf_counter()))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["router"] = _mr_router(dev, data, init, base, l)
    marks.append(("f", time.perf_counter()))
    out["part_secs"] = {name: round(t - marks[i][1], 3)
                        for i, (name, t) in enumerate(marks[1:])}
    return out


def multi_rank_phase(dev, seq12, *, world=MULTI_RANK_WORLD,
                     samples_per_client=600, hw=(28, 28),
                     cnn_kwargs=None) -> dict:
    """Phase 24: the multi-rank path over ``world`` ranks sharing ``dev``
    (gloo), held to the single-process runs: (a) `ra_exchange`, (b) one
    `make_dfl_train_step` round, (c) grid12 over a (2, 2) mesh against
    phase 16's ``seq12``, (d) `run_resumable` on a (1, 2) mesh, its
    one-chunk checkpoint finished here in one process.  Returns K1's
    launches by path."""
    import os
    import tempfile

    from repro_torch.checkpoint import checkpoint
    from repro_torch.fl import simulator
    from repro_torch.launch import mesh
    from repro_torch.models import smallnets

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = mesh.spawn(
            multi_rank_rank, world, backend="gloo", device=dev.type,
            args=(d, samples_per_client, hw, cnn_kwargs),
            timeout=MULTI_RANK_TIMEOUT_S,
            threads=1 if dev.type == "cpu" else None)
        spawn_secs = time.perf_counter() - t0
        data, net, init, base = slice_inputs(samples_per_client, hw,
                                             cnn_kwargs)
        single = simulator.build_sim(
            init, smallnets.apply_cnn, data, seg_len=base.seg_len,
            local_epochs=base.local_epochs, n_rounds=base.n_rounds,
            device=dev)
        sc = simulator.make_scenario(net, dataclasses.replace(
            base, protocol="ra", mode="ra_normalized"))
        finished = checkpoint.run_resumable(
            single, sc, ckpt_dir=os.path.join(d, "to_single"))
    print(f"[multi-rank] {world} ranks on {dev} over gloo (launch.mesh."
          f"spawn); every collective on {dev.type} tensors checked; "
          f"spawn + all four parts {spawn_secs:.2f} s; rank 0's parts "
          f"{ranks[0]['part_secs']} s")
    test_n = len(data.test_y)
    r0 = ranks[0]

    # (a)
    ex = [r["exchange"] for r in ranks]
    print(f"[multi-rank] (a) ra_exchange: {r0['params']} params, "
          f"{r0['segments']} segments of {base.seg_len}; max |err| vs "
          f"protocols.ra_round_seg (K1) {max(e['err'] for e in ex):.3e} "
          f"(tol {MULTI_RANK_TOL:g}); mask {MULTI_RANK_MASK.astype(int).tolist()}"
          f": sampled-out ranks bit-equal")
    for comm, secs in ex[0]["secs"].items():
        print(f"[multi-rank] (a) {comm:14s} {secs * 1e3:.3f} ms an exchange "
              f"(median of {MULTI_RANK_REPEATS}, barrier to barrier), "
              f"{ex[0]['bytes'][comm]} B handed to collectives per rank; "
              f"launch.mesh stages none (gloo copies CUDA operands through "
              f"host memory itself)")
    # (b)
    masks = {tuple(r["dfl"]["mask"].tolist()) for r in ranks}
    check(len(masks) == 1, f"[multi-rank] (b) replays select {masks}")
    print(f"[multi-rank] (b) make_dfl_train_step: 2 local steps, loss "
          f"policy at 0.5 selected {[int(x) for x in next(iter(masks))]}; "
          f"max |gap| vs the single-process replay "
          f"{max(r['dfl']['gap'] for r in ranks):.3e} (tol "
          f"{MULTI_RANK_DFL_TOL:g}); round {r0['dfl']['secs']:.4f} s")
    # (c)
    grid_ranks, dm = MULTI_RANK_GRID
    k1_paths = {}
    for r in grid_ranks:
        g = ranks[r]["grid"]
        labels, acc, loss, bias = g["result"]
        check(list(labels) == list(seq12.labels),
              f"[multi-rank] rank {r}: grid labels {labels}")
        loss_gap = float(np.abs(loss - seq12.loss).max())
        acc_gap = float(np.abs(acc - seq12.acc).max())
        check(loss_gap <= GRID_LOSS_TOL and acc_gap <= 1.0 / test_n + 1e-6,
              f"[multi-rank] rank {r}: grid12 over the mesh departs from "
              f"the single-process run: loss {loss_gap:.3e}, accuracy "
              f"{acc_gap:.4f}")
        if dev.type == "cuda":
            want = {(2, 10, -(-r0["segments"] // dm), base.seg_len):
                    3 * base.n_rounds}
            check(g["k1_by_shape"] == want,
                  f"[multi-rank] rank {r}: K1 launches by shape "
                  f"{g['k1_by_shape']}, expected {want} (each shard on its "
                  f"window, B = 2 a group)")
        print(f"[multi-rank] (c) rank {r} (grid {r // dm}, model {r % dm}):"
              f" grid12 {g['secs']:.3f} s, peak {g['peak_gib']:.3f} GiB, K1 "
              f"{g['k1']} by (B, N, L_local, K) "
              f"{ {str(k): v for k, v in g['k1_by_shape'].items()} }; max "
              f"|loss gap| {loss_gap:.3e}, acc gap {acc_gap:.4f} vs phase "
              f"16's run_sequential")
    for r in range(len(grid_ranks), world):
        check("result" not in ranks[r]["grid"] and ranks[r]["grid"]["k1"] == 0,
              f"[multi-rank] rank {r} is outside the grid's mesh but ran it")
    k1_paths["multi-rank:grid12"] = sum(ranks[r]["grid"]["k1"]
                                        for r in grid_ranks)
    # (d)
    pair, dm = MULTI_RANK_RESUME
    rs = [ranks[r]["resumable"] for r in pair]
    check(all(x is not None for x in rs)
          and all(ranks[r]["resumable"] is None
                  for r in range(len(pair), world)),
          "[multi-rank] (d) ran on other ranks than its mesh's")
    unbroken = rs[0]["unbroken"]
    loss_gap = float(np.abs(finished["loss"] - unbroken["loss"]).max())
    acc_gap = float(np.abs(finished["acc"] - unbroken["acc"]).max())
    check(loss_gap <= GRID_LOSS_TOL and acc_gap <= 1.0 / test_n + 1e-6,
          f"[multi-rank] (d) the ranks' checkpoint finished in one process "
          f"departs: loss {loss_gap:.3e}, accuracy {acc_gap:.4f}")
    if dev.type == "cuda":
        # unbroken n rounds, stopped after 1, resumed for n - 1, stopped
        # after 1: one launch a round.
        want = {(1, 10, rs[0]["l_local"], base.seg_len):
                2 * base.n_rounds + 1}
        got = [x["k1_by_shape"] for x in rs]
        check(all(g == want for g in got),
              f"[multi-rank] (d) K1 launches by shape {got}, expected {want}")
    k1_paths["multi-rank:resumable"] = sum(x["k1"] for x in rs)
    print(f"[multi-rank] (d) run_resumable on a (1, {dm}) mesh: "
          f"{rs[0]['secs']:.3f} s for 4 runs; resumed vs unbroken max |loss "
          f"gap| {max(x['loss_gap'] for x in rs):.3e}, acc gap "
          f"{max(x['acc_gap'] for x in rs):.4f}; the ranks' one-chunk "
          f"checkpoint finished in one process: loss gap {loss_gap:.3e}, "
          f"acc gap {acc_gap:.4f}; K1 "
          f"{[{str(k): v for k, v in x['k1_by_shape'].items()} for x in rs]}")
    # (e) and (f)
    for part, tag in (("serve", "multi-rank:serve"),
                      ("router", "multi-rank:router")):
        k1_paths[tag] = _mr_serving_checks(dev, ranks, part, seq12, test_n)
    print(f"[multi-rank] phase 24 took {time.perf_counter() - t_phase:.2f} s")
    shapes = {k for r in ranks for part in ("grid", "resumable", "serve",
                                            "router")
              if r[part] for k in r[part]["k1_by_shape"]}
    return k1_paths, shapes


def _mr_serving_checks(dev, ranks, part, seq12, test_n) -> int:
    """Phase 24 (e) / (f) in the parent: the leader's rows against phase
    16's ``seq12``, every rank's K1 launches against the leader's dispatch
    log, the router's deliveries and its followers' release; prints the
    `[multi-rank-serve]` line.  Returns the ranks' K1 launches."""
    lead = ranks[0][part]
    labels = [r.labels[0] for r in lead["results"]]
    loss_gap, acc_gap = _hold_to_sequential(f"[multi-rank] ({part})", labels,
                                            lead["results"], seq12, test_n)
    for r, out in enumerate(ranks):
        want = {str(k): v for k, v in lead["expected"].get(r, {}).items()}
        got = {str(k): v for k, v in out[part]["k1_by_shape"].items()}
        if dev.type == "cuda":
            check(got == want,
                  f"[multi-rank] ({part}) rank {r}: K1 launches by (B, N, L, "
                  f"K) {got}, the leader's dispatch log gives {want}")
    mesh_ranks = sorted(lead["expected"])
    if part == "serve":
        followers = [ranks[r][part]["released_at"] for r in mesh_ranks[1:]]
        check(all(t is not None for t in followers),
              "[multi-rank] (serve) a follower never received the stop")
        extra = (f"dispatches {lead['dispatches']}; mean coalesced "
                 f"{lead['stats']['serve/coalesced_scenarios_mean']:.3f}, "
                 f"batch fill {lead['stats']['grid/batch_fill_mean']:.3f}; "
                 f"latency p50 {lead['stats']['serve/latency_s_p50']:.4f} s "
                 f"p99 {lead['stats']['serve/latency_s_p99']:.4f} s")
    else:
        c = lead["counters"]
        check(c.get("requests") == 12 and lead["served"] == 12
              and c.get("retries", 0) >= 1,
              f"[multi-rank] (router) requests {c.get('requests')}, served "
              f"{lead['served']}, retries {c.get('retries', 0)}")
        victim = lead["victim"]
        survivor = next(n for n in lead["released_at"] if n != victim)
        for r in mesh_ranks[1:]:
            rel = ranks[r][part]["released_at"]
            check(rel[victim] is not None and rel[survivor] is not None
                  and rel[victim] < min(rel[survivor], lead["stopping_at"]),
                  f"[multi-rank] (router) rank {r}: the killed {victim}'s "
                  f"followers left their loop at {rel[victim]}, the "
                  f"survivor's at {rel[survivor]}, the router's stop began "
                  f"at {lead['stopping_at']}")
        extra = (f"killed {victim} (owner of {lead['owned']} of 12, held its "
                 f"dispatch {lead['hold_at']}) after {lead['first_done']} "
                 f"deliveries, its followers left their loop before the "
                 f"router's stop; dispatches {lead['dispatches']}; attempts "
                 f"{c.get('attempts', 0)}, retries {c.get('retries', 0)}, "
                 f"breaker opens {c.get('breaker_opens', 0)}; latency p50 "
                 f"{lead['stats']['router/latency_s_p50']:.4f} s p99 "
                 f"{lead['stats']['router/latency_s_p99']:.4f} s")
    launches = sum(out[part]["k1"] for out in ranks)
    peaks = [round(ranks[r][part]["peak_gib"], 3) for r in mesh_ranks]
    print(f"[multi-rank-serve] ({'e' if part == 'serve' else 'f'}) {part}: "
          f"{len(labels)} requests, {lead['built']} program(s) built by the "
          f"leader's warmup; {lead['secs']:.4f} s, "
          f"{len(labels) / lead['secs']:.3f} req/s; {extra}; peak device "
          f"memory a rank {peaks} GiB; K1 {launches} launches on ranks "
          f"{mesh_ranks}, each rank's by (B, N, L, K) "
          f"{ {str(k): v for k, v in ranks[0][part]['k1_by_shape'].items()} }"
          f" as the dispatch log gives; max |loss gap| {loss_gap:.3e}, max "
          f"acc gap {acc_gap:.4f} vs run_sequential")
    return launches

# ---------------------------------------------------------------------------
# Phase 25: the dry run (slice 13)
# ---------------------------------------------------------------------------
def start_dryrun(out_dir: str) -> subprocess.Popen:
    """Phase 25 (b), started: the CPU dry run of `DRYRUN_ARGS` in a
    subprocess (one thread), which runs beside the card phases."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *DRYRUN_ARGS,
         "--out", out_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def card_constants_check(dev) -> None:
    """Phase 25 (a): the card is the H100 SXM 80GB (HBM3) whose published
    figures `launch.mesh`'s roofline constants are."""
    from repro_torch.launch import mesh

    name, limit, max_limit = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,power.max_limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].split(", ")
    props = torch.cuda.get_device_properties(dev)
    gib = props.total_memory / 2**30
    check("H100" in name and "HBM3" in name
          and props.multi_processor_count == H100_SXM_SMS and gib > 75,
          f"the card {name} ({props.multi_processor_count} SMs, {gib:.1f} "
          f"GiB) is not the H100 SXM 80GB the roofline constants describe")
    print(f"[dryrun] (a) {name}, power limit {limit} (max {max_limit}), "
          f"{props.multi_processor_count} SMs, {gib:.1f} GiB: the H100 SXM "
          f"80GB of launch.mesh's constants (NVIDIA's published figures, "
          f"not measured): PEAK_FLOPS_BF16 {mesh.PEAK_FLOPS_BF16:.4g} "
          f"FLOP/s, HBM_BW {mesh.HBM_BW:.4g} B/s, LINK_BW {mesh.LINK_BW:.4g} "
          f"B/s, NVLINK_BW {mesh.NVLINK_BW:.4g} B/s")


def dryrun_phase(dev, proc: subprocess.Popen, out_dir: str,
                 started: float) -> None:
    """Phase 25: (a) `card_constants_check`; (b) the dry run's subprocess
    must exit 0 with its combination ok; its roofline terms are printed as
    the estimates they are; (c) the whole-step MFU readings of phases 13
    and 19 (`WHOLE_STEP`), which gate nothing."""
    from repro_torch.launch import dryrun, mesh

    card_constants_check(dev)
    waiting = time.perf_counter()
    try:
        log, _ = proc.communicate(timeout=max(
            1.0, DRYRUN_TIMEOUT_S - (time.perf_counter() - started)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        check(False, f"[dryrun] {' '.join(DRYRUN_ARGS)} did not finish in "
              f"{DRYRUN_TIMEOUT_S} s")
    ran, waited = (time.perf_counter() - started,
                   time.perf_counter() - waiting)
    tail = "\n".join(line for line in log.splitlines()
                     if "W1018" not in line and "Warning" not in line)[-2000:]
    check(proc.returncode == 0 and "done: 1/1 ok" in log,
          f"[dryrun] {' '.join(DRYRUN_ARGS)} exited {proc.returncode}:\n"
          f"{tail}")
    (path,) = Path(out_dir).glob("*.json")
    res = json.loads(path.read_text())
    check(res["ok"] and res["useful_flops_ratio"] > 0,
          f"[dryrun] {path.name}: {res}")
    print(f"[dryrun] (b) {path.stem} on this machine's CPU (torch "
          f"{torch.__version__}), started {ran:.1f} s before, waited for "
          f"{waited:.1f} s: trace {res['compile_s']} s, extrapolation "
          f"{res['cost_extrapolation_s']} s; dry-run estimates per device "
          f"with the H100 SXM constants, not measurements: compute "
          f"{1e3 * res['compute_term_s']:.3f} ms, memory "
          f"{1e3 * res['memory_term_s']:.3f} ms, collective "
          f"{1e3 * res['collective_term_s']:.3f} ms (dominant "
          f"{res['dominant']}), useful FLOPs ratio "
          f"{res['useful_flops_ratio']:.4f}, collectives "
          f"{ {k: f'{v:.4g}' for k, v in res['collectives'].items()} } B, "
          f"replicated ops {res['replicated_ops']}")
    for what, train in (("prefill", False), ("train", True)):
        cfg, tokens, secs = WHOLE_STEP[what]
        flops = dryrun.model_flops(cfg, tokens, train=train)
        print(f"[dryrun] (c) mfu {cfg.name} {what}: model_flops "
              f"{flops:.4g} over {tokens} tokens in {secs:.4f} s = "
              f"{flops / secs / 1e12:.2f} TFLOP/s, "
              f"{100 * flops / (secs * mesh.PEAK_FLOPS_BF16):.2f} % of "
              f"PEAK_FLOPS_BF16 (a reading; it gates nothing)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 1
    if "REPRO_AGG_IMPL" in os.environ:
        # impl=None reads it (core.aggregation.default_impl): unset, no
        # setting can take K1 off a path this script checks.
        print("chip_smoke: unset REPRO_AGG_IMPL (it would choose the "
              "aggregation substrate of every impl=None call)",
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
    dry_dir = tempfile.mkdtemp(prefix="chip-smoke-dryrun-")
    dry_proc, dry_started = start_dryrun(dry_dir), time.perf_counter()
    atexit.register(lambda: (dry_proc.poll() is None and dry_proc.kill(),
                             shutil.rmtree(dry_dir, ignore_errors=True)))

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

    # 7. slice-codec (the main path of slice 4)
    codec_launches, tx_launches, (qsim, qsc) = slice_codec(
        dev, torch.cuda.synchronize)
    profile_codec_round(qsim, qsc)
    del qsim, qsc
    torch.cuda.empty_cache()

    # 8. k3
    k3_rows = k3_checks(dev, timer)
    torch.cuda.synchronize()

    # 9. serve (the second main path)
    serve_cfg, res, k3_launches = serve_full(dev, "serve")

    # 10. serve-reference
    serve_reference(dev, "serve")

    # 11. serve-profile
    profile_serve(serve_cfg, res, "serve", "rwkv6_scan")
    del res
    torch.cuda.empty_cache()

    # 12. k2
    k2_rows = k2_checks(dev, timer)
    torch.cuda.synchronize()

    # 13. dense-serve (the third main path)
    dense_cfg, res, k2_launches = serve_full(dev, "dense-serve")
    WHOLE_STEP["prefill"] = (dense_cfg, SERVE_SHAPE["batch"]
                             * SERVE_SHAPE["prompt_len"], res.prefill_s)

    # 14. dense-serve-reference
    serve_reference(dev, "dense-serve")

    # 15. dense-serve-profile
    profile_serve(dense_cfg, res, "dense-serve", "flash_attention")
    del res
    torch.cuda.empty_cache()

    # 16. grid (the scenario-grid engine)
    grid_launches, grid_tx, grid_batches, runner, grid12, seq12 = grid_phase(
        dev, torch.cuda.synchronize)
    profile_grid_round(runner, grid12)

    # 17. serve-tier (the serving tier, the router, checkpointing)
    tier_launches = serve_tier_phase(dev, torch.cuda.synchronize, runner,
                                     grid12, seq12)
    del runner
    torch.cuda.empty_cache()

    # 18. paper-tasks (the paper's ResNet and CharRNN tasks, the NWP grid)
    t0 = time.perf_counter()
    paper_tasks_reference((torch.device("cpu"), dev))
    k1_seen = set()
    with _k1_shapes(k1_seen):
        paper_launches = paper_tasks_phase(dev)
        nwp_launches = nwp_grid_phase(dev)
    torch.cuda.empty_cache()
    print(f"[paper-tasks] phase 18 took {time.perf_counter() - t0:.2f} s")

    # 19. train (launch.train: full-width qwen2.5-3b, the --dfl loop)
    t0 = time.perf_counter()
    with _k1_shapes(k1_seen):
        train_launches = train_phase(dev)
    print(f"[train] phase 19 took {time.perf_counter() - t0:.2f} s")
    checked = {(s["b"] or 1, s["n"], s["l"], s["k"]) for _, s in K1_SHAPES}
    unchecked = sorted(str(x) for x in k1_seen
                       if x[0] not in checked
                       or x[1] not in (torch.float32, torch.bfloat16))
    check(not unchecked, f"phases 18-19 launched K1 at {unchecked}, which "
          f"phase 3 does not hold to the plain version (K1_SHAPES)")
    print(f"[k1] phases 18-19 launched K1 at {len(k1_seen)} shape(s), each "
          f"held to its plain version in phase 3: "
          f"{sorted((shape, str(dt)[6:]) for shape, dt in k1_seen)}")

    # 20. dense-zoo (llama3-8b, starcoder2-3b, gemma-7b served at full width)
    t0 = time.perf_counter()
    zoo_launches = dense_zoo_phase(dev)
    print(f"[dense-zoo] phase 20 took {time.perf_counter() - t0:.2f} s")

    # 21. window (windowed prefill, the wrapped cache, long_500k, training)
    t0 = time.perf_counter()
    window_launches = window_phase(dev)
    print(f"[window] phase 21 took {time.perf_counter() - t0:.2f} s")

    # 22. moe-hybrid (granite-moe-1b-a400m, hymba-1.5b, dbrx-132b's smoke)
    t0 = time.perf_counter()
    with _k1_shapes(k1_seen):
        mh_k2, mh_k1 = moe_hybrid_phase(dev)
    print(f"[moe-hybrid] phase 22 took {time.perf_counter() - t0:.2f} s")
    checked = {(s["b"] or 1, s["n"], s["l"], s["k"]) for _, s in K1_SHAPES}
    unchecked = sorted(str(x) for x in k1_seen
                       if x[0] not in checked
                       or x[1] not in (torch.float32, torch.bfloat16))
    check(not unchecked, f"phase 22 launched K1 at {unchecked}, which "
          f"phase 3 does not hold to the plain version (K1_SHAPES)")

    # 23. modal (whisper-base, llama-3.2-vision-90b at 10 layers)
    t0 = time.perf_counter()
    modal_k2 = modal_phase(dev)
    print(f"[modal] phase 23 took {time.perf_counter() - t0:.2f} s")

    # 24. multi-rank (core.dfl_step, the ('grid', 'model') mesh, model
    # shards in build_sim / run_grid / run_resumable), ranks over gloo
    torch.cuda.empty_cache()
    mr_k1, mr_shapes = multi_rank_phase(dev, seq12)
    unchecked = sorted(str(x) for x in mr_shapes if x not in checked)
    check(not unchecked, f"phase 24 launched K1 at {unchecked}, which "
          f"phase 3 does not hold to the plain version (K1_SHAPES)")

    # 25. dryrun (the card vs the roofline constants, the CPU dry run, MFU)
    dryrun_phase(dev, dry_proc, dry_dir, dry_started)

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
        "launches": (launches + codec_launches + grid_launches
                     + sum(tier_launches.values()) + paper_launches
                     + nwp_launches + train_launches
                     + sum(mh_k1.values()) + sum(mr_k1.values())),
        "launches_by_path": {"slice": launches,
                             "slice-codec": codec_launches,
                             "grid": grid_launches, **tier_launches,
                             "paper-tasks": paper_launches,
                             "nwp-grid": nwp_launches,
                             "train": train_launches,
                             **{f"moe-hybrid:{m}": n
                                for m, n in mh_k1.items()},
                             **mr_k1},
        "tx_launches": tx_launches + grid_tx,
        "grid_launches_by_batch": {str(b): c for b, c in
                                   grid_batches.items()},
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
    check(all(math.isfinite(r["ms_cold"]) for r in k2_rows
              if r["case"] in K2_TIMED), "non-finite K2 time")
    k2_paths = {"dense-serve": k2_launches,
                **{f"dense-zoo:{a}": n for a, n in zoo_launches.items()},
                "window": window_launches,
                **{f"moe-hybrid:{a}": n for a, n in mh_k2.items()},
                **{f"modal:{a}": n for a, n in modal_k2.items()}}
    kernels.append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:98",
        "launches": sum(k2_paths.values()),
        "launches_by_path": k2_paths,
        "launches_by_mask": K2_SERVED_MASKS,
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
        "serving_shapes": [
            {key: r[key] for key in ("case", "shape", "window", "body", "ms_cold",
                                     "ms_warm", "plain_ms_cold", "bound_ms",
                                     "bound_by", "library_ms_cold")}
            for r in k2_rows if r["case"] in K2_TIMED],
    })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
