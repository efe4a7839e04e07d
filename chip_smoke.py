#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py          # from the repository root, one card

Phases, in order; any failure exits nonzero (no phase is skipped):

  1. device    — requires CUDA; prints the card, its power limit, the torch
                 and CUDA versions and the two TF32 flags.
  2. build     — compiles every kernel under src/repro_torch/kernels/csrc/
                 with nvcc for sm_90a (one process per source, in parallel).
  3. kernels   — K1 `ra_aggregate` in its four variants (two modes, with and
                 without a transmit mask) x {float32, bfloat16} at three
                 shapes, held to its plain PyTorch version on the same
                 inputs; times the kernel, the plain version and one library
                 call (`torch.bmm` of precomputed coefficients) with CUDA
                 events, L2 cold and warm, beside the memory bound.
  4. reference — a quickstart-sized run on the card against the same run on
                 the CPU's plain path, with the same weights and draws.
  5. slice     — the main path: the full-width paper CNN on 28x28x1 data,
                 10 clients on the Table-II network, 3 rounds of each of
                 R&A (both modes), AaYG, C-FL and ideal C-FL; the kernel's
                 launch count is set to 0 just before and read just after.
  6. profile   — one R&A round under torch.profiler: device time by kernel.

It then prints the card line, one JSON line describing every ported kernel,
and last a JSON line with the device.  Without CUDA, or without the rest of
the repository beside it, it exits nonzero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import math
import re
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

# K1 checks: the slice shape, a batched prime-L shape, and N > 16 receivers.
K1_SHAPES = [
    ("slice", dict(b=None, n=10, l=412, k=1024)),
    ("batched_primeL", dict(b=4, n=10, l=1181, k=256)),
    ("n33", dict(b=None, n=33, l=64, k=1024)),
]
F32_TOL = 1e-5      # absolute; float32 sums in another order
BF16_TOL_ULP = 1.0  # bfloat16 spacing at the result's magnitude, + F32_TOL
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

    refs = {"ra_normalized": ref.ra_aggregate_ref,
            "substitution": ref.ra_substitution_ref}
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    for shape_name, s in shapes:
        b, n, l, k = s["b"], s["n"], s["l"], s["k"]
        lead = () if b is None else (b,)
        for dtype in (torch.float32, torch.bfloat16):
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
                    if b is None and not with_tx:
                        # Library yardstick: one bmm of precomputed
                        # (L, N, N)^T coefficients with (L, N, K) segments.
                        ef = e.float() * p[:, None, None]
                        if mode == "ra_normalized":
                            coef = ef / ef.sum(0, keepdim=True).clamp_min(1e-12)
                        else:
                            miss = (p.sum() - ef.sum(0)).T          # (L, N)
                            coef = ef + torch.diag_embed(miss).permute(1, 2, 0)
                        coef_t = coef.permute(2, 1, 0).contiguous().to(dtype)
                        w_l = w.permute(1, 0, 2).contiguous()
                        lib = torch.bmm(coef_t, w_l).permute(1, 0, 2).float()
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


def profile_round(sim, scenario):
    """Phase 6: one R&A round under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    state = sim.init_scan(scenario)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.advance_chunk(state, scenario)
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel events only: CPU-side aten ops also report the device time of
    # the kernels they launched, which would count it twice.
    events = [ev for ev in prof.key_averages()
              if ev.device_type.name == "CUDA" and ev.self_device_time_total > 0]
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

    # 3. kernels
    rows = k1_checks(dev, K1_SHAPES, cuda_timer(dev))
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
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
