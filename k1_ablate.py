#!/usr/bin/env python3
"""Where K1's time goes, on one NVIDIA GPU.

    python3 k1_ablate.py           # from the repository root, one card

Builds variants of src/repro_torch/kernels/csrc/ra_aggregate.cu, each with
one part removed, and times every variant with CUDA events (median of 30,
L2 evicted first) beside the source as it is and beside `Tensor.copy_` of
w into a tensor like it (the same bytes read and written, no arithmetic:
the streaming floor), at the slice shape, the 12-scenario grid and n33, in
float32 and bfloat16, mode ra_normalized without a transmit mask.  Two
ways to evict L2 are timed: `dirty` overwrites a 256 MB buffer, as
chip_smoke.py's timer does, and leaves 50 MB of modified lines that the
next kernel writes back as it misses; `clean` reads the buffer instead.
Every variant but `as_is` computes a wrong result on purpose: the time it
saves is what the removed part costs.  Each variant is a text substitution
on the source as it stood when PERF.md's K1 table was taken: the script
stops, naming the text it misses, once the kernel changes under it.  It
imports no JAX.
"""
from __future__ import annotations

import ctypes
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [("slice", None, 10, 412, 1024), ("grid12", 12, 10, 412, 1024),
          ("n33", None, 33, 64, 1024)]


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k1_ablate: the source no longer holds {old!r}")
    return src.replace(old, new)


def _no_coef(src: str) -> str:
    """C is a constant: no mask loads, no products, sums or normaliser."""
    reg = "int lane, float* coef, float* scale) {\n"
    src = _sub(src, reg, reg + "  {\n    constexpr int NP = (N + 3) & ~3;\n"
               "    if (lane < NP)\n      for (int n = 0; n < N; ++n) "
               "coef[n * NP + lane] = 0.1f;\n    if (lane < N) scale[lane] = "
               "1.0f;\n    __syncwarp();\n    return;\n  }\n")
    src = _sub(src, "  const SenderMasks<N> g = gather_reg<N>(a, tt.b, tt.l, "
               "lane);\n", "  const SenderMasks<N> g{};\n")
    smem = "float* coef, float* scale, IssueW issue_w) {\n"
    return _sub(src, smem, smem + "  for (int i = threadIdx.x; i < a.N * GP "
                "* ((R + 3) & ~3); i += blockDim.x) coef[i] = 0.1f;\n  for "
                "(int i = threadIdx.x; i < a.N; i += blockDim.x) scale[i] = "
                "1.0f;\n  issue_w();\n  __syncthreads();\n  return;\n")


def _no_mask_loads(src: str) -> str:
    """e' = 1 (C is still built: products, sums, normaliser)."""
    src = _sub(src, "  load_masks_strided(g.e, a.e, b * a.e_bs + static_cast<long "
               "long>(lane) * N * a.L + l,\n                     a.L, N, live, "
               "a.e_f32);\n",
               "  for (int n = 0; n < N; ++n) g.e[n] = live ? 1.0f : 0.0f;\n")
    return _sub(src, "  load_masks_strided(c.e, a.e, eb + (static_cast<long long>"
                "(m) * a.N + n0) * a.L, a.L,\n                     a.N - n0, "
                "live, a.e_f32);\n",
                "  for (int r = 0; r < R; ++r) c.e[r] = live && r < a.N - n0 ? "
                "1.0f : 0.0f;\n")


def _one_product(src: str) -> str:
    """One FMA per value and receiver instead of N (register body) or R
    (shared-memory body): the loads are all still used."""
    src = _sub(src, "      if (m4 + i < N) {", "      if (m4 + i == n) {")
    return _sub(src, "        for (int r = 0; r < R; ++r)\n#pragma unroll\n"
                "          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(",
                "        for (int r = 0; r < 1; ++r)\n#pragma unroll\n"
                "          for (int j = 0; j < V; ++j) acc[r][j] = fmaf(")


# name -> (what it removes, the substitution).
VARIANTS = {
    "as_is": ("nothing", lambda s: s),
    "no_mask_loads": ("the mask gathers (e' = 1)", _no_mask_loads),
    "no_coef": ("the coefficients (a constant C)", _no_coef),
    "one_product": ("all products but one a value and receiver",
                    _one_product),
    "stream_only": ("the coefficients and all products but one",
                    lambda s: _one_product(_no_coef(s))),
    "one_column_tile": ("the second column-tile of the shared-memory "
                        "body's blocks (C built for one tile)",
                        lambda s: _sub(s, "kSmallF32 ? 14 : (sizeof(WT) == 2 "
                                       "&& R > 5 ? 8 : 16);",
                                       "kSmallF32 ? 7 : 8;")),
    "one_block_an_sm": ("the float32 register cut to 2 blocks an SM "
                        "(shared-memory body)",
                        lambda s: _sub(s, "kMinBlocks = kSmallF32 ? 2 : 1;",
                                       "kMinBlocks = 1;")),
    "senders_unrolled_2": ("nothing: the shared-memory body's sender loop "
                           "2 deep everywhere (bf16: 4 as it is; small "
                           "float32: 1)",
                           lambda s: _sub(s, "kUnroll = kSmallF32 ? 1 : "
                                          "(sizeof(WT) == 2 && R <= 5 ? 4 : 2);",
                                          "kUnroll = 2;")),
    "unrolled_receivers": ("nothing: the register body's receiver loop "
                           "unrolled (N times the code)",
                           lambda s: _sub(s, "#pragma unroll 1\n  for (int n "
                                          "= 0; n < N; ++n) {",
                                          "#pragma unroll\n  for (int n = 0; "
                                          "n < N; ++n) {")),
}


def build(root: Path) -> dict[str, ctypes.CDLL]:
    from repro_torch.kernels import ops
    from repro_torch.kernels import ra_aggregate as _ra

    src = (ops.CSRC / "ra_aggregate.cu").read_text()
    out = root / "results" / "k1_ablate"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (_, edit) in VARIANTS.items():
        cu = out / f"{name}.cu"
        cu.write_text(edit(src))
        so = out / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [ops._nvcc(), *ops.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k1_ablate: nvcc failed for {name}:\n{log}")
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", log)]
        print(f"[k1-ablate] built {name}: max spill stores "
              f"{max(spills, default=0)} B")
        libs[name] = _ra.bind(ctypes.CDLL(str(so)))
    return libs


def timer(dev):
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def time_it(fn, how: str, reps: int = 30) -> float:
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            if how == "dirty":
                flush.zero_()
            else:
                flush.max()     # reads 256 MB: clean lines only
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    return time_it


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_ablate: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import ra_aggregate as _ra

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    libs = build(ROOT)
    time_it = timer(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    print(f"[k1-ablate] {card}; us, median of 30; L2 evicted dirty / clean")
    for name, b, n, l, k in SHAPES:
        lead = () if b is None else (b,)
        for dtype in (torch.float32, torch.bfloat16):
            w = torch.randn(lead + (n, l, k), generator=gen,
                            device=dev).to(dtype)
            p = torch.rand(n, generator=gen, device=dev) + 0.1
            p = p / p.sum()
            e = torch.rand(lead + (n, n, l), generator=gen, device=dev) < 0.7
            w4, p2, e4, _ = _ra.broadcast_batch(w, p / p.sum(), e, None,
                                                mode="ra_normalized")
            dst = torch.empty_like(w)
            cells = {"copy_": lambda: dst.copy_(w)}
            for v, lib in libs.items():
                cells[v] = (lambda lib=lib: _ra.launch(
                    lib, w4, p2, e4, None, mode="ra_normalized"))
            row = []
            for v, fn in cells.items():
                d, c = time_it(fn, "dirty"), time_it(fn, "clean")
                row.append(f"{v} {d * 1e3:.2f}/{c * 1e3:.2f}")
            print(f"[k1-ablate] {name:7s} {str(dtype)[6:]:8s} " + " | ".join(row),
                  flush=True)
    for v, (what, _) in VARIANTS.items():
        print(f"[k1-ablate] {v}: removes {what}")
    print(f"[k1-ablate] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
