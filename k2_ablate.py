#!/usr/bin/env python3
"""Where K2's Hopper body spends its time, on one NVIDIA GPU.

    python3 k2_ablate.py           # from the repository root, one card

Builds variants of src/repro_torch/kernels/csrc/flash_attention.cu, each
with one part removed or replaced, and times every variant with CUDA events
(L2 cold, median of 20) beside the source as it is and
`F.scaled_dot_product_attention`, at qwen2.5-3b's prefill shape (causal and
full) and at a longer causal one.  Every variant but `as_is` computes a
wrong result on purpose: the time it saves is what the removed part costs.
Each variant is a text substitution on the source as it stood when the
ablation table in PERF.md was taken: the script is pinned to that source,
and stops, naming the text it misses, once the kernel changes under it
(update the substitutions with the kernel).  It imports no JAX.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [("serve causal", (8, 2048, 16, 2, 128), True),
          ("serve full", (8, 2048, 16, 2, 128), False),
          ("2x8192 causal", (2, 8192, 16, 2, 128), True)]


def _no_softmax(src: str) -> str:
    """Both softmaxes return at once: P is the raw logits, nothing redone."""
    exact = "int t, int S,\n" + " " * 45 + "int causal, int W) {\n"
    lazy = "float (&lsum)[2], float scale2) {\n"
    src = _sub(src, exact, exact + "  corr[0] = corr[1] = 1.0f;\n  return;\n")
    return _sub(src, lazy, lazy + "  lsum[0] = lsum[1] = 0.0f;\n"
                "  return false;\n")


def _sub(src: str, old: str, new: str) -> str:
    if old not in src:
        raise SystemExit(f"k2_ablate: the source no longer holds {old!r}")
    return src.replace(old, new)


# name -> (what it removes, the substitution).  The variants time a wrong
# result; `half_kv_bytes` holds only at D = 128 (it loads one of two panels).
VARIANTS = {
    "as_is": ("nothing", lambda s: s),
    "no_softmax": ("the online softmax (P = the raw logits)", _no_softmax),
    "ex2_as_ffma": ("the special-function exp2 (one FFMA instead)",
                    lambda s: _sub(s, 'asm("ex2.approx.ftz.f32 %0, %1;\\n" : '
                                   '"=f"(y) : "f"(x));',
                                   "y = fmaf(x, 0.0f, 1.0f);")),
    "exact_softmax_only": ("the lazy max (every tile's max first)",
                           lambda s: _sub(s, "const bool lazy = !edge(j) && "
                                          "scale2 > 0.0f;",
                                          "const bool lazy = false;")),
    "no_rescale": ("the output's rescale after an exact softmax",
                   lambda s: _sub(s, "for (int k = 0; k < D / 2; ++k) "
                                  "o[k] *= corr[(k >> 1) & 1];",
                                  "for (int k = 0; k < 0; ++k) "
                                  "o[k] *= corr[(k >> 1) & 1];")),
    "half_kv_bytes": ("half of every K and V tile's bytes",
                      lambda s: _sub(
                          s, "    mbar_expect_tx(bar, L::kTile);\n#pragma "
                          "unroll\n    for (int p = 0; p < L::kPanels; ++p)\n"
                          "      tma_load(dst",
                          "    mbar_expect_tx(bar, L::kTile / 2);\n#pragma "
                          "unroll\n    for (int p = 0; p < 1; ++p)\n"
                          "      tma_load(dst")),
    "no_pingpong": ("the warpgroups' turns",
                    lambda s: _sub(_sub(
                        s, 'asm volatile("bar.sync %0, 256;\\n" :: "r"(1 + c) '
                        ': "memory");', ""),
                        'asm volatile("bar.arrive %0, 256;\\n" :: "r"(2 - c) '
                        ': "memory");', "")),
    "one_tile_per_block": ("the persistent grid (one block per work tile)",
                           lambda s: _sub(s, "tiles < sms ? tiles : sms",
                                          "tiles")),
    "no_store": ("the output's TMA store",
                 lambda s: _sub(s, "        tma_store(&to,",
                                "        if (l[0] < 0) tma_store(&to,")),
}


def build(out_dir: Path) -> dict:
    """Compile every variant in parallel; returns name -> bound library."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    src = (ops.CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in ops.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    procs = {}
    for name, (_, edit) in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(edit(src))
        procs[name] = subprocess.Popen(
            [ops._nvcc(), *flags, "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"k2_ablate: nvcc failed for {name}:\n{log}")
        libs[name] = fa.bind(ctypes.CDLL(str(out_dir / f"{name}.so")))
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k2_ablate: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from chip_smoke import cuda_timer
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[k2_ablate] {card.splitlines()[0]}")
    libs = build(ops.BUILD_DIR / "ablate")
    timer = cuda_timer(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, (b, s, h, kv, d), causal in SHAPES:
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
                   .bfloat16() for n in (h, kv, kv))
        scale = d ** -0.5
        if label == "serve causal":   # the source as it is must be right
            err = float((fa.launch(libs["as_is"], q, k, v, scale=scale,
                                   causal=True).float()
                         - ref.flash_attention_ref(q, k, v, scale=scale)
                         .float()).abs().max())
            if err > 3e-2:
                raise SystemExit(f"k2_ablate: as_is disagrees: {err:.3e}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True),
            True, reps=20)
        print(f"[k2_ablate] {label} {b}x{s}x{h}x{kv}x{d}: sdpa "
              f"{sdpa * 1e3:.1f} us")
        for name, lib in libs.items():
            t = timer(lambda: fa.launch(lib, q, k, v, scale=scale,
                                        causal=causal), True, reps=20)
            print(f"[k2_ablate]   {name:18s} {t * 1e3:7.1f} us  (removes "
                  f"{VARIANTS[name][0]})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
