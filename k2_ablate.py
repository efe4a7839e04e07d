#!/usr/bin/env python3
"""Where K2's Hopper body spends its time, on one NVIDIA GPU.

    python3 k2_ablate.py           # from the repository root, one card
    python3 k2_ablate.py --baseline OTHER/flash_attention.cu --only gemma

Builds variants of src/repro_torch/kernels/csrc/flash_attention.cu, each
with one part removed or replaced, and times every variant with CUDA events
(L2 cold, median of 20) beside the source as it is and
`F.scaled_dot_product_attention`, at qwen2.5-3b's prefill shape (causal and
full), at a longer causal one, at llama3-8b's (K and V over the L2's 50 MB)
and at gemma-7b's (D = 256, causal and full).  Every variant but `as_is`
computes a wrong result on purpose: the time it saves is what the removed
part costs.
Each variant is a text substitution on the source as it stood when the
ablation table in PERF.md was taken: the script is pinned to that source,
and stops, naming the text it misses, once the kernel changes under it
(update the substitutions with the kernel).  With ``--baseline`` the
given source (another commit's kernel, unedited) is built too and timed
beside `as_is` in turns: baseline, as_is, the variants, as_is, baseline;
``--only TEXT`` times the shapes whose label holds TEXT.
It imports no JAX.
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
          ("2x8192 causal", (2, 8192, 16, 2, 128), True),
          ("llama causal", (8, 2048, 32, 8, 128), True),
          ("gemma causal", (8, 2048, 16, 16, 256), True),
          ("gemma full", (8, 2048, 16, 16, 256), False)]


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
# result; `half_kv_bytes` loads one of D / 64 panels (half the bytes only at
# D = 128); `no_q_reload` changes only D = 256, where each work tile waits
# for its Q (loaded into the panels its output was staged in).
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
                          s, "    mbar_expect_tx(bar, L::kKVTile);\n#pragma "
                          "unroll\n    for (int p = 0; p < L::kPanels; ++p)\n"
                          "      tma_load(dst",
                          "    mbar_expect_tx(bar, L::kKVPanel);\n#pragma "
                          "unroll\n    for (int p = 0; p < 1; ++p)\n"
                          "      tma_load(dst")),
    "no_pingpong": ("the warpgroups' turns",
                    lambda s: _sub(_sub(
                        s, 'asm volatile("bar.sync %0, 256;\\n" :: "r"(1 + c) '
                        ': "memory");', ""),
                        'asm volatile("bar.arrive %0, 256;\\n" :: "r"(2 - c) '
                        ': "memory");', "")),
    "one_tile_per_block": ("the persistent grid (one block per work tile)",
                           lambda s: _sub(s, "units < sms ? units : sms",
                                          "tiles")),
    "no_store": ("the output's TMA store",
                 lambda s: _sub(s, "        tma_store(&to,",
                                "        if (l[0] < 0) tma_store(&to,")),
    "no_q_reload": ("each work tile's Q load (D = 256: its first Q kept)",
                    lambda s: _sub(_sub(
                        s, "mbar_wait(bars.q_full(c), rnd & 1);",
                        "if (rnd == 0) mbar_wait(bars.q_full(c), 0);"),
                        "        if (nxt.w < wk.tiles) load_q(nxt, c);\n",
                        "")),
    "by_query_tile": ("the order by head (D = 256 walks the work by query "
                      "tile, as D <= 128 does)",
                      lambda s: _sub(s, "constexpr bool kByHead = D == 256;",
                                     "constexpr bool kByHead = false;")),
    "by_head": ("the order by query tile (every D walks the work by head, "
                "as D = 256 does)",
                lambda s: _sub(s, "constexpr bool kByHead = D == 256;",
                               "constexpr bool kByHead = true;")),
    "no_pv": ("the PV products", lambda s: _sub(_sub(
        s, "pv_product<D>(o, pa, k_addr((g - 1) % kStages) + L::kKVTile);",
        ""), "pv_product<D>(o, pa, k_addr(gl % kStages) + L::kKVTile);", "")),
    "no_qk": ("the QK^T products (not the redo's)", lambda s: _sub(_sub(
        s, "qk_product<D>(sc, qf, qaddr, k_addr(g0 % kStages));", ""),
        "qk_product<D>(sc, qf, qaddr, k_addr(g % kStages));", "")),
}


def build(out_dir: Path, baseline: Path | None = None) -> dict:
    """Compile every variant (and ``baseline`` as it is) in parallel;
    returns name -> bound library."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    src = (ops.CSRC / "flash_attention.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in ops.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    sources = {name: edit(src) for name, (_, edit) in VARIANTS.items()}
    if baseline is not None:
        sources["baseline"] = baseline.read_text()
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
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

    from chip_smoke import K2_ROW_TOL, cuda_timer, k2_row_err
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"[k2_ablate] {card.splitlines()[0]}")
    baseline = (Path(sys.argv[sys.argv.index("--baseline") + 1])
                if "--baseline" in sys.argv else None)
    libs = build(ops.BUILD_DIR / "ablate", baseline)
    order = list(VARIANTS)
    if baseline is not None:
        order = ["baseline", *order, "as_is", "baseline"]
    timer = cuda_timer(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    only = (sys.argv[sys.argv.index("--only") + 1] if "--only" in sys.argv
            else "")
    for label, (b, s, h, kv, d), causal in SHAPES:
        if only not in label:
            continue
        q, k, v = (torch.randn((b, s, n, d), generator=gen, device=dev)
                   .bfloat16() for n in (h, kv, kv))
        scale = d ** -0.5
        if label in ("serve causal", "gemma causal"):   # as_is must be right
            # 3e-2, or one bf16 ulp where an output is 4 or more (its ulp
            # is 2^-5 there; N(0, 1) draws of v reach 5 at these sizes), and
            # each row within K2_ROW_TOL of its own size.
            got = fa.launch(libs["as_is"], q, k, v, scale=scale,
                            causal=True).float()
            want = ref.flash_attention_ref(q, k, v, scale=scale).float()
            diff = (got - want).abs()
            ulp = torch.exp2(torch.floor(torch.log2(
                torch.maximum(got.abs(), want.abs()).clamp_min(1e-30))) - 7)
            over = int((diff > torch.clamp(ulp, min=3e-2)).sum())
            row = k2_row_err(got, want)
            if over or row > K2_ROW_TOL[torch.bfloat16]:
                raise SystemExit(f"k2_ablate: as_is disagrees: "
                                 f"{float(diff.max()):.3e} max, {over} "
                                 f"outputs over 3e-2 and one ulp, row error "
                                 f"{row:.3e}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale, enable_gqa=True),
            True, reps=20)
        print(f"[k2_ablate] {label} {b}x{s}x{h}x{kv}x{d}: sdpa "
              f"{sdpa * 1e3:.1f} us")
        for name in order:
            lib = libs[name]
            t = timer(lambda: fa.launch(lib, q, k, v, scale=scale,
                                        causal=causal), True, reps=20)
            what = (f"the source of {baseline}" if name == "baseline"
                    else f"removes {VARIANTS[name][0]}")
            print(f"[k2_ablate]   {name:18s} {t * 1e3:7.1f} us  ({what})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
