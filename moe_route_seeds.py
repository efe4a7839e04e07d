#!/usr/bin/env python3
"""How far bf16 routing carries granite-moe-1b-a400m's served prefill, on
one NVIDIA GPU.

    python3 moe_route_seeds.py     # from the repository root, one card

Serves granite-moe-1b-a400m at full width (`chip_smoke.SERVE_SHAPE`,
random weights and prompts from seeds 0, 1 and 2) and holds each prefill
to impl="torch" with `chip_smoke.serve_vs_plain`, printing its readings
and whether its checks held: among them the served run's routing flips
and its gaps to the float32 run beside impl="torch"'s, each path routed by
its own choices, from which `chip_smoke.SERVE_MOE_OWN_RATIO` and
`SERVE_MOE_LOGITS_RATIO` were set (chip_smoke itself serves seed 0).  It
imports no JAX.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

ARCH = "granite-moe-1b-a400m"
SEEDS = (0, 1, 2)


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_route_seeds: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.configs import base
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ops.build_all()
    cfg = base.get(ARCH)
    failed = []
    for seed in SEEDS:
        res = serve.serve(cfg, **chip_smoke.SERVE_SHAPE, seed=seed)
        try:
            chip_smoke.serve_vs_plain(cfg, res, f"seed {seed}",
                                      "flash_attention")
        except RuntimeError as err:
            failed.append(seed)
            print(f"[seed {seed}] {err}")
        del res
        torch.cuda.empty_cache()
    print(f"moe_route_seeds: checks held at seeds "
          f"{[s for s in SEEDS if s not in failed]}, failed at {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
