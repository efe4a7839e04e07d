"""Config registry: full architecture configs, reduced smoke variants and
input shapes.

Port of the reference package's `configs/base.py`.  Every full config
cites its source in `ModelCfg.source`; dtypes are torch dtypes.
`smoke_variant` shrinks any config to <=2 layers, d_model<=512, <=4
experts while keeping the family topology.  Every architecture of the
reference has its config file here: rwkv6-1.6b, the dense qwen2.5-3b,
llama3-8b, starcoder2-3b and gemma-7b, the moe granite-moe-1b-a400m and
dbrx-132b, the hybrid hymba-1.5b, the enc_dec whisper-base and the vlm
llama-3.2-vision-90b.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch

from ..models.transformer import ModelCfg

ARCH_IDS = [
    "qwen2_5_3b",
    "llama3_8b",
    "whisper_base",
    "starcoder2_3b",
    "llama3_2_vision_90b",
    "hymba_1_5b",
    "dbrx_132b",
    "rwkv6_1_6b",
    "granite_moe_1b_a400m",
    "gemma_7b",
]

# The architectures whose inputs include modal embeddings (enc_dec, vlm):
# the simulator's ``apply(params, x)`` cannot carry them, so the NWP zoo
# (`models.registry.SIM_MODEL_IDS`) skips them.
MODAL_ARCHS = ("whisper_base", "llama3_2_vision_90b")

# CLI-friendly aliases (--arch qwen2.5-3b etc.)
ALIASES = {
    "qwen2.5-3b": "qwen2_5_3b",
    "llama3-8b": "llama3_8b",
    "whisper-base": "whisper_base",
    "starcoder2-3b": "starcoder2_3b",
    "llama-3.2-vision-90b": "llama3_2_vision_90b",
    "hymba-1.5b": "hymba_1_5b",
    "dbrx-132b": "dbrx_132b",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "gemma-7b": "gemma_7b",
}


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

# The sliding window long_500k decodes with on the attention families: a
# wrapped cache of this many slots (`transformer.init_cache(window=)`).
LONG_CONTEXT_WINDOW = 8_192


def get(arch: str) -> ModelCfg:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch!r}; one of {ARCH_IDS}")
    return importlib.import_module(f"{__package__}.{arch}").CONFIG


def all_configs() -> dict[str, ModelCfg]:
    return {a: get(a) for a in ARCH_IDS}


def smoke_variant(cfg: ModelCfg) -> ModelCfg:
    """Reduced same-family variant: <=2 layers, d_model<=512, <=4 experts."""
    d = min(cfg.d_model, 256)
    heads = max(2, min(cfg.n_heads, 4))
    kv = max(1, heads * cfg.n_kv_heads // cfg.n_heads)  # keep GQA ratio
    hd = min(cfg.hd, 64)
    kw: dict = dict(
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=hd,
        d_ff=min(cfg.d_ff, 512),
        vocab=min(cfg.vocab, 512),
        dtype=torch.float32,
        remat=False,
    )
    if cfg.family == "moe":
        kw["n_experts"] = min(cfg.n_experts, 4)
        kw["top_k"] = min(cfg.top_k, 2)
    if cfg.family == "vlm":
        kw["n_layers"] = 4
        kw["cross_attn_every"] = 2
        kw["n_modal_tokens"] = min(cfg.n_modal_tokens, 16)
    if cfg.family == "enc_dec":
        kw["n_enc_layers"] = 2
        kw["enc_seq"] = min(cfg.enc_seq, 16)
    if cfg.family == "ssm":
        kw["rwkv_heads"] = max(2, min(cfg.rwkv_heads, 4))
    return dataclasses.replace(cfg, **kw)
