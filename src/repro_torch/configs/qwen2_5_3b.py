"""qwen2.5-3b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="qwen2.5-3b",
    family="dense",
    n_layers=36,
    d_model=2048,
    n_heads=16,
    n_kv_heads=2,
    head_dim=128,
    d_ff=11008,
    vocab=151936,
    act="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16,
    remat=True,
    source="[hf:Qwen/Qwen2.5-0.5B] (assigned 3b geometry: 36L d2048 16H kv2 ff11008 v151936)",
)
