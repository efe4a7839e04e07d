"""granite-moe-1b-a400m [moe] — 32 experts top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab=49155,
    n_experts=32,
    top_k=8,
    act="swiglu",
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    source="[hf:ibm-granite/granite-3.0-1b-a400m-base] 24L d1024 16H kv8 ff512 32e top-8",
)
