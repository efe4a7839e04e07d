"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision]. Vision encoder STUBBED: the modal
input is projected patch embeddings (B, n_modal_tokens, d_model), as in the
reference."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    cross_attn_every=5,   # 80 self-attn + 20 gated cross-attn layers
    n_modal_tokens=1600,  # ~1601 patch tokens per tile, rounded for tiling
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    act="swiglu",
    rope_theta=500_000.0,
    dtype=torch.bfloat16,
    remat=True,
    source="[hf:meta-llama/Llama-3.2-11B-Vision] scaled 90B: 100L d8192 64H kv8 ff28672",
)
