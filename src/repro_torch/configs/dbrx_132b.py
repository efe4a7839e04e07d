"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=10752,
    vocab=100352,
    n_experts=16,
    top_k=4,
    act="swiglu",
    rope_theta=500_000.0,
    dtype=torch.bfloat16,
    remat=True,
    source="[hf:databricks/dbrx-base] 40L d6144 48H kv8 ff10752 v100352 16e top-4",
)
