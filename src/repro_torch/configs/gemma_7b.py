"""gemma-7b [dense] — GeGLU, head_dim=256 [arXiv:2403.08295]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab=256000,
    act="geglu",
    rope_theta=10_000.0,
    dtype=torch.bfloat16,
    remat=True,
    source="[arXiv:2403.08295] Gemma 7B: 28L d3072 16H hd256 ff24576 v256000 GeGLU",
)
