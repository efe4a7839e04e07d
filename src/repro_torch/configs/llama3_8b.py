"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="llama3-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab=128256,
    act="swiglu",
    rope_theta=500_000.0,
    dtype=torch.bfloat16,
    remat=True,
    source="[arXiv:2407.21783] Llama 3 8B: 32L d4096 32H kv8 ff14336 v128256",
)
