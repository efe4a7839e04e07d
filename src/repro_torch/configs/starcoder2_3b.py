"""starcoder2-3b [dense] — GQA, RoPE [arXiv:2402.19173]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="starcoder2-3b",
    family="dense",
    n_layers=30,
    d_model=3072,
    n_heads=24,
    n_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab=49152,
    act="gelu",
    qkv_bias=True,
    rope_theta=100_000.0,
    dtype=torch.bfloat16,
    remat=True,
    source="[arXiv:2402.19173] StarCoder2-3B: 30L d3072 24H kv2 ff12288 v49152",
)
