"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892]."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,        # rwkv head count (head_dim 64)
    rwkv_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab=65536,
    act="relu",        # rwkv channel-mix analogue (squared-relu family)
    dtype=torch.bfloat16,
    remat=True,
    source="[arXiv:2404.05892] RWKV6 Finch 1.6B: 24L d2048 ff7168 v65536, attn-free",
)
