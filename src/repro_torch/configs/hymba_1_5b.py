"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Meta-token prompt tuning of the paper is an input-level detail and is not
modeled; the hybrid parallel-head block is."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab=32001,
    d_state=16,
    act="swiglu",
    dtype=torch.bfloat16,
    remat=True,
    source="[arXiv:2411.13676] Hymba-1.5B: 32L d1600 25H kv5 ff5504 v32001 ssm16",
)
