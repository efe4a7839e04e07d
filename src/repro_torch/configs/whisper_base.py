"""whisper-base [audio] — enc-dec, conv frontend STUBBED [arXiv:2212.04356].

The modal input is precomputed mel-frame embeddings (B, 1500, 512) in
place of the conv1d + mel front end, as in the reference."""
import torch

from ..models.transformer import ModelCfg

CONFIG = ModelCfg(
    name="whisper-base",
    family="enc_dec",
    n_layers=6,          # decoder layers
    n_enc_layers=6,
    enc_seq=1500,        # 30 s audio -> 1500 frames
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab=51865,
    act="gelu",
    norm="layernorm",
    dtype=torch.bfloat16,
    source="[arXiv:2212.04356] Whisper base: 6L enc + 6L dec, d512 8H ff2048 v51865",
)
