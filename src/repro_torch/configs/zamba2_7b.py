"""Zamba2-7B [arXiv:2411.15242]: 81 Mamba2 blocks (state 64) + one weight-
shared attention+MLP block applied every 6 blocks (per-site LoRA omitted).
The reference's ``repro.configs.zamba2_7b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, act="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_conv=4, ssm_chunk=256,
    attn_every=6,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=5, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=256, ssm_state=16,
        ssm_head_dim=16, ssm_chunk=16, attn_every=2)
