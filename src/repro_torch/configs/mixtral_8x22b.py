"""Mixtral-8x22B [arXiv:2401.04088]: 56L, GQA kv=8, 8 experts top-2,
sliding-window attention (per assignment), vocab 32768.
The reference's ``repro.configs.mixtral_8x22b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=32768, act="swiglu",
    n_experts=8, top_k=2, moe_d_ff=16384, window=4096,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="mixtral-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, n_experts=4,
        top_k=2, moe_d_ff=128, window=16)
