"""Qwen2-VL-2B [arXiv:2409.12191]: 28L, GQA kv=2, M-RoPE (t/h/w rotary
sections 16/24/24), vocab 151936; vision patch frontend stubbed
(input_specs supplies projected patch embeddings + 3D position ids).
The reference's ``repro.configs.qwen2_vl_2b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab=151936, act="swiglu",
    mrope_sections=(16, 24, 24), rope_theta=1000000.0,
    tie_embeddings=True, n_vision_tokens=256,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="qwen2-vl-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256,
        mrope_sections=(2, 3, 3), n_vision_tokens=4)
