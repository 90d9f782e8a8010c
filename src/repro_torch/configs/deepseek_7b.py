"""DeepSeek-7B [arXiv:2401.02954]: llama-arch, 30L, MHA (kv=32), SwiGLU.
The reference's ``repro.configs.deepseek_7b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=11008, vocab=102400, act="swiglu",
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="deepseek-7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=160, vocab=256)
