"""Granite-3.0-2B [hf:ibm-granite/granite-3.0-2b-base]: 40L, GQA kv=8.
The reference's ``repro.configs.granite_3_2b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense",
    n_layers=40, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=8192, vocab=49155, act="swiglu", tie_embeddings=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="granite-3-2b-smoke", n_layers=2, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, vocab=255)
