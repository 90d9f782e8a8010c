"""Gemma-2B [arXiv:2403.08295]: 18L, MQA (kv=1), head_dim 256, GeGLU,
tied + scaled embeddings, vocab 256000.  The reference's
``repro.configs.gemma_2b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu",
    tie_embeddings=True, embed_scale=True,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="gemma-2b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=1, head_dim=16, d_ff=128, vocab=256)
