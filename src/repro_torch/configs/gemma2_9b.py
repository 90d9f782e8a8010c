"""Gemma2-9B [arXiv:2408.00118]: 42L, alternating local(4096)/global
attention, logit softcaps (attn 50, final 30), pre+post RMSNorm, GeGLU.
The reference's ``repro.configs.gemma2_9b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, act="geglu",
    alt_window=4096, attn_softcap=50.0, final_softcap=30.0,
    post_norm=True, tie_embeddings=True, embed_scale=True,
    query_scale=256 ** -0.5,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="gemma2-9b-smoke", n_layers=4, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, vocab=256, alt_window=8,
        query_scale=16 ** -0.5)
