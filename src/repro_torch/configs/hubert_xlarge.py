"""HuBERT-XLarge [arXiv:2106.07447]: 48L encoder-only (w2v2 arch), masked-
unit prediction over 504 units; conv frontend stubbed (input_specs supplies
precomputed 512-dim frame features).
The reference's ``repro.configs.hubert_xlarge``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16, head_dim=80,
    d_ff=5120, vocab=504, act="gelu",
    causal=False, is_encoder=True, frontend_dim=512, tie_embeddings=False,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="hubert-xlarge-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, vocab=32, frontend_dim=24)
