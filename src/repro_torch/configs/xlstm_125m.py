"""xLSTM-125M [arXiv:2405.04517]: 12 blocks, mLSTM backbone with sLSTM
blocks interleaved (7:1-style), GPT-NeoX vocab 50304.  The reference's
``repro.configs.xlstm_125m``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, head_dim=192,
    d_ff=0, vocab=50304, act="swiglu",
    slstm_every=6, slstm_at=1, ssm_conv=4, ssm_chunk=256,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="xlstm-125m-smoke", n_layers=3, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, vocab=256, slstm_every=3, slstm_at=1,
        ssm_chunk=16)
