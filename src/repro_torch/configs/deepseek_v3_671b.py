"""DeepSeek-V3-671B [arXiv:2412.19437]: 61L, MLA (q_lora 1536, kv_lora 512,
rope 64, nope 128, v_head 128), first 3 layers dense (d_ff 18432), then
1 shared + 256 routed experts (d_ff 2048) top-8 with sigmoid router.
MTP head omitted (single-token objective), noted in DESIGN.md.
The reference's ``repro.configs.deepseek_v3_671b``, field for field."""

import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=192,
    d_ff=2048, vocab=129280, act="swiglu",
    n_experts=256, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=3, dense_d_ff=18432, router="sigmoid",
    mla=True, q_lora=1536, kv_lora=512, rope_dim=64, nope_dim=128,
    v_head_dim=128,
)


def smoke():
    return dataclasses.replace(
        CONFIG, name="deepseek-v3-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=24, d_ff=96, vocab=256, n_experts=8, top_k=2,
        moe_d_ff=96, first_dense_layers=1, dense_d_ff=128,
        q_lora=32, kv_lora=16, rope_dim=8, nope_dim=16, v_head_dim=16)
