"""Architecture configuration: ``ModelConfig`` and ``RuntimeFlags``.

A copy of ``repro.models.config`` (data only), so the port never imports
the JAX package.  One frozen dataclass covers every architecture family;
family-specific fields default to "off".  The hybrid (Zamba2), ssm
(xLSTM) and dense families have models in the port so far.
"""

from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "RuntimeFlags"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------- #
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    # -- trunk ------------------------------------------------------------- #
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    act: str = "swiglu"            # swiglu | geglu | gelu
    norm_eps: float = 1e-6
    # -- attention variants ------------------------------------------------ #
    causal: bool = True
    window: int | None = None      # sliding window on every layer (Mixtral)
    alt_window: int | None = None  # alternating local/global (Gemma2):
    #                                even layers local(alt_window), odd global
    attn_softcap: float | None = None
    final_softcap: float | None = None
    query_scale: float | None = None       # default head_dim**-0.5
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] | None = None  # Qwen2-VL (t,h,w) rotary split
    post_norm: bool = False                # Gemma2 sandwich (pre+post RMSNorm)
    # -- embeddings -------------------------------------------------------- #
    tie_embeddings: bool = False
    embed_scale: bool = False              # Gemma: hidden *= sqrt(d_model)
    # -- MoE ---------------------------------------------------------------- #
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    dense_d_ff: int = 0                    # d_ff of the dense prefix layers
    router: str = "softmax"                # softmax | sigmoid (DeepSeek-V3)
    capacity_factor: float = 1.25
    # -- MLA (DeepSeek-V3) --------------------------------------------------- #
    mla: bool = False
    q_lora: int = 0
    kv_lora: int = 0
    rope_dim: int = 0
    nope_dim: int = 0
    v_head_dim: int = 0
    # -- SSM / Mamba2 -------------------------------------------------------- #
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # -- hybrid (Zamba2): one weight-shared attention block every k SSM blocks #
    attn_every: int = 0
    # -- xLSTM: block i is sLSTM iff (i % slstm_every == slstm_at) ----------- #
    slstm_every: int = 0
    slstm_at: int = 1
    # -- encoder-only (HuBERT) ---------------------------------------------- #
    is_encoder: bool = False
    frontend_dim: int = 0                  # stubbed modality feature dim
    # -- VLM (Qwen2-VL) ------------------------------------------------------ #
    n_vision_tokens: int = 0               # prefix positions fed image embeds

    # ------------------------------------------------------------------ #
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    def layer_window(self, layer: int) -> int | None:
        """Static per-layer sliding window (None = global)."""
        if self.alt_window is not None:
            return self.alt_window if layer % 2 == 0 else None
        return self.window

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk), for 6·N·D."""
        d, v = self.d_model, self.vocab
        n = v * d                                   # embed
        if not self.tie_embeddings and not self.is_encoder:
            n += v * d                              # unembed
        if self.is_encoder:
            n += self.frontend_dim * d + v * d      # frontend proj + unit head
        per_layer = self._per_layer_params()
        n += sum(per_layer)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared experts only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        n_moe_layers = self.n_layers - self.first_dense_layers
        inactive = (self.n_experts - self.top_k) * 3 * d * self.moe_d_ff
        return self.param_count() - n_moe_layers * inactive

    def _per_layer_params(self) -> list[int]:
        d = self.d_model
        out = []
        for layer in range(self.n_layers):
            p = 2 * d                               # norms
            if self.family == "ssm":                # xLSTM blocks (approx.)
                d_in = 2 * d
                p += d * d_in * 2 + d_in * d        # up/gate/down
                p += 3 * d_in * self.head_dim       # qkv-ish
            elif self.family == "hybrid":
                d_in = self.ssm_expand * d
                p += d * (2 * d_in + 2 * self.ssm_state) + d_in * d
            else:
                hd, h, kv = self.head_dim, self.n_heads, self.n_kv_heads
                if self.mla:
                    qk = self.nope_dim + self.rope_dim
                    p += d * self.q_lora + self.q_lora * h * qk
                    p += d * (self.kv_lora + self.rope_dim)
                    p += self.kv_lora * h * (self.nope_dim + self.v_head_dim)
                    p += h * self.v_head_dim * d
                else:
                    p += d * h * hd + 2 * d * kv * hd + h * hd * d
            if self.family in ("dense", "vlm", "audio", "moe"):
                mults = 3 if self.act in ("swiglu", "geglu") else 2
                if self.is_moe and layer >= self.first_dense_layers:
                    p += self.n_experts * mults * d * self.moe_d_ff
                    p += self.n_shared_experts * mults * d * self.moe_d_ff
                    p += d * self.n_experts     # router
                else:
                    ff = self.dense_d_ff or self.d_ff
                    p += mults * d * ff
            out.append(p)
        # hybrid: add the single shared attention+MLP block once
        if self.family == "hybrid" and self.attn_every:
            d = self.d_model
            h, hd = self.n_heads, self.head_dim
            out.append(2 * d * (d + 2 * self.n_kv_heads * hd) // 2 * 0)
            out.append(d * h * hd + 2 * d * self.n_kv_heads * hd + h * hd * d
                       + 3 * d * self.d_ff)
        return out


@dataclasses.dataclass(frozen=True)
class RuntimeFlags:
    """Static execution knobs, the same fields as the reference's.

    The port's serving path reads ``compute_dtype`` only.  ``attn_impl``
    and ``attn_chunk`` choose between two jnp formulations of attention in
    the reference; the port always runs the attention kernels' ops
    (``models.attention.attend``) and keeps the fields so that one flags
    object describes a run in both packages.  The training step reads
    ``loss_chunks``, ``microbatches`` and ``grad_compress``; sharding
    comes from the mesh and rules handed to the step factories
    (``train.step``), as in the reference, and ``attn_shard`` and ``zero``
    are not read (the port's attention is the kernel op on each rank's
    batch and heads, and the moments always follow the parameters).
    ``remat`` checkpoints the training path's layers (``models.remat``):
    "full" and "dots" in the transformer families, any value but "none"
    as "full" in the hybrid and ssm families, as in the reference.
    """

    attn_impl: str = "chunked"     # chunked | naive  (naive: tiny tests only)
    attn_chunk: int = 1024         # kv-block for the online-softmax scan
    loss_chunks: int = 8           # sequence chunks for the CE loss
    remat: str = "none"            # none | dots | full
    microbatches: int = 1          # gradient-accumulation steps
    scan_layers: bool = True       # lax.scan over layers vs python unroll
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    moe_impl: str = "gather"       # gather | einsum (dispatch style)
    attn_shard: str = "auto"       # auto | kv_heads | heads_repeat | seq | none
    zero: bool = True              # ZeRO: shard optimizer state over data axis
    analysis_unroll: bool = False  # unroll all scans so HLO flop counts are
    #                                exact (dry-run/roofline mode; cost_analysis
    #                                counts while-loop bodies once)
    grad_compress: bool = False    # int8 error-feedback DP gradient compression
