"""Multi-head Latent Attention (DeepSeek-V2/V3) — ``repro.models.mla`` in
PyTorch.

The prefill materializes per-head K/V from the compressed latent and runs
``flash_attention`` through ``attention.attend``: q and k are ``nope_dim +
rope_dim`` wide (192 for V3), and v is zero-padded to that width for the
shared kernel and cropped after, as the reference does.  Decode keeps only
the latent ring cache (``kv_lora + rope_dim`` a token) and absorbs the
up-projections into the query and output transforms: latent einsums with
a float32 softmax, in plain PyTorch (no TPU kernel computes it).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import rmsnorm, rmsnorm_spec, rope
from repro_torch.models.params import spec
from repro_torch.shard.api import constrain

__all__ = ["mla_specs", "mla_train", "mla_decode", "mla_cache_shape"]


def mla_specs(cfg, layers: int):
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.nope_dim + cfg.rope_dim
    ll = ("layers",)
    return {
        "q_down": spec((layers, d, cfg.q_lora), ll + ("embed", "q_lora")),
        "q_norm": rmsnorm_spec(cfg.q_lora, layers),
        "q_up": spec((layers, cfg.q_lora, h, qk),
                     ll + ("q_lora", "heads", "head_dim")),
        "kv_down": spec((layers, d, cfg.kv_lora), ll + ("embed", "q_lora")),
        "kv_norm": rmsnorm_spec(cfg.kv_lora, layers),
        "k_rope": spec((layers, d, cfg.rope_dim), ll + ("embed", "head_dim")),
        "k_up": spec((layers, cfg.kv_lora, h, cfg.nope_dim),
                     ll + ("kv_lora", "heads", "head_dim")),
        "v_up": spec((layers, cfg.kv_lora, h, cfg.v_head_dim),
                     ll + ("kv_lora", "heads", "head_dim")),
        "out": spec((layers, h, cfg.v_head_dim, d),
                    ll + ("heads", "head_dim", "embed")),
    }


def _up(c, w):
    """c [B, S, R] by w [R, H, D] -> [B, S, H, D]: the einsum
    ``bsr,rhd->bshd`` as a matmul over the fused [R, H*D] weight, an
    ``aten.mm`` like the reference's product without batch dimensions,
    which the "dots" rematerialisation saves (``models.remat``)."""
    return (c @ w.flatten(1)).unflatten(-1, w.shape[1:])


def _latent(p, x, cfg, positions):
    """The shared down-projections.  Returns (q_nope, q_pe [B, S, H, *],
    c_kv [B, S, R] after ``kv_norm``, k_pe [B, S, 1, rope] roped)."""
    qc = rmsnorm(p["q_norm"], x @ p["q_down"], cfg.norm_eps)
    q = _up(qc, p["q_up"])
    q_nope, q_pe = q[..., :cfg.nope_dim], q[..., cfg.nope_dim:]
    q_pe = rope(q_pe, positions, cfg.rope_theta)
    c_kv = rmsnorm(p["kv_norm"], x @ p["kv_down"], cfg.norm_eps)
    k_pe = rope((x @ p["k_rope"])[:, :, None, :], positions, cfg.rope_theta)
    return q_nope, q_pe, c_kv, k_pe


def mla_train(p, x, cfg, positions, *, impl="chunked", chunk=1024,
              unroll: bool = False, on_cache=None):
    """Full (non-absorbed) MLA for train/prefill.  x [B, S, D] -> [B, S, D].
    ``on_cache``, if given, receives the latent cache rows the attention
    computed: {"c_kv": [B, S, R], "k_pe": [B, S, rope]}."""
    q_nope, q_pe, c_kv, k_pe = _latent(p, x, cfg, positions)
    if on_cache is not None:
        on_cache({"c_kv": c_kv, "k_pe": k_pe[:, :, 0, :]})
    k_nope = _up(c_kv, p["k_up"])
    v = _up(c_kv, p["v_up"])
    q = torch.cat([q_nope, q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe.expand(k_nope.shape[:3] + (cfg.rope_dim,))],
                  dim=-1)
    q = constrain(q, ("batch", "act_seq", "act_heads", None))
    k = constrain(k, ("batch", "act_seq", "act_heads", None))
    qk = cfg.nope_dim + cfg.rope_dim
    # v_head_dim may differ from the q/k width: pad v for the shared
    # kernel, crop the output.
    v_p = torch.nn.functional.pad(v, (0, qk - cfg.v_head_dim))
    o = attn.attend(q, k, v_p, causal=True, scale=qk ** -0.5, impl=impl,
                    chunk=chunk, unroll=unroll)
    o = o[..., :cfg.v_head_dim]
    return o.flatten(2) @ p["out"].flatten(0, 1)       # bshd,hdm->bsm


def mla_cache_shape(cfg, batch: int, cache_len: int):
    return {"c_kv": (batch, cache_len, cfg.kv_lora),
            "k_pe": (batch, cache_len, cfg.rope_dim)}


def mla_decode(p, x, cfg, cache, pos):
    """Absorbed-matrix single-token decode.

    x [B, 1, D]; ``cache`` holds c_kv [B, T, R] and k_pe [B, T, rope]
    ring caches; ``pos`` the token's position (a Python int).  The token's
    latent rows are written at slot ``pos mod T`` in place (the reference
    returns updated copies).  Returns (y [B, 1, D], cache).

    score_h(t) = q_nope_h · (W_uk_h c_t) + q_pe_h · k_pe_t
               = (W_uk_hᵀ q_nope_h) · c_t + q_pe_h · k_pe_t
    """
    pos = int(pos)
    c_kv, k_pe = cache["c_kv"], cache["k_pe"]
    positions = torch.full((x.shape[0], 1), pos, device=x.device)
    q_nope, q_pe, c_new, kpe_new = _latent(p, x, cfg, positions)
    t_len = c_kv.shape[1]
    slot = pos % t_len
    c_kv[:, slot] = c_new[:, 0].to(c_kv.dtype)
    k_pe[:, slot] = kpe_new[:, 0, 0].to(k_pe.dtype)
    # Absorb W_uk into q: q_lat [B, 1, H, R].
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p["k_up"])
    scale = (cfg.nope_dim + cfg.rope_dim) ** -0.5
    scores = (torch.einsum("bshr,btr->bhst", q_lat, c_kv.to(q_lat.dtype))
              + torch.einsum("bshd,btd->bhst", q_pe, k_pe.to(q_pe.dtype)))
    scores = scores.to(torch.float32) * scale
    k_pos, k_valid = attn.cache_slot_positions(pos, t_len,
                                               device=c_kv.device)
    ok = k_valid & (k_pos <= pos)
    scores = torch.where(ok[None, None, None, :], scores, attn.NEG)
    w = torch.softmax(scores, dim=-1)
    # Attend in latent space, then up-project once: o = (w @ c_kv) W_uv.
    o_lat = torch.einsum("bhst,btr->bshr", w.to(c_kv.dtype), c_kv)
    o = torch.einsum("bshr,rhd->bshd", o_lat, p["v_up"])
    y = torch.einsum("bshd,hdm->bsm", o, p["out"])
    return y, cache
