"""Decoder transformer for the dense family — the serving path of
``repro.models.transformer`` in PyTorch.

Layers are stacked along a leading ``layers`` axis, as in the reference,
and run as a Python loop that indexes the stacked parameters by layer
(the reference's ``lax.scan``, over pairs of layers for Gemma2's
alternating windows).  Layer i's window is ``cfg.layer_window(i)``: with
``alt_window`` the even layers are local (window ``alt_window``) and the
odd ones global, which is the reference's pair scan, layer j = 0 of a pair
local and j = 1 global.  Attention runs the kernel ops through
``models.attention.attend``: ``flash_attention`` in the prefill and
``decode_attention`` in a decode step, both with the softcap.

The ring caches are stacked [n_layers, B, T, KH, D]; T is capped by
``cfg.window`` and not by ``alt_window``, so the local layers keep the
full length and their window masks it.  The prefill writes each layer's
roped K/V, the ones its attention computed, into the caches (the
reference projects them a second time in ``_build_caches``: the same
operations on the same inputs); ``transformer_decode`` writes the token in
place.  The MoE, MLA, M-RoPE, VLM and audio paths, and training
(``transformer_loss``), are not ported yet (ROADMAP A11, A12).
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embed_specs, mlp, mlp_specs,
                                       rmsnorm, rmsnorm_spec, rope, unembed)
from repro_torch.models.params import spec

__all__ = ["transformer_specs", "transformer_prefill", "transformer_decode",
           "transformer_cache_shapes", "hidden_forward"]


def _refuse(cfg: ModelConfig) -> None:
    """Raise for what the port's transformer does not serve yet."""
    todo = [what for what, on in (
        ("MLA (mla.py)", cfg.mla), ("MoE (moe.py)", cfg.is_moe),
        ("M-RoPE", cfg.mrope_sections is not None),
        (f"the {cfg.family} family", cfg.family in ("vlm", "audio")))
        if on]
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(todo)} not ported yet (ROADMAP A11); "
            f"the port's transformer serves the dense family")


# --------------------------------------------------------------------------- #
# Parameter specs
# --------------------------------------------------------------------------- #
def _attn_specs(cfg: ModelConfig, layers: int):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ll = ("layers",)
    return {
        "wq": spec((layers, d, h, hd), ll + ("embed", "heads", "head_dim")),
        "wk": spec((layers, d, kv, hd),
                   ll + ("embed", "kv_heads", "head_dim")),
        "wv": spec((layers, d, kv, hd),
                   ll + ("embed", "kv_heads", "head_dim")),
        "wo": spec((layers, h, hd, d), ll + ("heads", "head_dim", "embed")),
    }


def _layer_specs(cfg: ModelConfig, layers: int):
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d, layers), "ln2": rmsnorm_spec(d, layers)}
    if cfg.post_norm:
        s["ln1_post"] = rmsnorm_spec(d, layers)
        s["ln2_post"] = rmsnorm_spec(d, layers)
    s["attn"] = _attn_specs(cfg, layers)
    s["ffn"] = mlp_specs(d, cfg.dense_d_ff or cfg.d_ff, cfg.act,
                         layers=layers)
    return s


def transformer_specs(cfg: ModelConfig):
    _refuse(cfg)
    return {"embed": embed_specs(cfg.vocab, cfg.d_model, cfg.tie_embeddings),
            "final_norm": rmsnorm_spec(cfg.d_model),
            "layers": _layer_specs(cfg, cfg.n_layers)}


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _layer(stack, i):
    """Layer i's parameters (or caches) from the stacked tree."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _attention(p, x, cfg: ModelConfig, positions, window, cache=None,
               pos=None):
    """GQA attention.  Without ``cache``: a prefill over ``positions``,
    returning (out, (k, v)) with k, v [B, S, KH, D] roped.  With ``cache``
    (k, v ring caches [B, T, KH, D]): one token at ``pos``, written into
    the caches in place, returning (out, caches)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = (cfg.query_scale if cfg.query_scale is not None
             else cfg.head_dim ** -0.5)
    kw = dict(causal=cfg.causal, window=window, softcap=cfg.attn_softcap,
              scale=scale)
    if cache is None:
        o = attn_mod.attend(q, k, v, **kw)
        kv = (k, v)
    else:
        kv = attn_mod.write_kv(cache[0], cache[1], k, v, pos)
        o = attn_mod.attend(q, *kv, pos=pos, **kw)
    return torch.einsum("bshk,hkd->bsd", o, p["wo"]), kv


def _block(p, x, cfg, positions, window, cache=None, pos=None):
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    a, kv = _attention(p["attn"], h, cfg, positions, window, cache=cache,
                       pos=pos)
    if cfg.post_norm:
        a = rmsnorm(p["ln1_post"], a, cfg.norm_eps)
    x = x + a
    f = mlp(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    if cfg.post_norm:
        f = rmsnorm(p["ln2_post"], f, cfg.norm_eps)
    return x + f, kv


def _embed(params, cfg, flags, tokens):
    return embed(params["embed"], tokens, scale=cfg.embed_scale,
                 d=cfg.d_model).to(getattr(torch, flags.compute_dtype))


def _forward(params, cfg, flags, tokens, on_kv=None):
    """Embed -> layers -> final norm over positions 0..S-1; ``on_kv(i, k,
    v)`` receives each layer's roped K/V."""
    _refuse(cfg)
    x = _embed(params, cfg, flags, tokens)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for i in range(cfg.n_layers):
        x, (k, v) = _block(_layer(params["layers"], i), x, cfg, positions,
                           cfg.layer_window(i))
        if on_kv is not None:
            on_kv(i, k, v)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps)


def hidden_forward(params, cfg: ModelConfig, flags, batch):
    """Embed -> layer stack -> final norm.  Returns (hidden, aux): aux is
    the MoE router loss, 0 for the dense family."""
    hidden = _forward(params, cfg, flags, batch["tokens"])
    return hidden, torch.zeros((), dtype=torch.float32, device=hidden.device)


# --------------------------------------------------------------------------- #
# Serving: prefill + decode with ring caches
# --------------------------------------------------------------------------- #
def transformer_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    """Cache shapes (leading ``layers`` axis).  The ring length caps at
    ``cfg.window``."""
    _refuse(cfg)
    if cfg.window is not None:
        cache_len = min(cache_len, cfg.window)
    per = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
    return {"layers": {"k": per, "v": per}}


def transformer_prefill(params, cfg: ModelConfig, flags, batch,
                        cache_len: int):
    """The forward over the prompt for the last position's logits, with
    every layer's K/V ring-placed into caches of ``cache_len`` slots
    (capped by ``cfg.window``), preallocated and filled layer by layer.
    Returns (logits [B, 1, V] float32, softcapped as the config says;
    caches)."""
    tokens = batch["tokens"]
    b, s_len = tokens.shape
    shape = transformer_cache_shapes(cfg, b, cache_len)["layers"]["k"]
    dt = getattr(torch, flags.compute_dtype)
    caches = {"layers": {name: torch.empty(shape, dtype=dt,
                                           device=tokens.device)
                         for name in ("k", "v")}}

    def on_kv(i, k, v):
        for name, t in (("k", k), ("v", v)):
            caches["layers"][name][i] = attn_mod.ring_place(t, s_len,
                                                            shape[2])

    hidden = _forward(params, cfg, flags, tokens, on_kv)
    logits = unembed(params["embed"], hidden[:, -1:, :],
                     softcap=cfg.final_softcap)
    return logits, caches


def transformer_decode(params, cfg: ModelConfig, flags, caches, tokens, pos):
    """One token per sequence.  tokens [B, 1]; ``pos`` its position (a
    Python int).  Returns (logits [B, 1, V] float32, caches), the caches
    updated in place."""
    _refuse(cfg)
    x = _embed(params, cfg, flags, tokens)
    positions = torch.full((tokens.shape[0], 1), int(pos), device=x.device)
    stack = caches["layers"]
    for i in range(cfg.n_layers):
        x, _ = _block(_layer(params["layers"], i), x, cfg, positions,
                      cfg.layer_window(i), cache=(stack["k"][i],
                                                  stack["v"][i]), pos=pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, softcap=cfg.final_softcap), caches
