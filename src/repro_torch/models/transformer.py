"""Decoder / encoder transformer for the dense, MoE, VLM and audio
families — the serving path of ``repro.models.transformer`` in PyTorch.

Layers are stacked along a leading ``layers`` axis, as in the reference,
and run as a Python loop that indexes the stacked parameters by layer
(the reference's ``lax.scan``, over pairs of layers for Gemma2's
alternating windows).  An MoE config with ``first_dense_layers``
(DeepSeek-V3) has two stacks, ``dense_layers`` (a plain MLP of width
``dense_d_ff``) and ``layers`` (the MoE), run in that order.  Layer i of a
stack has window ``cfg.layer_window(i)``: with ``alt_window`` the even
layers are local (window ``alt_window``) and the odd ones global, which
is the reference's pair scan, layer j = 0 of a pair local and j = 1
global; with ``window`` (Mixtral) every layer is local.  Attention runs
the kernel ops through ``models.attention.attend``: ``flash_attention``
in the prefill and ``decode_attention`` in a decode step, both with the
softcap.  MLA (``models.mla``) runs ``flash_attention`` in the prefill and
latent einsums in decode.  Qwen2-VL's positions are M-RoPE ids [3, B, S]
and its vision prefix replaces the first ``n_vision_tokens`` embeddings;
HuBERT's frames go through the frontend projection, ``mask_emb`` where
the mask is set, and non-causal attention.

The ring caches are stacked [n_layers, B, T, KH, D] (MLA: c_kv [n, B, T,
R] and k_pe [n, B, T, rope]); T is capped by ``cfg.window`` and not by
``alt_window``, so Gemma2's local layers keep the full length and their
window masks it.  The prefill writes each layer's cache rows, the ones its
attention computed (roped K/V; MLA's c_kv after ``kv_norm`` and roped
k_pe), into the caches (the reference computes them a second time in
``_build_caches``: the same operations on the same inputs);
``transformer_decode`` writes the token in place.  An encoder's prefill
returns the full sequence's logits and no cache.

``transformer_loss`` is the reference's training loss: ``hidden_forward``
under autograd, then the chunked cross-entropy (HuBERT's masked-unit form
for the audio family) plus 0.01 x the MoE router loss.  On the card its
attention is ``flash_attention``'s forward and backward kernels
(``kernels.flash_attention.ops.FlashAttention``).  ``flags.remat``
checkpoints each layer, or each Gemma2 pair (``_group``), of that path
(``models.remat``: "full", "dots"; any other value leaves it as it is, as
the reference's ``_remat`` does); the prefill and decode never do.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embed_specs, mlp, mlp_specs,
                                       mrope, project, project_out,
                                       rmsnorm, rmsnorm_spec, rope, unembed)
from repro_torch.models.losses import chunked_ce_from_hidden, masked_unit_ce
from repro_torch.models.params import spec
from repro_torch.models.remat import remat
from repro_torch.shard.api import constrain, empty as shard_empty

__all__ = ["transformer_specs", "transformer_loss", "transformer_prefill",
           "transformer_decode", "transformer_cache_shapes",
           "transformer_cache_axes", "hidden_forward"]


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


def _layer_specs(cfg: ModelConfig, layers: int, moe: bool):
    d = cfg.d_model
    s = {"ln1": rmsnorm_spec(d, layers), "ln2": rmsnorm_spec(d, layers)}
    if cfg.post_norm:
        s["ln1_post"] = rmsnorm_spec(d, layers)
        s["ln2_post"] = rmsnorm_spec(d, layers)
    s["attn"] = (mla_mod.mla_specs(cfg, layers) if cfg.mla
                 else _attn_specs(cfg, layers))
    if moe:
        s["ffn"] = moe_mod.moe_specs(d, cfg, layers)
    else:
        s["ffn"] = mlp_specs(d, cfg.dense_d_ff or cfg.d_ff, cfg.act,
                             layers=layers)
    return s


def _stacks(cfg: ModelConfig):
    """[(stack name, MoE?, layers)] in the order the forward runs them."""
    if cfg.is_moe and cfg.first_dense_layers:
        return [("dense_layers", False, cfg.first_dense_layers),
                ("layers", True, cfg.n_layers - cfg.first_dense_layers)]
    return [("layers", cfg.is_moe, cfg.n_layers)]


def transformer_specs(cfg: ModelConfig):
    s = {"embed": embed_specs(cfg.vocab, cfg.d_model, cfg.tie_embeddings),
         "final_norm": rmsnorm_spec(cfg.d_model)}
    if cfg.family == "audio":
        s["frontend"] = {
            "proj": spec((cfg.frontend_dim, cfg.d_model), ("ffn", "embed")),
            "mask_emb": spec((cfg.d_model,), ("embed",), std=0.02)}
    for name, moe, n in _stacks(cfg):
        s[name] = _layer_specs(cfg, n, moe)
    return s


# --------------------------------------------------------------------------- #
# Blocks
# --------------------------------------------------------------------------- #
def _layer(stack, i):
    """Layer i's parameters (or caches) from the stacked tree."""
    if isinstance(stack, dict):
        return {k: _layer(v, i) for k, v in stack.items()}
    return stack[i]


def _unstack(stack) -> list:
    """Every layer's parameters of the stacked tree, as views: one
    ``torch.unbind`` a leaf.  Its backward writes the stacked leaf's
    gradient once; taking the layers one index at a time would add, for
    every layer, a zero-filled copy of the whole leaf (18 x 2.4 GB for
    each of gemma-2b's MLP leaves)."""
    if isinstance(stack, dict):
        per = {k: _unstack(v) for k, v in stack.items()}
        n = len(next(iter(per.values())))
        return [{k: v[i] for k, v in per.items()} for i in range(n)]
    return list(torch.unbind(stack, 0))


def _attention(p, x, cfg: ModelConfig, positions, window, cache=None,
               pos=None):
    """GQA attention.  Without ``cache``: a prefill over ``positions``,
    returning (out, (k, v)) with k, v [B, S, KH, D] roped.  With ``cache``
    (k, v ring caches [B, T, KH, D]): one token at ``pos``, written into
    the caches in place, returning (out, caches)."""
    q = project(x, p["wq"], "act_heads")
    k = project(x, p["wk"], "act_kv_heads")
    v = project(x, p["wv"], "act_kv_heads")
    if cfg.mrope_sections:
        q = mrope(q, positions, cfg.mrope_sections, cfg.rope_theta)
        k = mrope(k, positions, cfg.mrope_sections, cfg.rope_theta)
    else:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", "act_seq", "act_heads", None))
    k = constrain(k, ("batch", "act_seq", "act_kv_heads", None))
    v = constrain(v, ("batch", "act_seq", "act_kv_heads", None))
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
    o = constrain(o, ("batch", "act_seq", "act_heads", None))
    return project_out(o, p["wo"]), kv


def _ffn(p, x, cfg, flags, moe: bool, want_aux: bool):
    """The layer's MLP or MoE.  Returns (y, aux): the router loss of an
    MoE layer when ``want_aux``, else None."""
    if not moe:
        return mlp(p, x, cfg.act), None
    y, aux = moe_mod.moe_ffn(p, x, cfg, impl=flags.moe_impl)
    return y, (moe_mod.router_aux_loss(aux, cfg.n_experts) if want_aux
               else None)


def _block(p, x, cfg, flags, positions, window, moe, cache=None, pos=None,
           on_cache=None, want_aux=False):
    """One layer.  Without ``cache``, a prefill over ``positions`` that
    hands ``on_cache`` the layer's cache rows ({"k", "v"} [B, S, KH, D];
    MLA {"c_kv", "k_pe"}); with it, one token at ``pos`` against the
    layer's ring caches, written in place.  Returns (x, aux)."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla:
        if cache is None:
            a = mla_mod.mla_train(p["attn"], h, cfg, positions,
                                  on_cache=on_cache)
        else:
            a, _ = mla_mod.mla_decode(p["attn"], h, cfg, cache, pos)
    else:
        a, kv = _attention(p["attn"], h, cfg, positions, window,
                           cache=cache, pos=pos)
        if cache is None and on_cache is not None:
            on_cache({"k": kv[0], "v": kv[1]})
    if cfg.post_norm:
        a = rmsnorm(p["ln1_post"], a, cfg.norm_eps)
    x = x + a
    f, aux = _ffn(p["ffn"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg, flags,
                  moe, want_aux)
    if cfg.post_norm:
        f = rmsnorm(p["ln2_post"], f, cfg.norm_eps)
    return x + f, aux


def _embed_inputs(params, cfg: ModelConfig, flags, batch):
    """The family's input embedding.  Returns (x [B, S, D], positions:
    [3, B, S] M-RoPE ids, else [1, S])."""
    dt = getattr(torch, flags.compute_dtype)
    if cfg.family == "audio":
        fe = params["frontend"]
        x = batch["features"].to(dt) @ fe["proj"].to(dt)
        x = torch.where(batch["mask"][..., None], fe["mask_emb"].to(dt), x)
        return x, torch.arange(x.shape[1], device=x.device)[None, :]
    x = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale,
              d=cfg.d_model).to(dt)
    if cfg.family == "vlm" and "vision_embeds" in batch:
        nv = batch["vision_embeds"].shape[1]
        x = torch.cat([batch["vision_embeds"].to(dt), x[:, nv:]], dim=1)
    if cfg.mrope_sections:
        return x, batch["positions"]
    return x, torch.arange(x.shape[1], device=x.device)[None, :]


def _group(cfg: ModelConfig) -> int:
    """Layers a unit of the training path runs: Gemma2's local/global
    pair with ``alt_window``, else one (the reference's ``_group``)."""
    return 2 if cfg.alt_window is not None else 1


def _forward(params, cfg, flags, batch, on_cache=None, want_aux=False,
             remat_policy="none"):
    """Embed -> layer stacks -> final norm.  ``on_cache(stack, i, rows)``
    receives each layer's cache rows.  Each unit of :func:`_group` layers
    runs under ``remat_policy`` (``models.remat``; the training path's
    ``flags.remat``, "none" for the prefill).  Returns (hidden, the summed
    router loss when ``want_aux``, else None)."""
    x, positions = _embed_inputs(params, cfg, flags, batch)
    x = constrain(x, ("batch", "act_seq", None))
    total = None
    g = _group(cfg)
    for name, moe, n in _stacks(cfg):
        layers = _unstack(params[name])
        for i0 in range(0, n, g):
            def body(x, unit, i0=i0, name=name, moe=moe):
                auxes = []
                for i, layer in enumerate(unit, i0):
                    keep = (None if on_cache is None else
                            lambda rows, i=i: on_cache(name, i, rows))
                    x, aux = _block(layer, x, cfg, flags, positions,
                                    cfg.layer_window(i), moe, on_cache=keep,
                                    want_aux=want_aux)
                    if aux is not None:
                        auxes.append(aux)
                return x, tuple(auxes)

            x, auxes = remat(body, remat_policy)(x, layers[i0:i0 + g])
            for aux in auxes:
                total = aux if total is None else total + aux
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), total


def hidden_forward(params, cfg: ModelConfig, flags, batch):
    """Embed -> layer stacks -> final norm, each unit of layers
    rematerialised as ``flags.remat`` says.  Returns (hidden, aux): aux is
    the MoE layers' summed router loss (``moe.router_aux_loss``), 0 for a
    config without experts."""
    hidden, aux = _forward(params, cfg, flags, batch, want_aux=True,
                           remat_policy=flags.remat)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    return hidden, aux


def transformer_loss(params, cfg: ModelConfig, flags, batch,
                     aux_weight: float = 0.01):
    """(CE + ``aux_weight`` x router loss, {"ce", "aux"}): the token-mean
    cross-entropy of the next-token targets (``batch["loss_mask"]`` if
    given; the audio family's masked units), in ``flags.loss_chunks``
    chunks."""
    hidden, aux = hidden_forward(params, cfg, flags, batch)
    if cfg.family == "audio":
        loss = masked_unit_ce(params["embed"], hidden, batch["targets"],
                              batch["mask"], n_chunks=flags.loss_chunks)
    else:
        loss = chunked_ce_from_hidden(
            params["embed"], hidden, batch["targets"],
            batch.get("loss_mask"), softcap=cfg.final_softcap,
            n_chunks=flags.loss_chunks)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


# --------------------------------------------------------------------------- #
# Serving: prefill + decode with ring caches
# --------------------------------------------------------------------------- #
def transformer_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    """Cache shapes (leading ``layers`` axis).  The ring length caps at
    ``cfg.window``."""
    if cfg.window is not None:
        cache_len = min(cache_len, cfg.window)
    if cfg.mla:
        per = mla_mod.mla_cache_shape(cfg, batch, cache_len)
    else:
        kv = (batch, cache_len, cfg.n_kv_heads, cfg.head_dim)
        per = {"k": kv, "v": kv}
    return {name: {k: (n,) + v for k, v in per.items()}
            for name, _, n in _stacks(cfg)}


def transformer_cache_axes(cfg: ModelConfig):
    """Logical axis names of ``transformer_cache_shapes``' tree."""
    if cfg.mla:
        per = {"c_kv": (None, "batch", "cache_seq", "kv_lora"),
               "k_pe": (None, "batch", "cache_seq", None)}
    else:
        per = {"k": (None, "batch", "cache_seq", "act_kv_heads", None),
               "v": (None, "batch", "cache_seq", "act_kv_heads", None)}
    return {name: per for name, _, _ in _stacks(cfg)}


def transformer_prefill(params, cfg: ModelConfig, flags, batch,
                        cache_len: int):
    """The forward over the prompt for the last position's logits, with
    every layer's cache rows ring-placed into caches of ``cache_len``
    slots (capped by ``cfg.window``), preallocated and filled layer by
    layer.  Returns (logits [B, 1, V] float32, softcapped as the config
    says; caches).  An encoder returns the logits of every position [B,
    S, V] and ``{}``."""
    if cfg.is_encoder:
        hidden, _ = _forward(params, cfg, flags, batch)
        return unembed(params["embed"], hidden,
                       softcap=cfg.final_softcap), {}
    ref = batch["features"] if cfg.family == "audio" else batch["tokens"]
    b, s_len = ref.shape[:2]
    dt = getattr(torch, flags.compute_dtype)
    shapes = transformer_cache_shapes(cfg, b, cache_len)
    axes = transformer_cache_axes(cfg)
    caches = {stack: {name: shard_empty(shape, axes[stack][name], dt,
                                        ref.device)
                      for name, shape in per.items()}
              for stack, per in shapes.items()}

    def on_cache(stack, i, rows):
        for name, t in rows.items():
            dst = caches[stack][name]
            dst[i] = attn_mod.ring_place(t, s_len, dst.shape[2])

    hidden, _ = _forward(params, cfg, flags, batch, on_cache)
    logits = unembed(params["embed"], hidden[:, -1:, :],
                     softcap=cfg.final_softcap)
    return logits, caches


def transformer_decode(params, cfg: ModelConfig, flags, caches, tokens, pos):
    """One token per sequence.  tokens [B, 1]; ``pos`` its position (a
    Python int).  Returns (logits [B, 1, V] float32, caches), the caches
    updated in place."""
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name}: an encoder-only arch has no decode "
                         f"step")
    x = embed(params["embed"], tokens, scale=cfg.embed_scale,
              d=cfg.d_model).to(getattr(torch, flags.compute_dtype))
    x = constrain(x, ("batch", None, None))
    b = tokens.shape[0]
    if cfg.mrope_sections:
        positions = torch.full((3, b, 1), int(pos), device=x.device)
    else:
        positions = torch.full((b, 1), int(pos), device=x.device)
    for name, moe, n in _stacks(cfg):
        stack = caches[name]
        for i in range(n):
            cache = ({k: v[i] for k, v in stack.items()} if cfg.mla
                     else (stack["k"][i], stack["v"][i]))
            x, _ = _block(_layer(params[name], i), x, cfg, flags, positions,
                          cfg.layer_window(i), moe, cache=cache, pos=pos)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x, softcap=cfg.final_softcap), caches
