"""Zamba2-style hybrid: a Mamba2 backbone and one weight-SHARED attention
block — the serving path of ``repro.models.zamba`` in PyTorch.

The backbone runs in groups of ``cfg.attn_every`` Mamba2 blocks, and the
single shared attention+MLP block runs at the group boundaries (the same
weights at every site; the released model's per-site LoRA deltas are
omitted, as in the reference).  Leftover blocks (``n_layers %
attn_every``) run as a tail without attention.  The reference's
``lax.scan``s over layers are Python loops here.

Parameters are a nested dict of tensors with the reference's key names
and layouts (``mamba.*`` stacked [n_layers, ...]), so they convert from
the JAX package one array to one tensor.  Serving state: per-layer Mamba2
(conv, ssm) states stacked [n_layers, ...] and a per-site KV ring cache
stacked [n_sites, B, T, KH, D] for the shared block.  ``zamba_decode``
updates the caches in place and returns them; ``zamba_cache_axes`` names
their axes.  ``zamba_loss`` is the reference's training loss over the
same forward (``_forward``) as ``zamba_prefill``, under autograd: its
gradients come from the backward kernels of ``ssm_scan`` and ``flash_attention`` on the card and
from their plain backwards on the CPU.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention as attn_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embed_specs, mlp, mlp_specs,
                                       project, project_out, rmsnorm,
                                       rmsnorm_spec, rope, unembed)
from repro_torch.models.losses import chunked_ce_from_hidden
from repro_torch.models.params import spec
from repro_torch.models.remat import remat
from repro_torch.models.ssm import (mamba2_block, mamba2_decode,
                                    mamba2_specs, mamba2_state_shapes)
from repro_torch.shard.api import constrain

__all__ = ["zamba_specs", "zamba_loss", "zamba_prefill", "zamba_decode",
           "zamba_cache_shapes", "zamba_cache_axes"]


def _sites(cfg) -> tuple[int, int]:
    """(number of shared-attention sites, tail mamba blocks)."""
    n_sites = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers - n_sites * cfg.attn_every
    return n_sites, tail


def zamba_specs(cfg: ModelConfig):
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    shared = {
        "ln1": rmsnorm_spec(d),
        "wq": spec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wv": spec((d, kv, hd), ("embed", "kv_heads", "head_dim")),
        "wo": spec((h, hd, d), ("heads", "head_dim", "embed")),
        "ln2": rmsnorm_spec(d),
        "mlp": mlp_specs(d, cfg.d_ff, cfg.act),
    }
    return {
        "embed": embed_specs(cfg.vocab, d, cfg.tie_embeddings),
        "mamba": mamba2_specs(cfg, cfg.n_layers),
        "shared": shared,
        "final_norm": rmsnorm_spec(d),
    }


def _layer(params, i):
    return {name: a[i] for name, a in params["mamba"].items()}


def _shared_attn(p, x, cfg, positions, cache=None, pos=None):
    """The shared block at one site.  Without ``cache``: a prefill over
    positions 0..S-1, returning the site's (k, v) [B, S, KH, D].  With
    ``cache`` (dict k, v): one token at ``pos``, written into the ring
    cache in place, which is returned."""
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    q = project(h, p["wq"], "act_heads")
    k = project(h, p["wk"], "act_kv_heads")
    v = project(h, p["wv"], "act_kv_heads")
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = constrain(q, ("batch", "act_seq", "act_heads", None))
    if cache is None:
        o = attn_mod.attend(q, k, v, causal=True, window=cfg.window)
        new_c = (k, v)
    else:
        ck, cv = attn_mod.write_kv(cache["k"], cache["v"], k, v, pos)
        o = attn_mod.attend(q, ck, cv, causal=True, window=cfg.window,
                            pos=pos)
        new_c = (ck, cv)
    x = x + project_out(o, p["wo"])
    x = x + mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps), cfg.act)
    return x, new_c


def _unit(params, x, cfg, positions, lo, hi, shared):
    """Mamba2 blocks ``lo``..``hi``-1, then the shared block when
    ``shared`` -> (x, each block's state dict (conv, ssm), the site's
    (k, v) [B, S, KH, D] or None)."""
    states = []
    for i in range(lo, hi):
        y, st = mamba2_block(_layer(params, i), x, cfg)
        x = x + y
        states.append(st)
    kv = None
    if shared:
        x, kv = _shared_attn(params["shared"], x, cfg, positions)
    return x, states, kv


def _forward(params, cfg, flags, batch, remat_policy="none"):
    """The parallel forward -> (final-normed hidden [B, S, D], each
    layer's Mamba2 state dict (conv, ssm), each site's (k, v) [B, S, KH,
    D]): each group of ``attn_every`` Mamba2 blocks followed by the shared
    block, then the tail blocks.  Under a ``remat_policy`` other than
    "none" (the training path's ``flags.remat``) each group and each tail
    block is checkpointed whole (``models.remat``, "full", as the
    reference's ``jax.checkpoint`` of ``group`` and ``tail_block``)."""
    dt = getattr(torch, flags.compute_dtype)
    x = embed(params["embed"], batch["tokens"], scale=cfg.embed_scale,
              d=cfg.d_model).to(dt)
    x = constrain(x, ("batch", "act_seq", None))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    n_sites, _ = _sites(cfg)
    k = cfg.attn_every
    units = ([(s * k, (s + 1) * k, True) for s in range(n_sites)]
             + [(i, i + 1, False) for i in range(n_sites * k, cfg.n_layers)])
    run = remat(_unit, "full" if remat_policy != "none" else "none")
    states, kvs = [], []
    for lo, hi, shared in units:
        x, st, kv = run(params, x, cfg, positions, lo, hi, shared)
        states += st
        if kv is not None:
            kvs.append(kv)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), states, kvs


def zamba_loss(params, cfg, flags, batch, aux_weight: float = 0.0):
    """(token-mean CE, {"ce"}) of the next-token targets, in
    ``flags.loss_chunks`` chunks; ``aux_weight`` is the reference's and
    unused (no router).  ``flags.remat`` other than "none" checkpoints each
    group and tail block (``_forward``)."""
    del aux_weight
    hidden, _, _ = _forward(params, cfg, flags, batch,
                            remat_policy=flags.remat)
    loss = chunked_ce_from_hidden(params["embed"], hidden, batch["targets"],
                                  batch.get("loss_mask"),
                                  n_chunks=flags.loss_chunks)
    return loss, {"ce": loss}


def zamba_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int):
    n_sites, _ = _sites(cfg)
    ss = mamba2_state_shapes(cfg, batch)
    if cfg.window is not None:
        cache_len = min(cache_len, cfg.window)
    return {
        "conv": (cfg.n_layers,) + ss["conv"],
        "ssm": (cfg.n_layers,) + ss["ssm"],
        "attn_k": (n_sites, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
        "attn_v": (n_sites, batch, cache_len, cfg.n_kv_heads, cfg.head_dim),
    }


def zamba_cache_axes(cfg: ModelConfig):
    """Logical axis names of ``zamba_cache_shapes``' tree."""
    return {"conv": (None, "batch", None, "ssm_inner"),
            "ssm": (None, "batch", "act_heads", None, None),
            "attn_k": (None, "batch", "cache_seq", "act_kv_heads", None),
            "attn_v": (None, "batch", "cache_seq", "act_kv_heads", None)}


def zamba_decode(params, cfg, flags, caches, tokens, pos):
    """One token per sequence.  tokens [B, 1]; ``pos`` its position (a
    Python int).  Returns (logits [B, 1, V] float32, caches), the caches
    updated in place."""
    dt = getattr(torch, flags.compute_dtype)
    x = embed(params["embed"], tokens, scale=cfg.embed_scale,
              d=cfg.d_model).to(dt)
    positions = torch.full((tokens.shape[0], 1), int(pos),
                           device=x.device)
    n_sites, _ = _sites(cfg)

    def mamba(i, x):
        st = {"conv": caches["conv"][i], "ssm": caches["ssm"][i]}
        y, st2 = mamba2_decode(_layer(params, i), x, cfg, st)
        caches["conv"][i] = st2["conv"]
        caches["ssm"][i] = st2["ssm"]
        return x + y

    # The shared block after each group of attn_every layers, then the tail.
    for site in range(n_sites):
        for j in range(cfg.attn_every):
            x = mamba(site * cfg.attn_every + j, x)
        x, _ = _shared_attn(params["shared"], x, cfg, positions,
                            cache={"k": caches["attn_k"][site],
                                   "v": caches["attn_v"][site]}, pos=pos)
    for i in range(n_sites * cfg.attn_every, cfg.n_layers):
        x = mamba(i, x)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), caches


def zamba_prefill(params, cfg, flags, batch, cache_len: int):
    """The parallel forward (``_forward``) for the last position's logits,
    with every state: each Mamba2 layer's (conv, ssm) from its chunked
    scan, each site's K/V ring-placed into a cache of ``cache_len`` slots.

    The reference projects a site's K/V a second time for the cache; the
    port keeps the ones the site's attention computed, the same operations
    on the same inputs.  Returns (logits [B, 1, V] float32, caches).
    """
    hidden, states, kvs = _forward(params, cfg, flags, batch)
    s_len = hidden.shape[1]
    if cfg.window is not None:
        cache_len = min(cache_len, cfg.window)
    ring = lambda t: attn_mod.ring_place(t, s_len, cache_len)
    logits = unembed(params["embed"], hidden[:, -1:, :])
    caches = {"conv": torch.stack([st["conv"] for st in states]),
              "ssm": torch.stack([st["ssm"] for st in states]),
              "attn_k": torch.stack([ring(k) for k, _ in kvs]),
              "attn_v": torch.stack([ring(v) for _, v in kvs])}
    return logits, caches
