"""xLSTM language model: a mixed mLSTM / sLSTM block stack — the serving
path of ``repro.models.xlstm_model`` in PyTorch.

Parameters are the reference's tree: ``blocks`` is a list of per-block
dicts, in block order.  Serving state is a list with one entry a block: a
dict (conv, c) for an mLSTM block and a 4-tuple (h, c, n, m) for an sLSTM
block; ``xlstm_cache_axes`` names their axes.  ``xlstm_loss`` is the
reference's training loss over the same forward (``_forward``) as
``xlstm_prefill``: the mLSTM blocks' gradients come from ``ssm_scan``'s
backward kernel on the card (its plain backward on the CPU), the sLSTM's
loop over time trains through plain autograd (no TPU kernel computes
it).  ``flags.remat`` checkpoints each block of the training path
(``models.remat``).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (embed, embed_specs, rmsnorm,
                                       rmsnorm_spec, unembed)
from repro_torch.models.losses import chunked_ce_from_hidden
from repro_torch.models.remat import remat
from repro_torch.models.xlstm import (mlstm_block, mlstm_decode, mlstm_specs,
                                      mlstm_state_shapes, slstm_block,
                                      slstm_decode, slstm_specs,
                                      slstm_state_shapes)
from repro_torch.shard.api import constrain

__all__ = ["xlstm_specs", "xlstm_loss", "xlstm_prefill", "xlstm_decode_step",
           "xlstm_cache_shapes", "xlstm_cache_axes", "block_kinds"]


def block_kinds(cfg: ModelConfig) -> list[str]:
    """'slstm' at every (i % slstm_every == slstm_at), else 'mlstm'."""
    if not cfg.slstm_every:
        return ["mlstm"] * cfg.n_layers
    return ["slstm" if i % cfg.slstm_every == cfg.slstm_at else "mlstm"
            for i in range(cfg.n_layers)]


def xlstm_specs(cfg: ModelConfig):
    blocks = [mlstm_specs(cfg) if k == "mlstm" else slstm_specs(cfg)
              for k in block_kinds(cfg)]
    return {"embed": embed_specs(cfg.vocab, cfg.d_model, cfg.tie_embeddings),
            "blocks": blocks, "final_norm": rmsnorm_spec(cfg.d_model)}


def _embed(params, cfg, flags, tokens):
    return embed(params["embed"], tokens, scale=cfg.embed_scale,
                 d=cfg.d_model).to(getattr(torch, flags.compute_dtype))


def xlstm_cache_shapes(cfg: ModelConfig, batch: int, cache_len: int = 0):
    return [mlstm_state_shapes(cfg, batch) if kind == "mlstm"
            else slstm_state_shapes(cfg, batch) for kind in block_kinds(cfg)]


def xlstm_cache_axes(cfg: ModelConfig):
    """Logical axis names of ``xlstm_cache_shapes``' list."""
    out = []
    for kind in block_kinds(cfg):
        if kind == "mlstm":
            out.append({"conv": ("batch", None, "act_ffn"),
                        "c": ("batch", "act_heads", None, None)})
        else:
            out.append(tuple(("batch", "act_heads", None) for _ in range(4)))
    return out


def _forward(params, cfg, flags, batch, states=None, remat_policy="none"):
    """The blocks in order over the whole sequence -> (final-normed hidden
    [B, S, D], every block's final state).  ``states`` (one entry a block,
    as ``xlstm_cache_shapes``) start the blocks; None starts them empty.
    Under a ``remat_policy`` other than "none" (the training path's
    ``flags.remat``) each block is checkpointed whole (``models.remat``,
    "full", as the reference's ``jax.checkpoint`` of each block)."""
    x = constrain(_embed(params, cfg, flags, batch["tokens"]),
                  ("batch", "act_seq", None))
    policy = "full" if remat_policy != "none" else "none"
    new_states = []
    for i, (kind, p) in enumerate(zip(block_kinds(cfg), params["blocks"])):
        fn = remat(mlstm_block if kind == "mlstm" else slstm_block, policy)
        x, st = fn(p, x, cfg, None if states is None else states[i])
        new_states.append(st)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), new_states


def xlstm_loss(params, cfg, flags, batch, aux_weight: float = 0.0):
    """(token-mean CE, {"ce"}) of the next-token targets, in
    ``flags.loss_chunks`` chunks; ``aux_weight`` is the reference's and
    unused.  ``flags.remat`` other than "none" checkpoints each block
    (``_forward``)."""
    del aux_weight
    hidden, _ = _forward(params, cfg, flags, batch, remat_policy=flags.remat)
    loss = chunked_ce_from_hidden(params["embed"], hidden, batch["targets"],
                                  batch.get("loss_mask"),
                                  n_chunks=flags.loss_chunks)
    return loss, {"ce": loss}


def xlstm_prefill(params, cfg, flags, batch, cache_len: int = 0):
    """The parallel forward for the last position's logits, with every
    block's final state.  ``flags.analysis_unroll`` is accepted and
    ignored.  Returns (logits [B, 1, V] float32, states)."""
    hidden, states = _forward(params, cfg, flags, batch)
    return unembed(params["embed"], hidden[:, -1:, :]), states


def xlstm_decode_step(params, cfg, flags, states, tokens, pos):
    """One token per sequence.  tokens [B, 1]; ``pos`` is unused (the
    state carries the position).  Returns (logits [B, 1, V] float32, the
    new states)."""
    del pos
    x = _embed(params, cfg, flags, tokens)
    new_states = []
    for kind, p, st in zip(block_kinds(cfg), params["blocks"], states):
        fn = mlstm_decode if kind == "mlstm" else slstm_decode
        x, st2 = fn(p, x, cfg, st)
        new_states.append(st2)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(params["embed"], x), new_states
