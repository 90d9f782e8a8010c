"""Serve step factory — ``repro.train.step.make_serve_step`` without a
mesh (one card).  The training step waits for the training slice
(ROADMAP A12)."""

from __future__ import annotations

import torch

__all__ = ["make_serve_step"]


def make_serve_step(model, flags):
    """Returns (prefill_fn, decode_fn), both greedy.

    prefill_fn(params, batch, cache_len) -> (next_tokens [B, 1], caches),
    ``batch`` the family's inputs (tokens; a VLM's ``vision_embeds`` and
    ``positions`` with them; an encoder's ``features`` and ``mask``, whose
    prefill gives a token for every position [B, S] and no cache);
    decode_fn(params, caches, tokens [B, 1], pos) -> (next_tokens [B, 1],
    caches) — one new token per sequence against the standing cache.
    """

    def prefill(params, batch, cache_len):
        logits, caches = model.prefill(params, batch, flags, cache_len)
        return torch.argmax(logits, dim=-1), caches

    def decode(params, caches, tokens, pos):
        logits, new_caches = model.decode(params, caches, tokens, pos, flags)
        return torch.argmax(logits, dim=-1), new_caches

    return prefill, decode
