"""Deterministic synthetic batches — ``repro.data.pipeline.make_batch``.

numpy only: the same ``(seed, step)`` gives the same arrays as the
reference (the same generator, drawn in the same order), so both packages
serve the same prompts, frames and vision prefixes.  Device placement and
prefetch wait for the training slice.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_batch"]


def _zipf_tokens(rng: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Zipf-ish token draw (realistic rank-frequency skew)."""
    u = rng.random(shape)
    ranks = np.floor(np.exp(u * np.log(vocab))).astype(np.int64) - 1
    return np.clip(ranks, 0, vocab - 1)


def make_batch(cfg, shape_name: str, batch: int, seq: int, *, seed: int,
               step: int, np_dtype=np.int32) -> dict:
    """One host-side batch for the arch's family (numpy): tokens and
    next-token targets; audio: frame features, the unit mask and unit
    targets; VLM: also the vision prefix's embeddings and the [3, B, S]
    M-RoPE ids (a (t, h, w) grid over the prefix, text continuing in
    t)."""
    del shape_name
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    if cfg.family == "audio":
        return {
            "features": rng.normal(size=(batch, seq, cfg.frontend_dim)
                                   ).astype(np.float32),
            "mask": rng.random((batch, seq)) < 0.08,
            "targets": _zipf_tokens(rng, (batch, seq), cfg.vocab
                                    ).astype(np_dtype),
        }
    toks = _zipf_tokens(rng, (batch, seq + 1), cfg.vocab).astype(np_dtype)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        nv = cfg.n_vision_tokens
        out["vision_embeds"] = (0.02 * rng.normal(
            size=(batch, nv, cfg.d_model))).astype(np.float32)
        side = max(int(np.sqrt(nv)), 1)
        tpos = np.concatenate([np.zeros(nv), np.arange(seq - nv) + 1])
        hpos = np.concatenate([np.arange(nv) // side, np.zeros(seq - nv)])
        wpos = np.concatenate([np.arange(nv) % side, np.zeros(seq - nv)])
        pos = np.stack([tpos, hpos, wpos]).astype(np_dtype)     # [3, S]
        out["positions"] = np.broadcast_to(pos[:, None, :],
                                           (3, batch, seq)).copy()
    return out
