"""Deterministic synthetic batches — ``repro.data.pipeline.make_batch``.

numpy only: the same ``(seed, step)`` gives the same arrays as the
reference, so both packages serve the same prompts.  The audio and VLM
batches, device placement and prefetch wait for their slices.
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
    """One host-side batch of tokens and next-token targets (numpy)."""
    del shape_name
    if cfg.family in ("audio", "vlm"):
        raise NotImplementedError(f"{cfg.family} batches come with their "
                                  "family (ROADMAP A11)")
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    toks = _zipf_tokens(rng, (batch, seq + 1), cfg.vocab).astype(np_dtype)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
