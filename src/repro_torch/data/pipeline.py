"""Deterministic synthetic batches — ``repro.data.pipeline``.

``make_batch`` is numpy only: the same ``(seed, step)`` gives the same
arrays as the reference (the same generator, drawn in the same order), so
both packages serve the same prompts, frames and vision prefixes.
``SyntheticLM`` places each step's batch on the port's device (the card
unless asked; restart-safe: step k regenerates the stream a failed run
saw); with ``shardings`` (``train.step.batch_shardings``) each rank puts
only its shard of the global batch on the device, as a DTensor, and the
global stream stays the same function of (seed, step).  ``Prefetcher``
keeps the next batches in flight on a background thread.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["SyntheticLM", "Prefetcher", "make_batch"]


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


class SyntheticLM:
    """Deterministic stream of global batches on ``device`` (the card
    unless asked): ``source(step)`` is ``make_batch(seed=seed,
    step=step)`` as tensors; with ``shardings`` (a dict of
    ``shard.NamedSharding`` by leaf name) as DTensors, each rank placing
    its own slice (no collective)."""

    def __init__(self, cfg, batch: int, seq: int, *, seed: int = 0,
                 device="cuda", shardings=None):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.seed = seed
        self.device = resolve_device(device)
        self.shardings = shardings

    def __call__(self, step: int) -> dict:
        host = make_batch(self.cfg, "train", self.batch, self.seq,
                          seed=self.seed, step=step)
        if self.shardings is None:
            return {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in host.items()}
        return {k: self.shardings[k].from_host(v, self.device)
                for k, v in host.items()}


class Prefetcher:
    """Background-thread prefetch of the next ``depth`` batches: yields
    ``(step, batch)`` in step order from ``start_step``."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            try:
                self.q.put((step, self.source(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
