"""Model API: family dispatch behind one namespace — ``repro.models.api``
for every family of the reference.

``build_model(cfg)`` returns a :class:`Model` whose methods close over the
architecture config; ``RuntimeFlags`` stay explicit arguments, as in the
reference.  ``loss`` is ``transformer_loss`` for the transformer families,
``zamba_loss`` for the hybrid and ``xlstm_loss`` for the ssm family; each
differentiates through the kernels' backward kernels on the card
(``flash_attention``'s and ``ssm_scan``'s) and through their plain
backwards on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer as tf
from repro_torch.models import xlstm_model as xm
from repro_torch.models import zamba as zb
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (abstract_params, count_params,
                                       init_params, logical_axes)

__all__ = ["Model", "build_model"]

@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    specs: Callable          # () -> ParamSpec tree
    loss: Callable           # (params, batch, flags) -> (loss, metrics)
    prefill: Callable        # (params, batch, flags, cache_len) -> (logits, caches)
    decode: Callable         # (params, caches, tokens, pos, flags) -> (logits, caches)
    cache_shapes: Callable   # (batch, cache_len) -> tree of shape tuples
    cache_axes: Callable     # () -> tree of logical-axis tuples (same tree)

    def init(self, generator: torch.Generator, dtype=torch.float32,
             device="cuda"):
        """Parameters drawn from ``generator`` on ``device`` (the card
        unless asked; see ``params.init_params``)."""
        return init_params(self.specs(), generator, dtype, device)

    def abstract(self, dtype=torch.bfloat16):
        """The parameters' shapes and dtype on the ``meta`` device."""
        return abstract_params(self.specs(), dtype)

    def axes(self):
        return logical_axes(self.specs())

    def n_params(self) -> int:
        return count_params(self.specs())


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family == "hybrid":
        return Model(
            cfg=cfg,
            specs=lambda: zb.zamba_specs(cfg),
            loss=lambda p, b, f: zb.zamba_loss(p, cfg, f, b),
            prefill=lambda p, b, f, cl: zb.zamba_prefill(p, cfg, f, b, cl),
            decode=lambda p, c, t, pos, f: zb.zamba_decode(p, cfg, f, c, t,
                                                           pos),
            cache_shapes=lambda b, cl: zb.zamba_cache_shapes(cfg, b, cl),
            cache_axes=lambda: zb.zamba_cache_axes(cfg),
        )
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        return Model(
            cfg=cfg,
            specs=lambda: tf.transformer_specs(cfg),
            loss=lambda p, b, f: tf.transformer_loss(p, cfg, f, b),
            prefill=lambda p, b, f, cl: tf.transformer_prefill(p, cfg, f, b,
                                                               cl),
            decode=lambda p, c, t, pos, f: tf.transformer_decode(p, cfg, f, c,
                                                                 t, pos),
            cache_shapes=lambda b, cl: tf.transformer_cache_shapes(cfg, b,
                                                                   cl),
            cache_axes=lambda: tf.transformer_cache_axes(cfg),
        )
    if cfg.family == "ssm":
        return Model(
            cfg=cfg,
            specs=lambda: xm.xlstm_specs(cfg),
            loss=lambda p, b, f: xm.xlstm_loss(p, cfg, f, b),
            prefill=lambda p, b, f, cl: xm.xlstm_prefill(p, cfg, f, b, cl),
            decode=lambda p, c, t, pos, f: xm.xlstm_decode_step(p, cfg, f, c,
                                                                t, pos),
            cache_shapes=lambda b, cl: xm.xlstm_cache_shapes(cfg, b, cl),
            cache_axes=lambda: xm.xlstm_cache_axes(cfg),
        )
    raise ValueError(f"unknown family {cfg.family!r}")
