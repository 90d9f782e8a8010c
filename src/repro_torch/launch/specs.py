"""Assigned input-shape cells and their meta-tensor stand-ins —
``repro.launch.specs``.

Each (arch x shape) cell defines what the dry run executes:

  train_4k      seq 4,096  gb 256  -> train_step
  prefill_32k   seq 32,768 gb 32   -> prefill_step (forward + cache build;
                                      plain encode for encoder-only archs)
  decode_32k    1 token, KV cache 32,768, gb 128 -> serve_step (decode)
  long_500k     1 token, state/cache @ 524,288, gb 1 -> serve_step

Skips: decode/long for hubert (encoder-only); long_500k only for
bounded-state archs (xlstm, zamba2, mixtral-SWA).

The reference's ``jax.ShapeDtypeStruct``s are tensors on the ``meta``
device here (shapes and dtypes, no storage): ``jnp.int32`` is
``torch.int32``, ``bool_`` is ``torch.bool``, and the float dtype argument
maps over.  ``decode_input_specs``' position is a Python int, the last
slot of the cache (``seq - 1``): the port's decode step takes its
position as a host value (the reference traces an int32 scalar).
"""

from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["SHAPES", "cell_is_runnable", "skip_reason", "batch_struct",
           "prefill_struct", "decode_struct", "train_input_specs",
           "prefill_input_specs", "decode_input_specs", "runnable_cells"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}

# Archs with bounded decode state (sub-quadratic long-context) — long_500k
# runs only for these.
_LONG_OK = {"xlstm-125m", "zamba2-7b", "mixtral-8x22b"}


def skip_reason(arch: str, shape: str) -> str | None:
    if arch == "hubert-xlarge" and shape in ("decode_32k", "long_500k"):
        return "encoder-only: no decode step"
    if shape == "long_500k" and arch not in _LONG_OK:
        return ("unbounded full-attention state at 500k (O(L*seq) cache); "
                "run only for bounded-state archs")
    return None


def cell_is_runnable(arch: str, shape: str) -> bool:
    return skip_reason(arch, shape) is None


def runnable_cells(archs) -> list[tuple[str, str]]:
    return [(a, s) for a in archs for s in SHAPES if cell_is_runnable(a, s)]


# --------------------------------------------------------------------------- #
# Meta-tensor stand-ins (no storage)
# --------------------------------------------------------------------------- #
def _i32(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def _f(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(cfg: ModelConfig, batch: int, seq: int,
                 dtype=torch.bfloat16):
    """Model-input tree (tokens/features + targets) as meta tensors."""
    if cfg.family == "audio":
        return {"features": _f((batch, seq, cfg.frontend_dim), dtype),
                "mask": torch.empty((batch, seq), dtype=torch.bool,
                                    device="meta"),
                "targets": _i32((batch, seq))}
    out = {"tokens": _i32((batch, seq)), "targets": _i32((batch, seq))}
    if cfg.family == "vlm":
        out["vision_embeds"] = _f((batch, cfg.n_vision_tokens, cfg.d_model),
                                  dtype)
        out["positions"] = _i32((3, batch, seq))
    return out


def train_input_specs(cfg: ModelConfig, shape: str, dtype=torch.bfloat16):
    s = SHAPES[shape]
    return batch_struct(cfg, s["batch"], s["seq"], dtype)


def prefill_struct(cfg: ModelConfig, batch: int, seq: int,
                   dtype=torch.bfloat16):
    """The prefill's inputs: ``batch_struct`` without targets."""
    b = batch_struct(cfg, batch, seq, dtype)
    b.pop("targets", None)
    return b


def prefill_input_specs(cfg: ModelConfig, shape: str, dtype=torch.bfloat16):
    s = SHAPES[shape]
    return prefill_struct(cfg, s["batch"], s["seq"], dtype)


def _is_shape(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(i, int) for i in x)


def _to_meta(tree, dtype):
    if _is_shape(tree):
        return _f(tree, dtype)
    if isinstance(tree, dict):
        return {k: _to_meta(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_meta(v, dtype) for v in tree)
    return tree


def decode_struct(model, batch: int, seq: int, dtype=torch.bfloat16):
    """(caches, tokens, pos): the caches of ``seq`` slots and the tokens
    as meta tensors, ``pos`` the cache's last slot (a Python int)."""
    caches = _to_meta(model.cache_shapes(batch, seq), dtype)
    return caches, _i32((batch, 1)), seq - 1


def decode_input_specs(model, shape: str, dtype=torch.bfloat16):
    """(caches, tokens, pos) for serve_step (:func:`decode_struct`)."""
    s = SHAPES[shape]
    return decode_struct(model, s["batch"], s["seq"], dtype)
