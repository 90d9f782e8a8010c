"""Shared building blocks: norms, the gated MLP, rotary embeddings,
embeddings and the causal depthwise conv — ``repro.models.layers`` in
PyTorch.

Weights keep the reference's layouts (a projection is ``x @ w`` with
``w`` [in, out]), so parameters convert from the JAX package by a plain
copy.  Parameter specs are declared with ``repro_torch.models.params``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.params import spec
from repro_torch.shard.api import constrain_fused, pin_grad

__all__ = ["rmsnorm_spec", "rmsnorm", "layernorm_spec", "layernorm",
           "mlp_specs", "mlp", "rope", "mrope", "embed_specs", "embed",
           "unembed", "causal_conv1d", "wide", "project", "project_out"]


def wide(x):
    """``x`` in float32, or as it is where it is wider (float64: the
    float64 yardstick of a training step keeps every digit)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def project(x, w, first_axis):
    """x [B, S, D] by w [D, *rest] -> [B, S, *rest]: the einsum
    ``bsd,d...->bs...`` as a matmul over the fused [D, prod(rest)] weight
    (the same product on the same operands, an ``aten.mm``, which the
    "dots" rematerialisation saves: ``models.remat``), its fused output
    placed as ``rest``'s first dim would be (logical axis ``first_axis``;
    ``shard.constrain_fused``) before it is split, so that a count the
    mesh axis does not divide (8 KV heads, an sLSTM's 4 gates, on a
    16-way model axis) stays whole on every rank; the fused weight's
    gradient comes back on its placements (``shard.pin_grad``) for the
    same reason.  Off a mesh both are the identity."""
    d, rest = w.shape[0], tuple(w.shape[1:])
    y = x @ pin_grad(w.reshape(d, -1))
    y = constrain_fused(y, ("batch", "act_seq", first_axis), rest[0])
    return y.unflatten(-1, rest)


def project_out(o, w):
    """o [B, S, *rest] by w [*rest, D] -> [B, S, D]: the einsum
    ``bs...,...d->bsd`` as a matmul over the fused [prod(rest), D] weight
    (an ``aten.mm``, as in :func:`project`); both fused operands'
    gradients come back on their placements (``shard.pin_grad``), so that
    a head count the mesh axis does not divide is never split across
    ranks in the backward."""
    n = o.shape[2:].numel()
    return pin_grad(o.flatten(2)) @ pin_grad(w.reshape(n, -1))


def rmsnorm_spec(d: int, layers: int | None = None):
    shape, axes = (d,), ("embed",)
    if layers is not None:
        shape, axes = (layers, d), ("layers", "embed")
    return spec(shape, axes, init="zeros")          # Gemma-style (1 + w)


def rmsnorm(w, x, eps: float = 1e-6):
    """Gemma-style RMSNorm, ``(1 + w)`` scale, float32 (at least)
    inside."""
    dt = x.dtype
    x = wide(x)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return ((1.0 + wide(w)) * x).to(dt)


def layernorm_spec(d: int, layers: int | None = None):
    shape, axes = (d,), ("embed",)
    if layers is not None:
        shape, axes = (layers, d), ("layers", "embed")
    return {"w": spec(shape, axes, init="zeros"),
            "b": spec(shape, axes, init="zeros")}


def layernorm(p, x, eps: float = 1e-6):
    """LayerNorm with a ``(1 + w)`` scale and a bias, float32 inside."""
    dt = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return ((1.0 + p["w"]) * y + p["b"]).to(dt)


def mlp_specs(d: int, ff: int, act: str, layers: int | None = None,
              experts: int | None = None):
    """The (gated) MLP's weights; ``experts`` adds an experts axis after
    the layers axis (the MoE's expert stacks)."""
    lead_shape, lead_axes = (), ()
    if layers is not None:
        lead_shape, lead_axes = (layers,), ("layers",)
    if experts is not None:
        lead_shape, lead_axes = lead_shape + (experts,), lead_axes + (
            "experts",)
    p = {"up": spec(lead_shape + (d, ff), lead_axes + ("embed", "ffn")),
         "down": spec(lead_shape + (ff, d), lead_axes + ("ffn", "embed"))}
    if act in ("swiglu", "geglu"):
        p["gate"] = spec(lead_shape + (d, ff), lead_axes + ("embed", "ffn"))
    return p


def _act(x, act: str):
    if act == "swiglu":
        return F.silu(x)
    if act in ("geglu", "gelu"):
        return F.gelu(x, approximate="tanh")
    raise ValueError(act)


def mlp(p, x, act: str):
    h = x @ p["up"]
    if "gate" in p:
        h = h * _act(x @ p["gate"], act)
    else:
        h = _act(h, act)
    return h @ p["down"]


def _rope_angles(positions, dim: int, theta: float, device):
    """positions [...] -> angles [..., dim // 2] (float32)."""
    half = dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=device) / half)
    return positions.to(device=device, dtype=torch.float32)[..., None] * freq


def _apply_angles(x, ang):
    """x [..., S, H, D]; ang [..., S, D // 2], broadcast over the heads."""
    half = x.shape[-1] // 2
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rope(x, positions, theta: float = 10000.0):
    """Split-half RoPE.  x [B, S, H, D]; positions [B, S] (or [S])."""
    if positions.dim() == 1:
        positions = positions[None, :]
    return _apply_angles(x, _rope_angles(positions, x.shape[-1], theta,
                                         x.device))


def mrope(x, positions, sections, theta: float = 10000.0):
    """Qwen2-VL's multimodal RoPE.  x [B, S, H, D]; positions [3, B, S]
    (temporal, height, width ids); ``sections`` counts the rotary pairs
    of each id and sums to D/2: frequency band j takes its angle from the
    id of the section j falls in."""
    d = x.shape[-1]
    sec = np.cumsum((0,) + tuple(sections))
    if sec[-1] != d // 2:
        raise ValueError(f"mrope sections {sections} != head_dim/2 {d // 2}")
    ang_all = _rope_angles(positions, d, theta, x.device)   # [3, B, S, D/2]
    sel = np.zeros(d // 2, dtype=np.int64)
    for i in range(len(sections)):
        sel[sec[i]:sec[i + 1]] = i
    band = torch.arange(d // 2, device=x.device)
    ang = ang_all[torch.as_tensor(sel, device=x.device), ..., band]
    return _apply_angles(x, ang.movedim(0, -1))            # [B, S, D/2]


def embed_specs(vocab: int, d: int, tied: bool):
    p = {"tokens": spec((vocab, d), ("vocab", "embed"), std=1.0)}
    if not tied:
        p["unembed"] = spec((d, vocab), ("embed", "vocab"))
    return p


def embed(p, tokens, *, scale: bool, d: int):
    x = p["tokens"][tokens.to(torch.int64)]
    if scale:                                        # Gemma convention
        x = x * torch.tensor(math.sqrt(d), dtype=x.dtype)
    return x


def unembed(p, x, *, softcap: float | None = None):
    if "unembed" in p:
        logits = x @ p["unembed"]
    else:
        logits = x @ p["tokens"].T                   # tied
    logits = wide(logits)
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def causal_conv1d(w, x, state=None):
    """Depthwise causal conv.  w [C, K]; x [B, L, C]; state [B, K-1, C] or
    None (zeros).  Returns (y [B, L, C], new_state [B, K-1, C])."""
    k = w.shape[-1]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([state.to(x.dtype), x], dim=1)   # [B, L+K-1, C]
    # y[t] = sum_i w[:, i] * xp[t + i]  (w[:, K-1] multiplies the current
    # token), summed left to right as the reference does.
    length = x.shape[1]
    y = xp[:, 0:length, :] * w[:, 0]
    for i in range(1, k):
        y = y + xp[:, i:i + length, :] * w[:, i]
    # A copy, not a view: a view would keep the whole [B, L+K-1, C] input
    # alive in the prefill's stacked states.
    new_state = xp[:, -(k - 1):, :].clone() if k > 1 else state
    return y, new_state
