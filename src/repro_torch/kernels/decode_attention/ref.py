"""Plain PyTorch version of decode attention over a ring KV cache — same
contract as the CUDA kernel in ``csrc/decode_attention.cu``.

The PyTorch form of ``repro.kernels.decode_attention.ref.
decode_attention_ref``: the KV heads repeated to the query heads, float32
scores (softcapped, ``softcap·tanh(s / softcap)`` after the scale, where
one is given, as the JAX model's ``attention._scores``), the ring
positions ``pos - ((pos - slot) mod T)`` with floor
modulo (``torch.remainder``), dead and out-of-window slots at -0.7·f32max,
a softmax and the float32 value product, rounded to q's dtype.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.ref import NEG

__all__ = ["decode_attention_ref"]


def decode_attention_ref(q, k, v, pos, *, scale=None, window=None,
                         softcap=None):
    """q [B, H, D]; k, v [B, KH, T, D]; pos a scalar -> [B, H, D]."""
    h, d = q.shape[1:]
    kh, t = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    rep = h // kh
    k = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    v = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    s = torch.einsum("bhd,bhtd->bht", q.to(torch.float32), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.as_tensor(pos, dtype=torch.int64, device=q.device)
    slot = torch.arange(t, device=q.device)
    k_pos = pos - torch.remainder(pos - slot, t)
    ok = (k_pos >= 0) & (k_pos <= pos)
    if window is not None:
        ok &= k_pos > pos - window
    s = torch.where(ok, s, NEG)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bht,bhtd->bhd", p, v).to(q.dtype)
