"""Plain PyTorch version of flash attention — same contract as the CUDA
kernel in ``csrc/flash_attention.cu``.

The PyTorch form of ``repro.kernels.flash_attention.ref.attention_ref``:
the KV heads repeated to the query heads, float32 scores, the softcap,
the causal / window mask at -0.7·f32max, a softmax and the float32 value
product, rounded to q's dtype.  It serves the CPU path and the tests; on
the card it is the kernel's yardstick (``chip_smoke.py``).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["attention_ref", "NEG"]

NEG = -0.7 * float(np.finfo(np.float32).max)


def attention_ref(q, k, v, *, scale=None, causal=True, window=None,
                  softcap=None):
    """q [B, H, S, D]; k, v [B, KH, T, D] -> [B, H, S, D] (f32 math)."""
    h, s, d = q.shape[1:]
    kh, t = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    rep = h // kh
    k = torch.repeat_interleave(k, rep, dim=1).to(torch.float32)
    v = torch.repeat_interleave(v, rep, dim=1).to(torch.float32)
    sc = torch.einsum("bhsd,bhtd->bhst", q.to(torch.float32), k) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    qp = torch.arange(s, device=q.device)[:, None]
    kp = torch.arange(t, device=q.device)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool, device=q.device)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    sc = torch.where(ok, sc, NEG)
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v).to(q.dtype)
