"""int8 error-feedback gradient compression — the single-device half of
``repro.distributed.compression``.

``quantize`` / ``dequantize`` are symmetric per-tensor int8 with the
reference's rounding (``torch.round``, half to even, as ``jnp.round``);
``compress_with_feedback`` carries each leaf's quantization error to the
next step.  The train step brackets the accumulated gradients with it, so
the update equals what the int8 wire format would deliver.  The
collective itself (``compressed_psum``: a shared scale, the int8 payload
summed in int32) needs a process group and waits for the mesh slice
(ROADMAP A12).
"""

from __future__ import annotations

import torch

from repro_torch.models.params import tree_leaves, tree_unflatten

__all__ = ["quantize", "dequantize", "compress_with_feedback"]


def quantize(x, *, bits: int = 8):
    """Symmetric per-tensor quantization.  Returns (q int8, scale f32)."""
    qmax = 2.0 ** (bits - 1) - 1
    x = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x)) / qmax, min=1e-12)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def dequantize(q, scale):
    return q.to(torch.float32) * scale


def compress_with_feedback(grads, residuals):
    """Quantize each leaf with error feedback: g_eff = Q(g + r),
    r' = (g + r) - g_eff.  Returns (dequantized grads, new residuals)."""
    def one(g, r):
        target = g.to(torch.float32) + r
        q, s = quantize(target)
        deq = dequantize(q, s)
        return deq, target - deq

    out = [one(g, r) for g, r in zip(tree_leaves(grads),
                                     tree_leaves(residuals))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
