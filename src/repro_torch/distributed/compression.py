"""int8 error-feedback gradient compression for data-parallel reduction
— ``repro.distributed.compression``.

``quantize`` / ``dequantize`` are symmetric per-tensor int8 with the
reference's rounding (``torch.round``, half to even, as ``jnp.round``);
``compress_with_feedback`` carries each leaf's quantization error to the
next step.  The train step brackets the accumulated gradients with it, so
the update equals what the int8 wire format would deliver (on a sharded
state the per-tensor scale is the largest magnitude over every shard).
``compressed_psum`` is the explicit collective over one mesh axis's
process group: a shared scale (one float32 ``all_reduce(MAX)``), the int8
codes summed in int32 (``all_reduce(SUM)``), dequantized once.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_unflatten

__all__ = ["quantize", "dequantize", "compress_with_feedback",
           "compressed_psum"]


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


def compressed_psum(x, mesh, axis_name: str):
    """int8 all-reduce of this rank's ``x`` over the mesh axis
    ``axis_name`` (the reference's ``compressed_psum`` inside
    ``shard_map``).

    Protocol: agree on a shared scale (the largest ``max|x| / 127`` over
    the axis, floored at 1e-12), quantize locally (half to even, clamped
    to +-127), sum the codes in int32, dequantize once.  Wire bytes: a
    quarter of float32's as codes (sent here as int32, gloo and NCCL
    having no int8 sum that cannot overflow), plus one scalar.
    """
    qmax = 127.0
    group = mesh.get_group(axis_name)
    x = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(x)) / qmax, min=1e-12)
    dist.all_reduce(scale, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    dist.all_reduce(q, op=dist.ReduceOp.SUM, group=group)
    return q.to(torch.float32) * scale
