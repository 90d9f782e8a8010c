"""Dispatching entry of train/prefill attention, and its gradient.

Without gradients the op is the forward alone: the kernel for CUDA
tensors, the plain version for CPU tensors (``kernels.dispatch``).  When
grad mode is on and q, k or v requires grad, the call goes through
:class:`FlashAttention`, a ``torch.autograd.Function`` that keeps q, k, v,
o and the rows' log-sum-exp: on the card its forward is the kernel with
the ``lse`` output and its backward the backward kernel
(``csrc/flash_attention_bwd.cu``); on the CPU, or with ``force="ref"``,
both are the plain versions (``ref.attention_fwd_ref``,
``ref.attention_bwd_ref``); on meta tensors (the dry run) both are the
kernels' meta branches, which check, allocate nothing real and report the
kernels' work (``kernel.cost``, ``kernel.cost_bwd``).  Training runs
float32: a bfloat16 input that requires grad raises.  DTensor operands (a sharded step) run the op on
each rank's shard of batch and heads (``shard.local.run_local``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import (declare_kernel, report_cost,
                                         resolve_mode)
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref
from repro_torch.shard.local import any_dtensor, reject, run_local

__all__ = ["FlashAttention", "flash_attention"]

# The operands' logical axes in this op's layout (q [B, H, S, D], k and v
# [B, KH, T, D]): the reference constrains the same tensors in [B, S, H, D].
_Q_AXES = ("batch", "act_heads", "act_seq", None)
_KV_AXES = ("batch", "act_kv_heads", "act_seq", None)


class FlashAttention(torch.autograd.Function):
    """Attention whose backward is the backward kernel on the card (mode
    "kernel"), the plain backward (mode "ref") or the backward's meta
    branch (mode "meta")."""

    @staticmethod
    def forward(ctx, q, k, v, mode, kw):
        reject("flash_attention", q, k, v)
        if mode == "kernel":
            o, lse = _kernel.flash_attention_cuda(q, k, v, want_lse=True,
                                                  **kw)
            declare_kernel("flash_attention", o,
                           lambda: _ref.attention_ref(q, k, v, **kw))
        elif mode == "meta":
            o, lse = _meta(q, k, v, kw, want_lse=True)
        else:
            o, lse = _ref.attention_fwd_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode, ctx.kw = mode, kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        if do.data_ptr() % 16:           # a view that the kernel cannot read
            do = do.clone()
        args = (q, k, v, o, lse, do)
        if ctx.mode == "kernel":
            grads = _kernel.flash_attention_bwd_cuda(*args, **ctx.kw)
            declare_kernel("flash_attention_bwd", grads,
                           lambda: _ref.attention_bwd_ref(*args, **ctx.kw))
        elif ctx.mode == "meta":
            grads = _kernel.flash_attention_bwd_meta(*args, **ctx.kw)
            report_cost("flash_attention_bwd", *_kernel.cost_bwd(
                q, k, v, causal=ctx.kw["causal"], window=ctx.kw["window"]))
        else:
            grads = _ref.attention_bwd_ref(*args, **ctx.kw)
        return (*grads, None, None)


def _meta(q, k, v, kw, want_lse=False):
    """The forward's meta branch: its outputs, its work reported."""
    out = _kernel.flash_attention_meta(q, k, v, want_lse=want_lse, **kw)
    report_cost("flash_attention", *_kernel.cost(
        q, k, v, causal=kw["causal"], window=kw["window"],
        want_lse=want_lse))
    return out


def flash_attention(q, k, v, *, scale=None, causal=True, window=None,
                    softcap=None, bq=128, bk=512, force: str = "auto"):
    """q [B, H, S, D]; k, v [B, KH, T, D] -> [B, H, S, D] in q's dtype.

    The kernel for CUDA tensors, the plain version for CPU tensors, the
    meta branch for meta tensors (see ``kernels.dispatch``); differentiable
    through :class:`FlashAttention` (float32 only).  ``bq``/``bk`` are the TPU kernel's tiles, kept for
    its signature; the CUDA kernel picks its own.
    """
    del bq, bk
    kw = dict(scale=scale, causal=causal, window=window, softcap=softcap)
    if any_dtensor(q, k, v):
        return run_local(
            "flash_attention",
            lambda q, k, v: flash_attention(q, k, v, force=force, **kw),
            [(q, _Q_AXES), (k, _KV_AXES), (v, _KV_AXES)], heads=(1, 1, 1),
            groups=((0, 1), (0, 2)), outputs=((0, 1),))
    mode = resolve_mode(force, q.device, op="flash_attention")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if q.dtype != torch.float32:
            raise TypeError(f"flash_attention: a gradient needs float32 "
                            f"inputs (training runs float32), got {q.dtype}")
        return FlashAttention.apply(q, k, v, mode, kw)
    plain = lambda: _ref.attention_ref(q, k, v, **kw)
    if mode == "ref":
        return plain()
    if mode == "meta":
        return _meta(q, k, v, kw)
    out = _kernel.flash_attention_cuda(q, k, v, **kw)
    declare_kernel("flash_attention", out, plain)
    return out
