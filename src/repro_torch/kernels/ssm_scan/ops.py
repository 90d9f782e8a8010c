"""Dispatching entries of the chunked SSD scan, and its gradient.

Without gradients the op is the forward alone: the kernel for CUDA
tensors, the plain version for CPU tensors (``kernels.dispatch``).  When
grad mode is on and an input requires grad, the call goes through
:class:`LinearScan`, a ``torch.autograd.Function`` that keeps k, v, q,
log_decay, gate, the final state and the states entering each chunk: on
the card its forward is the kernel (whose scratch holds those states)
and its backward the backward kernel (``csrc/ssm_scan_bwd.cu``); on the
CPU, or with ``force="ref"``, both are the plain versions
(``ref.linear_scan_fwd_ref``, ``ref.linear_scan_bwd_ref``); on meta
tensors (the dry run) both are the kernels' meta branches, which check,
allocate nothing real and report the kernels' work in their chunked form
(``kernel.cost``, ``kernel.cost_bwd``).  Training runs float32: a bfloat16 input that requires grad raises.  DTensor
operands (a sharded step) run the scan on each rank's shard of batch and
heads (``shard.local.run_local``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import (declare_kernel, report_cost,
                                         resolve_mode)
from repro_torch.kernels.ssm_scan import kernel as _kernel
from repro_torch.kernels.ssm_scan import ref as _ref
from repro_torch.shard.local import any_dtensor, reject, run_local

__all__ = ["LinearScan", "linear_scan", "ssm_scan"]

# The operands' logical axes: k, q [B, L, H, N], v [B, L, H, P], log_decay
# and gate [B, L, H], the state [B, H, N, P].
_SEQ_AXES = ("batch", "act_seq", "act_heads", None)
_GATE_AXES = ("batch", "act_seq", "act_heads")
_STATE_AXES = ("batch", "act_heads", None, None)


class LinearScan(torch.autograd.Function):
    """The scan whose backward is the backward kernel on the card (mode
    "kernel") or the plain backward (mode "ref").  An unused output's
    gradient comes as None: a final state that no loss reads gives the
    backward no dS_final."""

    @staticmethod
    def forward(ctx, k, v, q, log_decay, gate, initial_state, mode, chunk):
        args = (k, v, q, log_decay, gate)
        reject("ssm_scan", *args, initial_state)
        kw = dict(chunk=chunk, initial_state=initial_state)
        if mode == "kernel":
            y, s, states = _kernel.ssm_scan_cuda(*args, want_states=True,
                                                 **kw)
            declare_kernel("ssm_scan", (y, s),
                           lambda: _ref.linear_scan_ref(*args, **kw))
        elif mode == "meta":
            y, s, states = _meta(args, kw, want_states=True)
        else:
            y, s, states = _ref.linear_scan_fwd_ref(*args, **kw)
        ctx.save_for_backward(*args, initial_state, states, s)
        ctx.mode, ctx.chunk = mode, chunk
        ctx.set_materialize_grads(False)
        return y, s

    @staticmethod
    def backward(ctx, dy, d_final):
        k, v, q, log_decay, gate, s0, states, s = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        args = (k, v, q, log_decay, gate, dy.contiguous(), d_final)
        kw = dict(chunk=ctx.chunk, initial_state=s0, states=states,
                  final_state=s)
        if ctx.mode == "kernel":
            grads = _kernel.ssm_scan_bwd_cuda(*args, **kw)
            declare_kernel("ssm_scan_bwd", grads,
                           lambda: _ref.linear_scan_bwd_ref(*args, **kw))
        elif ctx.mode == "meta":
            grads = _kernel.ssm_scan_bwd_meta(*args, **kw)
            report_cost("ssm_scan_bwd", *_kernel.cost_bwd(
                *args, chunk=ctx.chunk, initial_state=s0, states=states))
        else:
            grads = _ref.linear_scan_bwd_ref(*args, **kw)
        *grads, d_init = grads
        return (*grads, d_init if s0 is not None else None, None, None)


def _meta(args, kw, want_states=False):
    """The forward's meta branch: its outputs, its work reported."""
    out = _kernel.ssm_scan_meta(*args, want_states=want_states, **kw)
    report_cost("ssm_scan", *_kernel.cost(*args, **kw))
    return out


def linear_scan(k, v, q, log_decay, gate, *, chunk: int,
                initial_state=None, force: str = "auto"):
    """k, q [B, L, H, N]; v [B, L, H, P]; log_decay, gate [B, L, H]
    -> (y [B, L, H, P], final_state [B, H, N, P]), both float32.

    Any L: the tail is padded to a whole chunk with gate 0 and log-decay 0,
    which leaves the state as it is.  The kernel for CUDA tensors, the
    plain version for CPU tensors, the meta branch for meta tensors (see
    ``kernels.dispatch``); differentiable through :class:`LinearScan`
    (float32 only).
    """
    ins = (k, v, q, log_decay, gate, initial_state)
    if any_dtensor(*ins):
        return run_local(
            "ssm_scan",
            lambda *a: linear_scan(*a[:5], chunk=chunk, initial_state=a[5],
                                   force=force),
            [(k, _SEQ_AXES), (v, _SEQ_AXES), (q, _SEQ_AXES),
             (log_decay, _GATE_AXES), (gate, _GATE_AXES),
             (initial_state, _STATE_AXES)], heads=(2, 2, 2, 2, 2, 1),
            outputs=((1, 2), (1, 1)))
    kw = dict(chunk=chunk, initial_state=initial_state)
    mode = resolve_mode(force, k.device, op="ssm_scan")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in ins):
        if any(t is not None and t.dtype != torch.float32
               for t in (k, v, q)):
            raise TypeError(f"ssm_scan: a gradient needs float32 inputs "
                            f"(training runs float32), got {k.dtype}")
        return LinearScan.apply(*ins, mode, chunk)
    plain = lambda: _ref.linear_scan_ref(k, v, q, log_decay, gate, **kw)
    if mode == "ref":
        return plain()
    if mode == "meta":
        return _meta((k, v, q, log_decay, gate), kw)
    out = _kernel.ssm_scan_cuda(k, v, q, log_decay, gate, **kw)
    declare_kernel("ssm_scan", out, plain)
    return out


def ssm_scan(k, v, q, log_decay, gate, *, chunk: int = 256,
             force: str = "auto"):
    """y [B, L, H, P] only: the signature of ``repro.kernels.ssm_scan``."""
    return linear_scan(k, v, q, log_decay, gate, chunk=chunk,
                       force=force)[0]
