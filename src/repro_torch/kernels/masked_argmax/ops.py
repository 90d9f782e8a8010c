"""Dispatching entry of the masked, quantized argmax."""

from __future__ import annotations

from repro_torch.kernels.dispatch import (declare_kernel, require_no_grad,
                                         resolve_mode)
from repro_torch.kernels.masked_argmax import kernel as _kernel
from repro_torch.kernels.masked_argmax import ref as _ref

__all__ = ["masked_argmax"]


def masked_argmax(score, valid, *, quantize: bool = True,
                  force: str = "auto"):
    """score f32 [M], valid bool [M] -> int32 [1]: the argmax of
    ``quantize_scores(where(valid, score, -inf))`` (raw masked scores with
    ``quantize=False``).  The kernel for CUDA tensors, the plain version
    for CPU tensors (``kernels.dispatch``)."""
    plain = lambda: _ref.masked_argmax_ref(score, valid, quantize=quantize)
    if resolve_mode(force, score.device, op="masked_argmax") == "ref":
        return plain()
    require_no_grad("masked_argmax", score, valid)
    out = _kernel.masked_argmax_cuda(score, valid, quantize=quantize)
    declare_kernel("masked_argmax", out, plain)
    return out
