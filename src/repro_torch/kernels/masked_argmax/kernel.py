"""Wrapper of the CUDA masked-argmax kernel (``csrc/masked_argmax.cu``).

:func:`prepare` checks the inputs and allocates the output, :func:`launch`
launches once on prepared arguments, and :func:`masked_argmax_cuda` does
both and counts the launch in ``masked_argmax_cuda.launches`` (and nowhere
else).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import capi

__all__ = ["launch", "masked_argmax_cuda", "prepare"]

_OP = "masked_argmax"


def _fn():
    return capi.entry(_OP, "masked_argmax_launch",
                      [capi.P, capi.P, capi.I, capi.I, capi.P, capi.P])


def prepare(score, valid, *, quantize: bool = True):
    """Returns ``(args, out, keep)``: the C entry's arguments, the output
    index [1] and the tensors ``args`` points into."""
    dev = capi.require_cuda(_OP, score)
    m_dim = score.shape[0]
    capi.check(_OP, "score", score, torch.float32, (m_dim,), dev)
    capi.check(_OP, "valid", valid, torch.bool, (m_dim,), dev)
    out = torch.empty((1,), dtype=torch.int32, device=dev)
    args = (score.data_ptr(), valid.data_ptr(), m_dim, int(bool(quantize)),
            out.data_ptr(), capi.stream(dev))
    return args, out, (score, valid)


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def masked_argmax_cuda(score, valid, *, quantize: bool = True):
    """The selected index [1] int32 on the card; the contract of
    :func:`repro_torch.kernels.masked_argmax.ref.masked_argmax_ref`."""
    args, out, _keep = prepare(score, valid, quantize=quantize)
    launch(args)
    masked_argmax_cuda.launches += 1
    return out


masked_argmax_cuda.launches = 0
