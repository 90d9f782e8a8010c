"""Dispatching entries of the chunked SSD scan."""

from __future__ import annotations

from repro_torch.kernels.dispatch import (declare_kernel, require_no_grad,
                                         resolve_mode)
from repro_torch.kernels.ssm_scan import kernel as _kernel
from repro_torch.kernels.ssm_scan import ref as _ref

__all__ = ["linear_scan", "ssm_scan"]


def linear_scan(k, v, q, log_decay, gate, *, chunk: int,
                initial_state=None, force: str = "auto"):
    """k, q [B, L, H, N]; v [B, L, H, P]; log_decay, gate [B, L, H]
    -> (y [B, L, H, P], final_state [B, H, N, P]), both float32.

    Any L: the tail is padded to a whole chunk with gate 0 and log-decay 0,
    which leaves the state as it is.  The kernel for CUDA tensors, the
    plain version for CPU tensors (see ``kernels.dispatch``).
    """
    kw = dict(chunk=chunk, initial_state=initial_state)
    plain = lambda: _ref.linear_scan_ref(k, v, q, log_decay, gate, **kw)
    if resolve_mode(force, k.device, op="ssm_scan") == "ref":
        return plain()
    require_no_grad("ssm_scan", k, v, q, log_decay, gate, initial_state)
    out = _kernel.ssm_scan_cuda(k, v, q, log_decay, gate, **kw)
    declare_kernel("ssm_scan", out, plain)
    return out


def ssm_scan(k, v, q, log_decay, gate, *, chunk: int = 256,
             force: str = "auto"):
    """y [B, L, H, P] only: the signature of ``repro.kernels.ssm_scan``."""
    return linear_scan(k, v, q, log_decay, gate, chunk=chunk,
                       force=force)[0]
