"""Kernel dispatch for every op under ``repro_torch.kernels``.

The mode follows the tensor's device, never a guess about the machine:

* a CPU tensor gets the kernel's plain PyTorch version;
* a CUDA tensor gets the hand-written kernel, or the exception its build or
  launch raised.  Nothing falls back, and nothing is logged instead.

``force`` is ``"auto"`` (the rule above), ``"kernel"`` (the kernel; raises
for a CPU tensor) or ``"ref"`` (the plain version on either device — on the
card this is the yardstick the kernel is held against).

A kernel launch is opaque to a ``TorchDispatchMode``: the mode records the
wrapper's ``torch.empty`` and nothing of what the kernel computed.  After
each launch an op calls :func:`declare_kernel`, which hands an active trace
(``repro_torch.analysis.trace_audit``) the plain version that the kernel is
held equal to, so the trace can follow the values through it.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

__all__ = ["MODES", "declare_kernel", "resolve_mode"]

MODES = ("auto", "kernel", "ref")


def resolve_mode(force: str, device: torch.device, *, op: str = "") -> str:
    """Resolve ``force`` for a tensor on ``device`` to "kernel" | "ref"."""
    name = op or "<unnamed>"
    if force not in MODES:
        raise ValueError(f"force={force!r} for op {name!r}: expected one "
                         f"of {MODES}")
    device = torch.device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"op {name!r}: tensors on {device} are not "
                         "supported (cpu or cuda)")
    if force == "ref":
        return "ref"
    if device.type == "cuda":
        return "kernel"
    if force == "kernel":
        raise ValueError(f"op {name!r}: force='kernel' needs CUDA tensors; "
                         "this tensor lies on the CPU")
    return "ref"


def declare_kernel(op: str, outputs, plain) -> None:
    """Declare to the active dispatch mode, if it asks (a
    ``kernel_launched`` method), that a launch of ``op`` produced
    ``outputs``, which ``plain()`` recomputes with the plain version."""
    hook = getattr(_get_current_dispatch_mode(), "kernel_launched", None)
    if hook is not None:
        hook(op, outputs, plain)
