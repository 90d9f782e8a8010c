"""Kernel dispatch for every op under ``repro_torch.kernels``.

The mode follows the tensor's device, never a guess about the machine:

* a CPU tensor gets the kernel's plain PyTorch version;
* a CUDA tensor gets the hand-written kernel, or the exception its build or
  launch raised.  Nothing falls back, and nothing is logged instead.

``force`` is ``"auto"`` (the rule above), ``"kernel"`` (the kernel; raises
for a CPU tensor) or ``"ref"`` (the plain version on either device — on the
card this is the yardstick the kernel is held against).
"""

from __future__ import annotations

import torch

__all__ = ["MODES", "resolve_mode"]

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
