"""Kernel dispatch for every op under ``repro_torch.kernels``.

The mode follows the tensor's device, never a guess about the machine:

* a CPU tensor gets the kernel's plain PyTorch version;
* a CUDA tensor gets the hand-written kernel, or the exception its build or
  launch raised.  Nothing falls back, and nothing is logged instead;
* a meta tensor (the dry run, ``launch.dryrun``) gets the kernel's meta
  branch, in the ops that have one (:data:`META_OPS`): the kernel's
  checks, empty outputs of the kernel's shapes, and the kernel's
  (operations, bytes) handed to the counting modes by :func:`report_cost`.
  A meta tensor computes nothing, so this is no fallback: no value comes
  out of it.  Any other op raises on a meta tensor.

``force`` is ``"auto"`` (the rule above), ``"kernel"`` (the kernel; raises
for a CPU tensor) or ``"ref"`` (the plain version on either device — on the
card this is the yardstick the kernel is held against).

A kernel launch is opaque to a ``TorchDispatchMode``: the mode records the
wrapper's ``torch.empty`` and nothing of what the kernel computed.  After
each launch an op calls :func:`declare_kernel`, which hands an active trace
(``repro_torch.analysis.trace_audit``) the plain version that the kernel is
held equal to, so the trace can follow the values through it.

A kernel without a backward kernel returns a tensor with no ``grad_fn``:
autograd would drop that branch of a loss without a word.  Such an op
calls :func:`require_no_grad` before it launches, which raises when
gradients are on and an input asks for one.  ``flash_attention`` and
``ssm_scan`` have backward kernels (``csrc/flash_attention_bwd.cu``,
``csrc/ssm_scan_bwd.cu``) and differentiate through them instead.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import (_get_current_dispatch_mode,
                                         _get_current_dispatch_mode_stack)

__all__ = ["MODES", "META_OPS", "declare_kernel", "report_cost",
           "require_no_grad", "resolve_mode"]

MODES = ("auto", "kernel", "ref")
# The ops with a meta branch: those on the models' training, prefill and
# decode paths.
META_OPS = ("flash_attention", "decode_attention", "ssm_scan")


def resolve_mode(force: str, device: torch.device, *, op: str = "") -> str:
    """Resolve ``force`` for a tensor on ``device`` to "kernel" | "ref" |
    "meta" (a meta tensor, unless ``force="ref"``)."""
    name = op or "<unnamed>"
    if force not in MODES:
        raise ValueError(f"force={force!r} for op {name!r}: expected one "
                         f"of {MODES}")
    device = torch.device(device)
    if device.type == "meta" and op in META_OPS:
        return "ref" if force == "ref" else "meta"
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"op {name!r}: tensors on {device} are not "
                         "supported (cpu or cuda; meta for the ops "
                         f"{', '.join(META_OPS)})")
    if force == "ref":
        return "ref"
    if device.type == "cuda":
        return "kernel"
    if force == "kernel":
        raise ValueError(f"op {name!r}: force='kernel' needs CUDA tensors; "
                         "this tensor lies on the CPU")
    return "ref"


def require_no_grad(op: str, *tensors) -> None:
    """Raise before ``op``'s CUDA kernel launches if grad mode is on and any
    of ``tensors`` (None allowed) requires grad: the kernel has no backward
    kernel, and its output would carry no gradient.  The plain version on
    the CPU keeps autograd; this guard is for the card's path."""
    if not torch.is_grad_enabled():
        return
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{op}: its CUDA kernel has no backward kernel, so a gradient "
            "through it would be dropped; run it under torch.no_grad() or "
            "on CPU tensors (no model's loss differentiates through it)")


def declare_kernel(op: str, outputs, plain) -> None:
    """Declare to the active dispatch mode, if it asks (a
    ``kernel_launched`` method), that a launch of ``op`` produced
    ``outputs``, which ``plain()`` recomputes with the plain version."""
    hook = getattr(_get_current_dispatch_mode(), "kernel_launched", None)
    if hook is not None:
        hook(op, outputs, plain)


def report_cost(op: str, ops: int, nbytes: int) -> None:
    """Hand a meta-branch call of ``op`` (the work its kernel would do:
    ``ops`` operations, ``nbytes`` bytes moved) to every active dispatch
    mode that asks (a ``kernel_cost`` method): the dry run's counters."""
    for mode in _get_current_dispatch_mode_stack():
        hook = getattr(mode, "kernel_cost", None)
        if hook is not None:
            hook(op, ops, nbytes)
