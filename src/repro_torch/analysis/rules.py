"""Auditor rules R1-R4: sink checks over the trace's labels.

The torch counterpart of ``repro.analysis.rules``.  Each rule inspects one
recorded operation (``trace_audit.Op``) at a time, with ``get(tensor) ->
Labels`` exposing the abstract values the walker computed for its inputs:

* **R1** ``QuantizedArgmaxRule``   — a float argmax/argmin (and torch's
  ``max``/``min`` over a dimension, which return the argmax too) must
  consume ``quantize_scores``-dominated values;
* **R2** ``SizeInvariantPRNGRule`` — ``prng.split`` may only make the
  key-chaining pair; per-index keys come from ``prng.fold_in``.  The
  port's PRNG is int64 tensor arithmetic, so the walker reports each
  ``prng.split`` call as one operation carrying its count;
* **R3** ``MaskedReduceRule``      — in padded programs every reduction
  over the candidate (M) axis, and every product contracting it, must
  consume mask-dominated values;
* **R4** ``NoF64NoCallbackRule``   — no float64 value and no host round
  trip.  The port rounds in float64 on purpose inside two helpers,
  ``acquisition.sqrt_rn`` (the correctly rounded float32 square root) and
  ``acquisition.fma`` (a float32 multiply-add with one rounding): both take
  float32 operands, compute exactly in float64 (the product of two float32
  values is exact there; the sum is corrected at ties) and round once to
  float32, so their float64 never reaches a decision unrounded.  R4 tells
  them apart by where the operation ran: a float64 output inside one of
  them (``Op.rounding_helper``) is allowed, any other float64 output is a
  leak.  So ``beta.double().float()`` outside them is flagged, though it
  rounds back at once: it is the reference's fixture.  The host half is
  ``aten._local_scalar_dense`` (``.item()``, ``float(t)``, indexing with a
  0-d tensor) and device-to-host copies.

``ForbiddenPrimitivesRule`` pins that the listed aten operations never run.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.trace_audit import (REDUCTIONS, Finding, Op, Rule,
                                              is_binary_max)

__all__ = ["QuantizedArgmaxRule", "SizeInvariantPRNGRule", "MaskedReduceRule",
           "NoF64NoCallbackRule", "ForbiddenPrimitivesRule", "default_rules"]

# Contracted operand axes of the matrix products: (lhs, rhs) positions in
# the arguments and the axis each contracts.
_DOT_AXES = {"mm": ((0, 1), (1, 0)), "mv": ((0, 1), (1, 0)),
             "bmm": ((0, 2), (1, 1)), "dot": ((0, 0), (1, 0)),
             "vdot": ((0, 0), (1, 0)), "addmm": ((1, 1), (2, 0)),
             "addmv": ((1, 1), (2, 0)), "baddbmm": ((1, 2), (2, 1)),
             "addbmm": ((1, 2), (2, 1))}
_F64 = (torch.float64, torch.complex128)


def _is_argmax(op: Op) -> bool:
    return op.name in ("argmax", "argmin") or (
        op.name in ("max", "min") and op.overload.startswith("dim"))


def _reduced_axes(op: Op) -> list[int]:
    """The axes of ``op.args[0]`` that a reduction folds."""
    x = op.args[0]
    nd = x.dim()
    if nd == 0:
        return []
    dim = op.kwargs.get("dim")
    if dim is None and len(op.args) > 1 and isinstance(op.args[1],
                                                       (int, list, tuple)):
        if not isinstance(op.args[1], bool):
            dim = op.args[1]
    if dim is None or (isinstance(dim, (list, tuple)) and not dim):
        return list(range(nd))
    dims = [dim] if isinstance(dim, int) else list(dim)
    return [d % nd for d in dims]


class QuantizedArgmaxRule(Rule):
    """R1: every argmax/argmin over floating scores must be dominated by the
    quantize_scores bit pattern."""

    id = "R1"

    def check(self, op, get):
        if not _is_argmax(op):
            return ()
        operand = op.args[0]
        if not operand.is_floating_point() or get(operand).quant:
            return ()
        return (Finding(
            rule=self.id, op=op.name,
            message="float argmax on scores not dominated by quantize_scores "
                    "- a last-ulp difference can flip this selection"),)


class SizeInvariantPRNGRule(Rule):
    """R2: ``prng.split`` may only produce the key-chaining pair.  A wider
    split makes the key tree depend on a geometry-derived count; per-index
    keys must come from ``prng.fold_in``."""

    id = "R2"

    def check(self, op, get):
        if op.name != "prng.split" or op.args[1] == 2:
            return ()
        return (Finding(
            rule=self.id, op=op.name,
            message=f"prng.split into {op.args[1]} keys: the split count "
                    "derives from a geometry-dependent size - use fold_in "
                    "per index (size-invariant PRNG contract)"),)


class MaskedReduceRule(Rule):
    """R3: in a padded program, no reduction over the M axis may consume
    values whose padding lanes are live.

    ``m`` is the padded candidate-axis width; an axis "is the M axis" iff
    its size equals ``m`` (the registry keeps ``m`` unique among the traced
    dimension sizes).  ``mask_argnums``/``clean_argnums`` seed the labels
    of the validity/observation masks and of state whose padding is zero."""

    id = "R3"

    def __init__(self, m: int, mask_argnums=(), clean_argnums=()):
        self.m = int(m)
        self.mask_argnums = tuple(mask_argnums)
        self.clean_argnums = tuple(clean_argnums)

    def check(self, op, get):
        if op.name in REDUCTIONS and not is_binary_max(op):
            x = op.args[0]
            if not isinstance(x, torch.Tensor):
                return ()
            if not any(x.shape[a] == self.m for a in _reduced_axes(op)):
                return ()
            if get(x).cleanish:
                return ()
            return (Finding(
                rule=self.id, op=op.name,
                message=f"reduction over the padded M axis (size {self.m}) "
                        "on values not dominated by the valid/obs masks - "
                        "padding lanes are live in this decision"),)
        axes = _DOT_AXES.get(op.name)
        if axes is None:
            return ()
        (li, la), (ri, ra) = axes
        lhs, rhs = op.args[li], op.args[ri]
        if not (lhs.shape[la] == self.m or rhs.shape[ra] == self.m):
            return ()
        if get(lhs).cleanish or get(rhs).cleanish:
            return ()
        return (Finding(
            rule=self.id, op=op.name,
            message=f"matrix product contracting the padded M axis (size "
                    f"{self.m}) with neither operand mask-dominated"),)


class NoF64NoCallbackRule(Rule):
    """R4: no float64 value outside the single-rounding helpers, and no
    host round trip (see the module docstring)."""

    id = "R4"

    def check(self, op, get):
        if op.name == "_local_scalar_dense":
            return (Finding(
                rule=self.id, op=op.name,
                message="host round trip (a tensor read as a Python "
                        "number): breaks replay and forces a device-host "
                        "sync"),)
        ins = op.tensor_args()
        if any(o.device.type == "cpu" for o in op.outputs) and any(
                t.device.type == "cuda" for t in ins):
            return (Finding(
                rule=self.id, op=op.name,
                message="device-to-host copy inside the program: forces a "
                        "device-host sync"),)
        if op.rounding_helper is None and any(o.dtype in _F64
                                              for o in op.outputs):
            return (Finding(
                rule=self.id, op=op.name,
                message="float64 value outside the single-rounding helpers "
                        "- promotion changes decisions across backends"),)
        return ()


class ForbiddenPrimitivesRule(Rule):
    """The listed aten operations must not run (e.g. ``("erf",)`` pins that
    the budget filter thresholds z-scores instead of evaluating a cdf)."""

    id = "FORBID"

    def __init__(self, primitives, reason: str = "forbidden primitive"):
        self.primitives = frozenset(primitives)
        self.reason = reason

    def check(self, op, get):
        if op.name not in self.primitives:
            return ()
        return (Finding(rule=self.id, op=op.name, message=self.reason),)


def default_rules(*, m: int | None = None, mask_argnums=(),
                  clean_argnums=()) -> list[Rule]:
    """The standard contract: R1 + R2 + R4 always; R3 iff the program is
    padded (``m`` given, with its mask/clean argument positions)."""
    rules: list[Rule] = [QuantizedArgmaxRule(), SizeInvariantPRNGRule(),
                         NoF64NoCallbackRule()]
    if m is not None:
        rules.insert(2, MaskedReduceRule(m, mask_argnums=mask_argnums,
                                         clean_argnums=clean_argnums))
    return rules
