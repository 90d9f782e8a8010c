"""Rematerialisation of the training path — the reference's
``jax.checkpoint`` around a layer (``transformer._remat``,
``zamba._forward``, ``xlstm_model._forward``) as ``torch.utils.checkpoint``.

:func:`remat` wraps one unit of the training forward (a layer, Gemma2's
local/global pair, a Zamba2 group) under a policy:

* ``"full"``: ``checkpoint(fn, use_reentrant=False)``; the unit keeps its
  inputs and recomputes everything else in the backward;
* ``"dots"``: the same with a selective policy that saves the outputs of
  ``aten.mm`` and ``aten.addmm``, the products without batch dimensions
  that the reference's ``dots_with_no_batch_dims_saveable`` keeps, and
  recomputes the rest: ``aten.bmm``, the elementwise ops and the kernel
  ops.  The models write every such product as a matmul with a 2-D
  weight (``layers.project``, ``layers.project_out``, MLA's ``_up``),
  which reaches ``aten.mm``; an einsum would reach ``aten.bmm`` over a
  batch of one and be recomputed.  A kernel launch is opaque to the policy, which sees only the
  wrapper's ``aten.empty`` for the kernel's output; recomputing that
  ``empty`` relaunches the kernel into a fresh buffer;
* any other value: ``fn`` as it is.

Non-reentrant checkpointing only: the backward graph stays the same op
for op, so the gradients are bitwise those of ``remat="none"``, and it
runs with the kernels' ``autograd.Function``s, whose saved tensors (the
flash forward's ``lse``, the scan's chunk states) come back by launching
the forward kernel again.  The recomputation runs inside autograd's
backward, on its device thread on the card, where the step's activation
rules (``shard.activation_ctx``, a context variable) are not set: the
rules active when the unit ran forward are set again around it.
"""

from __future__ import annotations

import contextlib
from functools import partial

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.shard.api import activation_ctx, current_ctx

__all__ = ["POLICIES", "SAVED_BY_DOTS", "remat"]

POLICIES = ("full", "dots")
SAVED_BY_DOTS = frozenset({torch.ops.aten.mm.default,
                           torch.ops.aten.addmm.default})


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in SAVED_BY_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recompute(rules, inner):
    """``inner`` under the activation rules the forward ran with."""
    with (activation_ctx(*rules) if rules is not None
          else contextlib.nullcontext()), inner:
        yield


def _contexts(policy):
    rules = current_ctx()
    if policy == "dots":
        fwd, rec = create_selective_checkpoint_contexts(_dots_policy)
    else:
        fwd, rec = contextlib.nullcontext(), contextlib.nullcontext()
    return fwd, _recompute(rules, rec)


def remat(fn, policy: str):
    """``fn`` checkpointed under ``policy`` ("full" or "dots"); any other
    value returns ``fn`` itself."""
    if policy not in POLICIES:
        return fn
    return partial(checkpoint, fn, use_reentrant=False,
                   context_fn=partial(_contexts, policy))
