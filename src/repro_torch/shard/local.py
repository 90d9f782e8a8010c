"""Ops that are local over batch (and heads) on DTensors: a sharded call
runs the op on each rank's shard.

The model kernels' entries (``flash_attention``, ``decode_attention``,
``linear_scan``) and the MoE's gather dispatch and combine hand DTensor
operands to :func:`run_local`.  It places
each operand on the spec of its logical axes under the active
``shard.activation_ctx`` (the models' ``constrain`` calls have put them
there already), checks that no dim but batch and heads is sharded, takes
each rank's local tensors (``to_local``), runs the op on them (the CUDA
kernel on the card, the plain version on the CPU, with autograd through
the op's ``autograd.Function``) and wraps the outputs back
(``from_local``).  Grouped-query attention whose query heads are sharded
while the key/value heads are not (fewer of them than the mesh axis)
takes on each rank the key/value heads of its query heads; their
gradients are then partial sums over that mesh axis.

A DTensor that reaches a kernel's wrapper or an ``autograd.Function``
any other way raises (:func:`reject`): it never falls through to
DTensor's decomposition of the plain version.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.shard.api import (constrain, contiguous_stride,
                                   current_ctx, local_slices)

__all__ = ["any_dtensor", "reject", "run_local", "elementwise"]


def any_dtensor(*tensors) -> bool:
    return any(isinstance(t, DTensor) for t in tensors)


def reject(op: str, *tensors) -> None:
    """Raise if a DTensor reached ``op``'s kernel wrapper or plain path
    directly."""
    if any_dtensor(*tensors):
        raise TypeError(
            f"{op}: a DTensor reached the op's kernel or plain version; "
            "sharded calls go through the op's entry under "
            "shard.activation_ctx, which runs it on each rank's shard")


def _heads_range(x, dim: int):
    """(first, count) of the heads this rank holds of DTensor ``x``."""
    sl = local_slices(x.shape, x.device_mesh, x.placements)[dim]
    return sl.start, sl.stop - sl.start


def run_local(op: str, fn, operands, *, heads: tuple, groups=(),
              outputs=()):
    """Run ``fn`` on each rank's shards of ``operands``.

    ``operands``: [(tensor or None, logical axes)], plain tensors and None
    passed as they are; ``heads``: the heads dim of each operand (None
    for none); ``groups``: [(query index, key index)] pairs of
    grouped-query operands, the key operand's heads shared by
    ``H / KH`` query heads; ``outputs``: for each output of ``fn`` (a
    tensor output alone: one entry), (the index of the operand whose
    batch and heads placements it takes, its own heads dim).  Returns
    ``fn``'s outputs as DTensors."""
    ctx = current_ctx()
    if ctx is None:
        raise TypeError(f"{op}: a DTensor operand outside "
                        "shard.activation_ctx: the op takes its placements "
                        "from the operands' logical axes under the rules")
    mesh = ctx[0]
    placed = []
    for i, (x, axes) in enumerate(operands):
        if not isinstance(x, DTensor):
            placed.append(x)
            continue
        x = constrain(x, axes)
        for pl in x.placements:
            if isinstance(pl, Shard) and pl.dim not in (0, heads[i]):
                raise NotImplementedError(
                    f"{op}: operand {i} is sharded on dim {pl.dim} "
                    f"({axes[pl.dim]!r}); the op is local over batch and "
                    "heads only")
        placed.append(x)
    grad_pl = {i: list(x.placements) for i, x in enumerate(placed)
               if isinstance(x, DTensor)}
    cut = {}
    for qi, ki in groups:
        q, k = placed[qi], placed[ki]
        for m, (pq, pk) in enumerate(zip(q.placements, k.placements)):
            if (isinstance(pq, Shard) and pq.dim == heads[qi]
                    and not isinstance(pk, Shard)):
                grad_pl[ki][m] = Partial()
        h0, hn = _heads_range(q, heads[qi])
        k0, kn = _heads_range(k, heads[ki])
        group = q.shape[heads[qi]] // k.shape[heads[ki]]
        lo, hi = h0 // group, (h0 + hn - 1) // group + 1
        if lo < k0 or hi > k0 + kn or (hn % group and group % hn):
            raise NotImplementedError(
                f"{op}: query heads [{h0}, {h0 + hn}) of groups of {group} "
                f"do not fall on the key heads [{k0}, {k0 + kn}) this rank "
                "holds")
        cut[ki] = (lo - k0, hi - lo)
    local = []
    for i, x in enumerate(placed):
        if not isinstance(x, DTensor):
            local.append(x)
            continue
        t = x.to_local(grad_placements=grad_pl[i])
        if i in cut:
            start, n = cut[i]
            if (start, n) != (0, t.shape[heads[i]]):
                t = t.narrow(heads[i], start, n).contiguous()
        local.append(t)
    out = fn(*local)
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(None if o is None else _wrap(o, placed[src], dim, mesh)
                    for o, (src, dim) in zip(outs, outputs))
    return wrapped[0] if single else wrapped


def _wrap(o, like, heads_dim, mesh):
    """The local output ``o`` as a DTensor sharded as ``like`` is on its
    batch dim and its heads dim (the output's ``heads_dim``)."""
    placements, shape = [], list(o.shape)
    for m, pl in enumerate(like.placements):
        if isinstance(pl, Shard):
            dim = 0 if pl.dim == 0 else heads_dim
            placements.append(Shard(dim))
            shape[dim] *= mesh.size(m)
        else:
            placements.append(pl)
    # The global stride is the contiguous one: so must the local be.
    return DTensor.from_local(o.contiguous(), mesh, placements,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def elementwise(fn, x):
    """``fn`` (an elementwise op) of ``x``; on a DTensor, applied to each
    rank's shard (a partial sum is reduced first), for ops that DTensor
    has no sharding rule for (``logsigmoid``'s backward)."""
    if not isinstance(x, DTensor):
        return fn(x)
    placements = [Replicate() if isinstance(pl, Partial) else pl
                  for pl in x.placements]
    x = x.redistribute(x.device_mesh, placements)
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, placements,
                              shape=x.shape, stride=x.stride())
