"""Logical-axis sharding on ``torch.distributed`` — ``repro.shard.api``
over a ``DeviceMesh`` and DTensor.

One rule table maps logical axis names to mesh axes.  Models annotate
parameters (``ParamSpec.axes``) and activations (``constrain``) with
logical names; this module turns them into a spec under the active
(mesh, rules) context.  The reference's two guards make one table safe
for every architecture on any mesh:

* divisibility — a dim is sharded only if its size divides evenly by the
  mesh axes assigned to it (gemma-2b's 8 query heads stay replicated on a
  16-way model axis);
* uniqueness — a mesh axis is used at most once per spec (the leftmost
  logical axis wins), so ``[layers, experts, embed, ffn]`` takes 'model'
  on experts and leaves ffn replicated.

A spec is a tuple with one entry per leading tensor dim (None, a mesh
axis name, or a tuple of names), trailing Nones trimmed: the reference's
``PartitionSpec`` entries.  :class:`NamedSharding` is the mesh plus the
DTensor placements of a spec: an entry such as ``("pod", "data")`` on
tensor dim d is ``Shard(d)`` on each of those mesh dims (the first the
major one, as in JAX), and a mesh dim no entry names is ``Replicate()``.
Because of the divisibility guard every shard has the same size.

``pspec_for`` reads the mesh's axis sizes through :func:`axis_sizes`,
which takes a ``DeviceMesh`` (``mesh_dim_names`` and ``shape``) or any
object whose ``.shape`` maps names to sizes, so the rules are checked
without a process group.  ``constrain`` reads a contextvar that the step
factories set, so model code stays mesh-agnostic: on a plain tensor, or
outside a context, it returns its input.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Mapping

import numpy as np
import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

__all__ = ["BASE_RULES", "make_rules", "pspec_for", "sharding_for",
           "activation_ctx", "constrain", "mesh_axis_size", "axis_sizes",
           "placements_for", "local_slices", "contiguous_stride",
           "NamedSharding", "current_ctx", "empty", "constrain_fused",
           "pin_grad"]

# Default rule table: TP on 'model', DP/FSDP on ('pod', 'data').
BASE_RULES: dict[str, object] = {
    # ---- parameter axes ---- #
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "ffn": "model",
    "experts": "model",
    "embed": "data",          # FSDP: weights' d_model dim sharded over data
    "layers": None,
    "head_dim": None,
    "q_lora": None,
    "kv_lora": "model",       # MLA latent projections: shard the rank dim
    "state": None,
    "conv": None,
    "ssm_inner": "model",
    # ---- activation axes ---- #
    "batch": ("pod", "data"),
    "act_seq": None,
    "cache_seq": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_ffn": "model",
    "moe_groups": ("pod", "data"),
    "moe_dispatch": ("pod", "data"),   # group dim of the [G,E,C,D] buffers
    "experts_act": "model",
}


def make_rules(**overrides) -> dict:
    r = dict(BASE_RULES)
    r.update(overrides)
    return r


def axis_sizes(mesh) -> dict[str, int]:
    """{mesh axis name: size} of a ``DeviceMesh`` or of any object whose
    ``.shape`` maps names to sizes (the reference tests' fake meshes)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def mesh_axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def pspec_for(shape, logical_axes, rules: Mapping, mesh) -> tuple:
    """The spec of a tensor, with the divisibility and uniqueness guards."""
    sizes = axis_sizes(mesh)
    used: set[str] = set()
    out = []
    for size, name in zip(shape, logical_axes):
        assignment = rules.get(name) if name is not None else None
        if assignment is None:
            out.append(None)
            continue
        names = ((assignment,) if isinstance(assignment, str)
                 else tuple(assignment))
        names = tuple(n for n in names if n in sizes and n not in used)
        total = 1
        for n in names:
            total *= sizes[n]
        if not names or total == 1 or size % total != 0:
            out.append(None)
            continue
        used.update(names)
        out.append(names[0] if len(names) == 1 else names)
    while out and out[-1] is None:                  # trim trailing Nones
        out.pop()
    return tuple(out)


def placements_for(spec, mesh_dim_names) -> tuple:
    """The DTensor placements, one per mesh dim, of a spec."""
    where = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for n in ((entry,) if isinstance(entry, str) else entry):
            where[n] = d
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in mesh_dim_names)


def contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= int(n)
    return tuple(reversed(stride))


def local_slices(shape, mesh, placements) -> tuple:
    """The slices of a tensor of ``shape`` that this rank holds under
    ``placements`` (even shards; the mesh dims that shard one tensor dim
    split it in mesh order, the first the major one)."""
    coord = mesh.get_coordinate()
    index = [0] * len(shape)
    parts = [1] * len(shape)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            index[pl.dim] = index[pl.dim] * mesh.size(m) + coord[m]
            parts[pl.dim] *= mesh.size(m)
    out = []
    for n, i, k in zip(shape, index, parts):
        step = n // k
        out.append(slice(i * step, (i + 1) * step))
    return tuple(out)


class NamedSharding:
    """A mesh and a spec, with the spec's DTensor ``placements`` — the
    analog of ``jax.sharding.NamedSharding``."""

    def __init__(self, mesh, spec: tuple):
        self.mesh, self.spec = mesh, tuple(spec)
        self.placements = placements_for(self.spec, mesh.mesh_dim_names)

    def local_slices(self, shape) -> tuple:
        """The slices of a tensor of ``shape`` that this rank holds."""
        return local_slices(shape, self.mesh, self.placements)

    def distribute(self, tensor):
        """``tensor`` (the full value, the same on every rank) as a DTensor
        holding this rank's shard, cut locally with no collective; a
        DTensor is redistributed."""
        if isinstance(tensor, DTensor):
            return tensor.redistribute(self.mesh, self.placements)
        return distribute_tensor(tensor, self.mesh, self.placements,
                                 src_data_rank=None)

    def from_host(self, array, device):
        """A numpy array (the full value, the same on every rank) as a
        DTensor on ``device`` from this rank's slice alone: the rest of
        the array never reaches the device."""
        array = np.asarray(array)
        local = np.array(array[self.local_slices(array.shape)], order="C")
        return DTensor.from_local(torch.as_tensor(local, device=device),
                                  self.mesh, self.placements,
                                  shape=torch.Size(array.shape),
                                  stride=contiguous_stride(array.shape))

    def __repr__(self):
        return f"NamedSharding(spec={self.spec}, {self.placements})"


def sharding_for(shape, logical_axes, rules, mesh) -> NamedSharding:
    return NamedSharding(mesh, pspec_for(shape, logical_axes, rules, mesh))


# --------------------------------------------------------------------------- #
# Activation constraints (a context the step factories set)
# --------------------------------------------------------------------------- #
_CTX: contextvars.ContextVar = contextvars.ContextVar("shard_ctx",
                                                     default=None)


@contextlib.contextmanager
def activation_ctx(mesh, rules: Mapping):
    tok = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(tok)


def current_ctx():
    """The active (mesh, rules), or None outside :func:`activation_ctx`."""
    return _CTX.get()


def empty(shape, logical_axes, dtype, device):
    """An uninitialised tensor of ``shape`` on ``device``; under a context
    a DTensor on the spec of ``logical_axes``, each rank allocating its
    shard on ``device`` (the mesh's device type, or ``meta`` in the dry
    run)."""
    ctx = _CTX.get()
    if ctx is None:
        return torch.empty(shape, dtype=dtype, device=device)
    mesh, rules = ctx
    placements = placements_for(pspec_for(shape, logical_axes, rules, mesh),
                                mesh.mesh_dim_names)
    local = [sl.stop - sl.start
             for sl in local_slices(shape, mesh, placements)]
    return DTensor.from_local(torch.empty(local, dtype=dtype, device=device),
                              mesh, placements, shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def constrain(x, logical_axes):
    """Redistribute a DTensor to the placements of its logical axes' spec
    (``with_sharding_constraint``); the identity on a plain tensor or
    outside a context."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    placements = placements_for(pspec_for(x.shape, logical_axes, rules, mesh),
                                mesh.mesh_dim_names)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def constrain_fused(x, logical_axes, groups: int):
    """:func:`constrain` for a DTensor whose last dim fuses ``groups``
    equal parts (heads x head_dim): that dim is placed as a dim of
    ``groups`` would be, so that it splits into (groups, rest) evenly on
    every rank.  A projection onto 8 KV heads on a 16-way model axis thus
    gathers its fused output rather than leave it split inside a head."""
    ctx = _CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    shape = tuple(x.shape[:-1]) + (groups,)
    placements = placements_for(pspec_for(shape, logical_axes, rules, mesh),
                                mesh.mesh_dim_names)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


def pin_grad(x):
    """``x`` itself; a DTensor's gradient comes back on ``x``'s placements
    (a redistribution onto its own placements, whose backward places the
    gradient there).  A fused view of a weight thus returns its gradient
    in a layout that the view's backward can split."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, x.placements)
