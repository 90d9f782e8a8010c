"""Parameter specs: declare once, then count, draw or convert.

Models declare their parameters as a tree of :class:`ParamSpec` (shape +
logical axis names + initializer) made of dicts, lists and tuples (the
xLSTM stack is a list of per-block dicts), as ``repro.models.params``
does, and the parameters themselves are a tree of tensors of the same
structure and the same layouts.  Leaves are visited in the order of
``jax.tree`` flattening: dict keys sorted, sequence items in index order,
at every level.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["ParamSpec", "spec", "spec_leaves", "fan_in", "init_params",
           "abstract_params", "logical_axes", "count_params", "unflatten",
           "tree_leaves", "tree_map", "tree_unflatten"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]   # logical axis name per dim (None = no name)
    init: str = "normal"           # normal | zeros | ones
    std: float | None = None       # None -> 1/sqrt(fan_in)

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec(shape, axes, init: str = "normal", std: float | None = None
         ) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), tuple(axes), init, std)


def spec_leaves(specs, prefix: tuple = ()):
    """``[(path, ParamSpec)]`` in ``jax.tree`` order: dict keys sorted,
    sequence items in index order.  A path holds the dict keys and the
    sequence indices on the way."""
    if isinstance(specs, ParamSpec):
        return [(prefix, specs)]
    items = (sorted(specs.items()) if isinstance(specs, dict)
             else enumerate(specs))
    out = []
    for key, sub in items:
        out += spec_leaves(sub, prefix + (key,))
    return out


def unflatten(paths_and_values, like):
    """The tree of ``like``'s structure (its dicts, lists and tuples) with
    the values of ``[(path, value)]`` at its leaves."""
    values = dict(paths_and_values)

    def build(node, path):
        if path in values:
            return values[path]
        if isinstance(node, dict):
            return {k: build(v, path + (k,)) for k, v in node.items()}
        return type(node)(build(v, path + (i,)) for i, v in enumerate(node))
    return build(like, ())


def _children(node):
    """A node's (key, child) pairs in ``jax.tree`` order, or None for a
    leaf: dict keys sorted, sequence (and named-tuple) items in order."""
    if isinstance(node, dict):
        return sorted(node.items())
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts, lists and tuples (named tuples
    too), in ``jax.tree`` order."""
    kids = _children(tree)
    if kids is None:
        return [tree]
    return [leaf for _, sub in kids for leaf in tree_leaves(sub)]


def tree_map(fn, tree, *rest):
    """``fn`` of the matching leaves of ``tree`` and ``rest`` (trees of the
    same structure), visited in ``jax.tree`` order; the result has
    ``tree``'s structure."""
    kids = _children(tree)
    if kids is None:
        return fn(tree, *rest)
    out = [(key, tree_map(fn, sub, *(r[key] for r in rest)))
           for key, sub in kids]
    if isinstance(tree, dict):
        return dict(out)
    values = [v for _, v in out]
    return (type(tree)(*values) if hasattr(tree, "_fields")
            else type(tree)(values))


def tree_unflatten(like, leaves):
    """The tree of ``like``'s structure holding ``leaves`` in
    ``jax.tree`` order (the inverse of :func:`tree_leaves`)."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, it) is not it:
        raise ValueError("more leaves than the tree has")
    return out


def fan_in(s: ParamSpec) -> int:
    """Every dim but the last (the output features) and the stacking axes."""
    stacked = {"layers", "experts", "groups"}
    dims = [d for d, a in zip(s.shape[:-1], s.axes[:-1]) if a not in stacked]
    return int(np.prod(dims)) if dims else 1


def init_params(specs, generator: torch.Generator, dtype=torch.float32,
                device="cuda"):
    """Materialize parameters on ``device`` (the card unless asked).

    Normal leaves are ``std · N(0, 1)`` drawn from ``generator`` (which must
    live on ``device``) leaf by leaf in ``jax.tree`` order, with the
    reference's std rule (``spec.std`` or ``fan_in ** -0.5``).  The bits
    differ from the reference's ``init_params``, which keys each leaf by
    its path through ``jax.random``; tests that compare the two packages
    draw one set of weights with numpy and hand it to both
    (``repro_torch.convert``).
    """
    dev = resolve_device(device)
    leaves = []
    for path, s in spec_leaves(specs):
        if s.init == "zeros":
            t = torch.zeros(s.shape, dtype=dtype, device=dev)
        elif s.init == "ones":
            t = torch.ones(s.shape, dtype=dtype, device=dev)
        else:
            std = s.std if s.std is not None else fan_in(s) ** -0.5
            t = torch.randn(s.shape, generator=generator, device=dev,
                            dtype=torch.float32).mul_(std).to(dtype)
        leaves.append((path, t))
    return unflatten(leaves, specs)


def abstract_params(specs, dtype=torch.bfloat16):
    """Stand-ins for the parameters on the ``meta`` device: each leaf's
    shape and dtype, no storage (the reference's ``ShapeDtypeStruct``
    tree)."""
    return unflatten([(path, torch.empty(s.shape, dtype=dtype,
                                         device="meta"))
                      for path, s in spec_leaves(specs)], specs)


def logical_axes(specs):
    """The tree of each leaf's logical axis names, the parameters'
    structure."""
    return unflatten([(path, s.axes) for path, s in spec_leaves(specs)],
                     specs)


def count_params(specs) -> int:
    return sum(int(np.prod(s.shape)) for _, s in spec_leaves(specs))
