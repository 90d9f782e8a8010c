"""Carry state across from numpy arrays, so that the JAX package and the
port compute on the same objects.

The tests hand the same forest, space or job to both packages: the JAX
side's arrays go through ``np.asarray`` and come back here as the port's
tensors and dataclasses.  Nothing in this module imports the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.space import DiscreteSpace, GeometryBucket, PaddedSpace
from repro_torch.core.trees import ForestParams
from repro_torch.device import resolve_device
from repro_torch.jobs.tables import JobTable
from repro_torch.models.params import fan_in, spec_leaves, unflatten

__all__ = ["forest_from_numpy", "space_from_numpy", "job_from_numpy",
           "numpy_params", "tree_from_numpy", "train_state_from_numpy"]


def forest_from_numpy(feat, thr, leaf, device="cuda") -> ForestParams:
    """A ``ForestParams`` (feat [..., B, D, W] int32, thr [..., B, D, W] and
    leaf [..., B, L] float32) from arrays, e.g. a JAX ``ForestParams``, on
    ``device``: the card unless the caller asks for the CPU (``cuda``
    without a card raises)."""
    device = resolve_device(device)
    return ForestParams(
        torch.as_tensor(np.asarray(feat, np.int32), device=device),
        torch.as_tensor(np.asarray(thr, np.float32), device=device),
        torch.as_tensor(np.asarray(leaf, np.float32), device=device))


def space_from_numpy(names, points_raw, points, thresholds, *, valid=None,
                     bucket=None, native=None):
    """A ``DiscreteSpace`` from its arrays; with ``valid``/``bucket``/
    ``native`` given, the ``PaddedSpace`` they describe (``native`` is the
    unpadded space, itself built by this function)."""
    if valid is None:
        return DiscreteSpace(tuple(names), np.asarray(points_raw, np.float64),
                             np.asarray(points, np.float32),
                             np.asarray(thresholds, np.float32))
    if native is None or bucket is None:
        raise ValueError("a padded space needs its native space and bucket")
    if not isinstance(bucket, GeometryBucket):
        bucket = GeometryBucket(*bucket)
    return PaddedSpace(native=native, bucket=bucket,
                       points=np.asarray(points, np.float32),
                       thresholds=np.asarray(thresholds, np.float32),
                       valid=np.asarray(valid, bool))


def job_from_numpy(name, space, runtime, unit_price, t_max) -> JobTable:
    """A ``JobTable`` over a port space from its table columns."""
    return JobTable(str(name), space, np.asarray(runtime),
                    np.asarray(unit_price), float(t_max))


def numpy_params(specs, seed: int) -> dict:
    """Weights drawn with numpy for a ParamSpec tree: one
    ``default_rng(seed)`` visits the leaves in ``jax.tree`` order (keys
    sorted) and draws ``std · N(0, 1)`` float32 for each normal leaf, with
    the specs' std rule; zeros and ones as the specs say.  The same arrays
    go to both packages (``jnp.asarray`` on the JAX side,
    :func:`tree_from_numpy` here), which is how the tests and
    ``chip_smoke.py``'s golden check give them the same model."""
    rng = np.random.default_rng(seed)
    leaves = []
    for path, s in spec_leaves(specs):
        if s.init in ("zeros", "ones"):
            a = (np.zeros if s.init == "zeros" else np.ones)(s.shape,
                                                             np.float32)
        else:
            std = s.std if s.std is not None else fan_in(s) ** -0.5
            a = (std * rng.standard_normal(s.shape)).astype(np.float32)
        leaves.append((path, a))
    return unflatten(leaves, specs)


def tree_from_numpy(tree, device="cuda"):
    """A tree of tensors from the same tree of numpy arrays (dicts, lists
    and tuples kept as they are), one array to one tensor, nothing
    transposed: the reference's parameters or serving caches
    (``jax.tree.map(np.asarray, tree)``) become the port's, whose keys,
    layouts and dtypes are the reference's.  The tensors go to ``device``:
    the card unless the caller asks for the CPU (``cuda`` without a card
    raises)."""
    device = resolve_device(device)
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_from_numpy(v, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)


def train_state_from_numpy(params, mu, nu, step, residual=(), device="cuda"):
    """The port's ``train.step.TrainState`` from a reference TrainState's
    arrays (``params``, ``opt.mu``, ``opt.nu``, ``opt.step``,
    ``residual``; each tree through ``np.asarray``), on ``device`` (the
    card unless asked), so that both packages train from one state.  The
    step becomes a 0-d int32 tensor; an empty ``residual`` stays ``()``."""
    from repro_torch.optim.adamw import OptState
    from repro_torch.train.step import TrainState
    device = resolve_device(device)
    opt = OptState(tree_from_numpy(mu, device), tree_from_numpy(nu, device),
                   torch.as_tensor(np.asarray(step, np.int32),
                                   device=device))
    res = tree_from_numpy(residual, device) if len(residual) else ()
    return TrainState(tree_from_numpy(params, device), opt, res)
