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
from repro_torch.jobs.tables import JobTable

__all__ = ["forest_from_numpy", "space_from_numpy", "job_from_numpy"]


def forest_from_numpy(feat, thr, leaf, device="cpu") -> ForestParams:
    """A ``ForestParams`` (feat [..., B, D, W] int32, thr [..., B, D, W] and
    leaf [..., B, L] float32) from arrays, e.g. a JAX ``ForestParams``."""
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
