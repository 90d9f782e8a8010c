"""Wrapper of the CUDA forest-inference kernel (``csrc/tree_predict.cu``).

:func:`prepare` checks the inputs and allocates the outputs, :func:`launch`
launches once on prepared arguments, and :func:`tree_predict_cuda` does
both and counts the launch in ``tree_predict_cuda.launches`` (and nowhere
else), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import capi

__all__ = ["launch", "prepare", "tree_predict_cuda"]

_OP = "tree_predict"


def _fn():
    return capi.entry(_OP, "tree_predict_launch",
                      [capi.P] * 4 + [capi.F] + [capi.I] * 6 + [capi.P] * 3)


def prepare(x, feat, thr, leaf, *, sigma_floor=1e-6):
    """Returns ``(args, out, keep)``: the C entry's arguments, the outputs
    ``(mu, sigma)`` and the inputs ``args`` points into."""
    dev = capi.require_cuda(_OP, x)
    m_dim, n_feat = x.shape
    n_trees, depth, width = feat.shape
    n_leaves = leaf.shape[-1]
    if n_leaves != 2 ** depth:
        raise ValueError(f"{_OP}: leaf width {n_leaves} != 2**depth "
                         f"({2 ** depth})")
    capi.check(_OP, "x", x, torch.float32, (m_dim, n_feat), dev)
    capi.check(_OP, "feat", feat, torch.int32, (n_trees, depth, width), dev)
    capi.check(_OP, "thr", thr, torch.float32, (n_trees, depth, width), dev)
    capi.check(_OP, "leaf", leaf, torch.float32, (n_trees, n_leaves), dev)
    mu = torch.empty((m_dim,), dtype=torch.float32, device=dev)
    sigma = torch.empty((m_dim,), dtype=torch.float32, device=dev)
    floor = float(np.float32(float(sigma_floor)))
    args = (x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
            floor, m_dim, n_feat, n_trees, depth, width, n_leaves,
            mu.data_ptr(), sigma.data_ptr(), capi.stream(dev))
    return args, (mu, sigma), (x, feat, thr, leaf)


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def tree_predict_cuda(x, feat, thr, leaf, *, sigma_floor=1e-6):
    """Forest mu and sigma on the card; the contract of
    :func:`repro_torch.kernels.tree_predict.ref.tree_predict_ref`."""
    args, out, _keep = prepare(x, feat, thr, leaf, sigma_floor=sigma_floor)
    launch(args)
    tree_predict_cuda.launches += 1
    return out


tree_predict_cuda.launches = 0
