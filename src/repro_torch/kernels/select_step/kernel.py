"""Wrapper of the CUDA selector-step kernel (``csrc/select_step.cu``).

Checks device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on ``torch.cuda.current_stream()`` and raises if
the launch reports an error.  ``select_step_cuda.launches`` counts the
launches it makes (and nothing else), so a run can show that its
selections went through the kernel.  :func:`prepare` and :func:`launch`
split a call, so that a benchmark can time launches alone.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.acquisition import normal_quantile
from repro_torch.kernels import capi

__all__ = ["launch", "prepare", "select_step_cuda"]

_OP = "select_step"


def _fn():
    return capi.entry(_OP, "select_step_launch",
                      [capi.P] * 13 + [capi.F, capi.F] + [capi.I] * 12
                      + [capi.P] * 12 + [capi.P])


def _check(name, t, dtype, shape, device):
    capi.check(_OP, name, t, dtype, shape, device)


def prepare(feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor,
            xi=None, cens=None, valid=None, *, conf=0.99, cens_rel=0.5,
            score_mode="eic", use_budget=True, emit_full=False,
            want_nodes=False):
    """Check the inputs and allocate the outputs of one launch.

    Returns ``(args, out, keep)``: the argument tuple of the C entry
    ``select_step_launch``, the output tensors in :func:`select_step_cuda`'s
    order, and the input tensors ``args`` points into, which the caller
    keeps alive while it launches.
    """
    if want_nodes and xi is None:
        raise ValueError("want_nodes=True requires xi")
    if score_mode not in ("eic", "ratio"):
        raise ValueError(f"score_mode={score_mode!r}: expected 'eic' or "
                         "'ratio'")
    dev = capi.require_cuda(_OP, y)
    s_dim, n_trees, depth, width = feat.shape
    n_leaves = leaf.shape[-1]
    m_dim, n_feat = points.shape
    if n_leaves != 2 ** depth:
        raise ValueError(f"leaf width {n_leaves} != 2**depth ({2 ** depth})")
    _check("feat", feat, torch.int32, (s_dim, n_trees, depth, width), dev)
    _check("thr", thr, torch.float32, (s_dim, n_trees, depth, width), dev)
    _check("leaf", leaf, torch.float32, (s_dim, n_trees, n_leaves), dev)
    _check("y", y, torch.float32, (s_dim, m_dim), dev)
    _check("obs", obs, torch.bool, (s_dim, m_dim), dev)
    _check("beta", beta, torch.float32, (s_dim,), dev)
    _check("bf", bf, torch.float32, (s_dim,), dev)
    _check("points", points, torch.float32, (m_dim, n_feat), dev)
    _check("u", u, torch.float32, (m_dim,), dev)
    if cens is not None:
        _check("cens", cens, torch.bool, (s_dim, m_dim), dev)
    if valid is not None:
        _check("valid", valid, torch.bool, (m_dim,), dev)
    k_gh = 0
    if want_nodes:
        k_gh = xi.shape[0]
        _check("xi", xi, torch.float32, (k_gh,), dev)
    scal = torch.stack([torch.as_tensor(t_max, dtype=torch.float32,
                                        device=dev).reshape(()),
                        torch.as_tensor(floor, dtype=torch.float32,
                                        device=dev).reshape(())])

    f32 = dict(dtype=torch.float32, device=dev)
    sel = torch.empty((s_dim,), dtype=torch.int32, device=dev)
    has = torch.empty((s_dim,), dtype=torch.bool, device=dev)
    mu = sig = eic = ystar = cand = nodes = nodes_y = None
    eic_sel = mu_sel = sig_sel = None
    if emit_full:
        mu = torch.empty((s_dim, m_dim), **f32)
        sig = torch.empty((s_dim, m_dim), **f32)
        eic = torch.empty((s_dim, m_dim), **f32)
        ystar = torch.empty((s_dim,), **f32)
        cand = torch.empty((s_dim, m_dim), dtype=torch.bool, device=dev)
        if want_nodes:
            nodes = torch.empty((s_dim, m_dim, k_gh), **f32)
            nodes_y = torch.empty((s_dim, m_dim, k_gh), **f32)
        out = (mu, sig, eic, ystar, cand, sel, has)
    else:
        eic_sel = torch.empty((s_dim,), **f32)
        mu_sel = torch.empty((s_dim,), **f32)
        sig_sel = torch.empty((s_dim,), **f32)
        if want_nodes:
            nodes = torch.empty((s_dim, k_gh), **f32)
        out = (sel, has, eic_sel, mu_sel, sig_sel)
    out += tuple(a for a in (nodes, nodes_y) if a is not None)
    inputs = (feat, thr, leaf, y, obs, cens, beta, bf, points, u, valid,
              xi if want_nodes else None, scal)
    outputs = (mu, sig, eic, ystar, cand, sel, has, nodes, nodes_y, eic_sel,
               mu_sel, sig_sel)
    args = (*map(capi.ptr, inputs),
            float(np.float32(normal_quantile(float(conf)))),
            float(np.float32(cens_rel)),
            s_dim, n_trees, depth, width, n_leaves, m_dim, n_feat, k_gh,
            int(score_mode == "ratio"), int(bool(use_budget)),
            int(bool(emit_full)), int(bool(want_nodes)),
            *map(capi.ptr, outputs), capi.stream(dev))
    return args, out, (feat, thr, leaf, y, obs, cens, beta, bf, points, u,
                       valid, xi, scal)


def launch(args) -> None:
    """One launch of the kernel on prepared arguments; raises if the launch
    reports a CUDA error.  Does not count (see :func:`select_step_cuda`)."""
    capi.raise_on_error(_OP, _fn()(*args))


def select_step_cuda(feat, thr, leaf, y, obs, beta, bf, points, u, t_max,
                     floor, xi=None, cens=None, valid=None, **kw):
    """The fused selector step on the card; same contract and outputs as
    :func:`repro_torch.kernels.select_step.ref.select_step_ref`.

    ``t_max`` and ``floor`` may be Python numbers or float32 tensors on the
    card (kept there: no host round trip per call).
    """
    args, out, _keep = prepare(feat, thr, leaf, y, obs, beta, bf, points, u,
                               t_max, floor, xi, cens, valid, **kw)
    launch(args)
    select_step_cuda.launches += 1
    return out


select_step_cuda.launches = 0
