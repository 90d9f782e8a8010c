"""Wrapper of the CUDA selector-step kernel (``csrc/select_step.cu``).

Checks device, dtype, shape and contiguity, allocates the outputs with
``torch.empty``, launches on ``torch.cuda.current_stream()`` with the
geometry of :func:`plan` and raises if the launch reports an error.
``select_step_cuda.launches`` counts the launches it makes (and nothing
else), so a run can show that its selections went through the kernel.
:func:`prepare` and :func:`launch` split a call, so that a benchmark can
time launches alone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.acquisition import normal_quantile
from repro_torch.kernels import capi

__all__ = ["Plan", "attributes", "launch", "plan", "prepare",
           "select_step_cuda", "smem_bytes"]

_OP = "select_step"
MAX_TREES = 16           # the kernel is instantiated for 1..16 trees
MAX_THREADS = 384        # threads a block (its __launch_bounds__)
MAX_GROUPS = 15          # groups a block: one named barrier each
SMEM_LIMIT = 232448      # dynamic shared memory a block may opt in to
SMEM_PER_SM = 233472     # shared memory an SM has for its blocks
SMEM_RESERVED = 1024     # what the card reserves of it for each block
THREADS_PER_SM = 2048
# Warps a state takes when S > 1: a group of two warps gives each lane
# M/64 points (6 at M = 384) and two states a block's warps in flight.
WARPS_MANY = 2


class Plan(NamedTuple):
    """Launch geometry: ``grid`` blocks of ``threads`` threads, each block
    ``groups`` groups of ``warps_per_state`` warps (one state a group at a
    time) over ``smem`` bytes of dynamic shared memory."""

    grid: int
    threads: int
    warps_per_state: int
    groups: int
    smem: int


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(n_trees, depth, m_dim, n_feat, *, cens, warps_per_state,
               groups) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out
    (``make_layout`` in the source): the block-resident points tile
    (feature-major), unit prices and validity mask; then per group two
    stage buffers of one state's forest and y/obs[/cens] rows, the forest
    repacked as a heap of (feature, threshold) pairs and leaves, the pass-1
    scratch (forest sum and sigma a point) and the reduction slots."""
    width = 2 ** (depth - 1) if depth > 0 else 1
    n_leaves = 2 ** depth
    resident = _a16(m_dim * n_feat * 4) + _a16(m_dim * 4) + _a16(m_dim)
    stage = (2 * _a16(n_trees * depth * width * 4) + _a16(n_trees * n_leaves
                                                          * 4)
             + _a16(m_dim * 4) + _a16(m_dim) + (_a16(m_dim) if cens else 0))
    group = (2 * stage + _a16(n_trees * (2 * n_leaves - 1) * 8)
             + 2 * _a16(m_dim * 4) + warps_per_state * 32)
    return resident + groups * group


def plan(s_dim, n_trees, depth, m_dim, n_feat, *, cens, sm_count,
         warps_per_state=None) -> Plan:
    """The launch geometry for S states of B-tree forests of depth D over M
    points of F features; raises ``ValueError`` for a shape the kernel
    does not take (B outside 1..16, D < 0, F < 1, M < 1, or one state's
    buffers beyond a block's shared memory).

    Lanes per state follow S: the root sweep (S = 1) gets one group of
    ceil(M/32) warps (one point a lane, at most 12 warps); a batch of
    states, as many groups a block as two blocks an SM can hold in shared
    memory (fewer where S is small, so that the states spread over the
    SMs), ``WARPS_MANY`` warps a group (more where shared memory holds
    few groups), and a persistent grid of at most the blocks the card
    holds at once, whose groups stride over the states.
    ``warps_per_state`` overrides the warps a group (for measurements).
    """
    if not 1 <= n_trees <= MAX_TREES:
        raise ValueError(f"{_OP}: {n_trees} trees; the kernel takes 1 to "
                         f"{MAX_TREES}")
    if depth < 0 or n_feat < 1 or m_dim < 1 or s_dim < 0:
        raise ValueError(f"{_OP}: depth {depth}, {n_feat} features, "
                         f"{m_dim} points, {s_dim} states: need depth >= 0 "
                         f"and at least one feature and point")
    warps_max = min(MAX_THREADS // 32, -(-m_dim // 32))
    size = lambda wps, groups: smem_bytes(n_trees, depth, m_dim, n_feat,
                                          cens=cens, warps_per_state=wps,
                                          groups=groups)
    if size(warps_max, 1) > SMEM_LIMIT:
        raise ValueError(
            f"{_OP}: B = {n_trees}, D = {depth}, M = {m_dim}, F = {n_feat} "
            f"need {size(warps_max, 1)} bytes of shared memory a block "
            f"(limit {SMEM_LIMIT}): a block keeps the points tile and two "
            f"of one state's forest and rows")
    if s_dim <= 1:
        wps, groups = warps_max, 1
    else:
        # As many groups a block as two blocks an SM hold in shared memory,
        # no more than the states need (a small batch spreads over the
        # SMs); WARPS_MANY warps a group, more where few groups fit.
        budget = SMEM_PER_SM // 2 - SMEM_RESERVED
        per_group = size(1, 2) - size(1, 1)
        fit = (budget - (size(1, 1) - per_group)) // per_group
        groups = max(1, min(MAX_GROUPS, MAX_THREADS // (32 * WARPS_MANY),
                            fit, -(-s_dim // (2 * sm_count))))
        wps = min(warps_max, max(WARPS_MANY,
                                 MAX_THREADS // 32 // max(fit, 1)))
    if warps_per_state is not None:
        if not 1 <= warps_per_state <= MAX_THREADS // 32:
            raise ValueError(f"{_OP}: {warps_per_state} warps a state")
        wps = warps_per_state
        groups = min(groups, MAX_THREADS // (32 * wps))
    threads = 32 * wps * groups
    smem = size(wps, groups)
    per_sm = max(1, min(SMEM_PER_SM // (smem + SMEM_RESERVED),
                        THREADS_PER_SM // threads))
    grid = max(1, min(-(-s_dim // groups), sm_count * per_sm))
    return Plan(grid, threads, wps, groups, smem)


def _fn():
    return capi.entry(_OP, "select_step_launch",
                      [capi.P] * 14 + [capi.F, capi.F] + [capi.I] * 17
                      + [capi.P] * 12 + [capi.P])


def attributes(n_trees: int) -> tuple[int, int]:
    """(registers a thread, local bytes) of the kernel for ``n_trees``
    trees, as the card's loaded module reports them."""
    fn = capi.entry(_OP, "select_step_attributes",
                    [capi.I, capi.P, capi.P])
    regs, local = ctypes.c_int(), ctypes.c_int()
    capi.raise_on_error(_OP, fn(n_trees, ctypes.addressof(regs),
                                ctypes.addressof(local)))
    return regs.value, local.value


def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, t, dtype, shape, device):
    capi.check(_OP, name, t, dtype, shape, device)


def state_floor(floor, s_dim, device) -> torch.Tensor:
    """The sigma floor of each of ``s_dim`` states as a contiguous float32
    ``[S]`` tensor on ``device``: a ``[S]`` tensor as it is, a Python number
    or a 0-d (or one-element) tensor broadcast to every state."""
    f = torch.as_tensor(floor, dtype=torch.float32, device=device)
    if f.numel() == 1 and s_dim != 1:
        return f.reshape(1).expand(s_dim).contiguous()
    if f.shape not in ((s_dim,), ()):
        raise ValueError(f"{_OP}: floor of shape {tuple(f.shape)}; expected "
                         f"a scalar or one a state, ({s_dim},)")
    return f.reshape(s_dim).contiguous()


def prepare(feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor,
            xi=None, cens=None, valid=None, *, conf=0.99, cens_rel=0.5,
            score_mode="eic", use_budget=True, emit_full=False,
            want_nodes=False, warps_per_state=None):
    """Check the inputs, plan the launch and allocate its outputs.

    Returns ``(args, out, keep)``: the argument tuple of the C entry
    ``select_step_launch``, the output tensors in :func:`select_step_cuda`'s
    order, and the input tensors ``args`` points into, which the caller
    keeps alive while it launches.  ``warps_per_state`` overrides
    :func:`plan`'s choice.
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
    if width != (2 ** (depth - 1) if depth > 0 else 1):
        raise ValueError(f"node width {width} != 2**(depth-1)")
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
    geo = plan(s_dim, n_trees, depth, m_dim, n_feat, cens=cens is not None,
               sm_count=_sm_count(dev.index),
               warps_per_state=warps_per_state)
    k_gh = 0
    if want_nodes:
        k_gh = xi.shape[0]
        _check("xi", xi, torch.float32, (k_gh,), dev)
    scal = torch.as_tensor(t_max, dtype=torch.float32,
                           device=dev).reshape(1)
    sig_floor = state_floor(floor, s_dim, dev)

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
              xi if want_nodes else None, scal, sig_floor)
    outputs = (mu, sig, eic, ystar, cand, sel, has, nodes, nodes_y, eic_sel,
               mu_sel, sig_sel)
    args = (*map(capi.ptr, inputs),
            float(np.float32(normal_quantile(float(conf)))),
            float(np.float32(cens_rel)),
            s_dim, n_trees, depth, width, n_leaves, m_dim, n_feat, k_gh,
            int(score_mode == "ratio"), int(bool(use_budget)),
            int(bool(emit_full)), int(bool(want_nodes)), geo.grid,
            geo.threads, geo.warps_per_state, geo.groups, geo.smem,
            *map(capi.ptr, outputs), capi.stream(dev))
    return args, out, (feat, thr, leaf, y, obs, cens, beta, bf, points, u,
                       valid, xi, scal, sig_floor)


def launch(args) -> None:
    """One launch of the kernel on prepared arguments; raises if the launch
    reports a CUDA error.  Does not count (see :func:`select_step_cuda`)."""
    capi.raise_on_error(_OP, _fn()(*args))


def select_step_cuda(feat, thr, leaf, y, obs, beta, bf, points, u, t_max,
                     floor, xi=None, cens=None, valid=None, **kw):
    """The fused selector step on the card; same contract and outputs as
    :func:`repro_torch.kernels.select_step.ref.select_step_ref`.

    ``t_max`` may be a Python number or a float32 tensor on the card, and
    ``floor`` the same or a float32 ``[S]`` tensor, each state's own sigma
    floor (kept on the card: no host round trip per call).
    """
    args, out, _keep = prepare(feat, thr, leaf, y, obs, beta, bf, points, u,
                               t_max, floor, xi, cens, valid, **kw)
    launch(args)
    select_step_cuda.launches += 1
    return out


select_step_cuda.launches = 0
