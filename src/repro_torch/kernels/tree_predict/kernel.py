"""Wrapper of the CUDA forest-inference kernel (``csrc/tree_predict.cu``).

:func:`plan` picks the launch (tiles of points, threads over the tile's
(point, tree) pairs, shared bytes), :func:`prepare` checks the inputs and
allocates the outputs, :func:`launch` launches once on prepared arguments,
and :func:`tree_predict_cuda` does both and counts the launch in
``tree_predict_cuda.launches`` (and nowhere else), so a run can show that
it went through the kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import capi

__all__ = ["Plan", "attributes", "launch", "plan", "prepare", "smem_bytes",
           "tree_predict_cuda"]

_OP = "tree_predict"
MAX_THREADS = 256        # threads a block (the kernel's __launch_bounds__)
TILE_MIN, TILE_MAX = 8, 256
MAX_DEPTH = 20
SMEM_LIMIT = 232448      # dynamic shared memory a block may opt in to
SMEM_PER_SM = 233472     # shared memory an SM has for its blocks
SMEM_RESERVED = 1024     # what the card reserves of it for each block
THREADS_PER_SM = 2048
BLOCKS_PER_SM = 32


class Plan(NamedTuple):
    """Launch geometry: ``grid`` blocks of ``threads`` threads, each block
    walking tiles of ``tile`` points over ``smem`` bytes of dynamic shared
    memory."""

    grid: int
    threads: int
    tile: int
    smem: int


def _a16(x: int) -> int:
    return (x + 15) // 16 * 16


def smem_bytes(tile, n_feat, n_trees, depth) -> int:
    """Dynamic shared memory of a block, as the kernel lays it out: the
    forest as a heap of 8-byte (feature, threshold) nodes, 2^D - 1 a tree,
    the leaves [B, 2^D], the tile's rows [tile, F] and the predictions
    [B, tile], each region rounded up to 16 bytes."""
    n_leaves = 2 ** depth
    return (_a16(8 * n_trees * (n_leaves - 1)) + _a16(4 * n_trees * n_leaves)
            + _a16(4 * tile * n_feat) + _a16(4 * tile * n_trees))


def plan(m_dim, n_feat, n_trees, depth, *, sm_count) -> Plan:
    """The launch for M points of F features and B trees of depth D.

    The tile is the power of two (``TILE_MIN`` to ``TILE_MAX``) that gives
    about two tiles an SM, so that a small M spreads over the card: M =
    384 with B = 10 takes 48 blocks of 8 points, 80 (point, tree) pairs
    each.  It is halved while a block's shared memory would exceed a
    block's limit; a forest that does not fit beside one point raises
    ``ValueError``, as do B < 1, D outside 0..``MAX_DEPTH`` and F < 1.
    Threads cover the tile's pairs up to ``MAX_THREADS`` and are a
    multiple of the tile (a thread keeps one point); the grid is at most
    the blocks the card holds at once, each walking its tiles."""
    if n_trees < 1 or n_feat < 1 or m_dim < 0:
        raise ValueError(f"{_OP}: {n_trees} trees, {n_feat} features, "
                         f"{m_dim} points: need at least one tree and "
                         f"feature")
    if not 0 <= depth <= MAX_DEPTH:
        raise ValueError(f"{_OP}: depth {depth}; the kernel takes 0 to "
                         f"{MAX_DEPTH}")
    want = -(-m_dim // (2 * sm_count))
    tile = min(TILE_MAX, max(TILE_MIN, 1 << max(0, want - 1).bit_length()))
    while tile > 1 and smem_bytes(tile, n_feat, n_trees, depth) > SMEM_LIMIT:
        tile //= 2
    smem = smem_bytes(tile, n_feat, n_trees, depth)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"{_OP}: B = {n_trees}, D = {depth}, F = {n_feat} need {smem} "
            f"bytes of shared memory a block (limit {SMEM_LIMIT}): a block "
            f"keeps the forest and at least one point's row and "
            f"predictions")
    threads = min(MAX_THREADS, max(32, -(-tile * n_trees // 32) * 32))
    per_sm = max(1, min(THREADS_PER_SM // threads, BLOCKS_PER_SM,
                        SMEM_PER_SM // (smem + SMEM_RESERVED)))
    grid = max(1, min(-(-m_dim // tile), sm_count * per_sm))
    return Plan(grid, threads, tile, smem)


def _fn():
    return capi.entry(_OP, "tree_predict_launch",
                      [capi.P] * 4 + [capi.F] + [capi.I] * 9
                      + [capi.P] * 3)


def attributes(depth: int) -> tuple[int, int]:
    """(registers a thread, local bytes) of the kernel for trees of
    ``depth``, as the card's loaded module reports them."""
    fn = capi.entry(_OP, "tree_predict_attributes", [capi.I, capi.P,
                                                     capi.P])
    regs, local = ctypes.c_int(), ctypes.c_int()
    capi.raise_on_error(_OP, fn(depth, ctypes.addressof(regs),
                                ctypes.addressof(local)))
    return regs.value, local.value


def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


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
    if depth > 0 and width < 1:
        raise ValueError(f"{_OP}: node width {width}; need at least 1")
    capi.check(_OP, "x", x, torch.float32, (m_dim, n_feat), dev)
    capi.check(_OP, "feat", feat, torch.int32, (n_trees, depth, width), dev)
    capi.check(_OP, "thr", thr, torch.float32, (n_trees, depth, width), dev)
    capi.check(_OP, "leaf", leaf, torch.float32, (n_trees, n_leaves), dev)
    geo = plan(m_dim, n_feat, n_trees, depth, sm_count=_sm_count(dev.index))
    mu = torch.empty((m_dim,), dtype=torch.float32, device=dev)
    sigma = torch.empty((m_dim,), dtype=torch.float32, device=dev)
    floor = float(np.float32(float(sigma_floor)))
    args = (x.data_ptr(), feat.data_ptr(), thr.data_ptr(), leaf.data_ptr(),
            floor, m_dim, n_feat, n_trees, depth, width, geo.grid,
            geo.threads, geo.tile.bit_length() - 1, geo.smem,
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
