"""Bagging ensemble of regression trees, batched over explicit leading dims.

The PyTorch form of ``repro.core.trees`` — Lynceus' surrogate model (paper
§3: "a bagging ensemble of [10] decision trees").  Every array shape is
static, so one fit runs batched over thousands of speculative lookahead
states: where the reference ``vmap``s a single-tree fit over trees and over
states, the functions here take the states as leading dimensions of
``key``/``y``/``obs_mask`` and fit all (state, tree) pairs as one flat batch.

Representation (as in the reference): the training set is the whole space
``X ∈ [M, F]`` plus per-point weights (unobserved points weigh 0);
bootstrap resampling draws Poisson(1) weights per (tree, point); trees are
complete binary trees of static ``depth`` with per-level ``feat/thr``
arrays padded to ``W = 2**(depth-1)``; degenerate splits store ``thr =
+inf`` (everything routes left), empty children inherit the parent mean.

Bit-exactness with the reference, case by case:

* the bootstrap draws are the reference's threefry bits (``core.prng``),
  and their Knuth running product follows XLA's CPU ``cumprod`` order:
  two blocks of 16, each multiplied left to right, the second block then
  scaled by the first block's total;
* weight sums are integer-valued float32 sums, exact in any order;
* the pinned sums (``_pinned_sum0``, the tree-axis chain of
  ``forest_mu_sigma``) are written out in the reference's order;
* the per-node ``w·y`` sums that the reference leaves to XLA dots
  (``swy_n`` and the left-branch sums of the split search) follow the
  orders XLA's CPU backend takes: its reduction order at the root
  (``xla_sum``), point by point for the batched matrix-vector product
  below it (``_seq_sum_by_node``), and the shape-dependent order of its
  matrix product (``_xla_dot``).  Both are plain float32 adds, so the fit gives
  the same bits on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.acquisition import _div, _f32, ftz, sqrt_rn
from repro_torch.core.acquisition import no_contract as _no_contract
from repro_torch.core.acquisition import quantize_scores as _quantize_scores

__all__ = [
    "ForestParams", "bootstrap_weights", "make_left_table", "fit_forest",
    "predict_forest", "forest_mu_sigma", "fit_predict_mu_sigma",
]

_EPS = _f32(1e-12)
_BOOT_ITERS = 24
_KNUTH_L = _f32(np.exp(-1.0))
# XLA's CPU cumprod over the 24 Knuth draws runs in blocks of this length.
_CUMPROD_BLOCK = 16
# Element budget of one bootstrap chunk ([states, M, 24, B] int64 words).
_BOOT_CHUNK_ELEMS = 1 << 25


def _pinned_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` in the reference's fixed balanced pairwise order:
    zero-pad to a power of two, then repeatedly add the two halves."""
    x = x.movedim(dim, 0)
    m = x.shape[0]
    size = 1
    while size < m:
        size *= 2
    if size != m:
        x = torch.cat([x, x.new_zeros((size - m,) + x.shape[1:])], dim=0)
    while x.shape[0] > 1:
        half = x.shape[0] // 2
        x = x[:half] + x[half:]
    return x[0]


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dim in the order of XLA's CPU reduction: windows
    of 32 (the padding split evenly before and after), each window and
    then the window sums added left to right, recursively."""
    while x.shape[-1] > 32:
        n = x.shape[-1]
        padded = -(-n // 32) * 32
        lo = (padded - n) // 2
        x = torch.nn.functional.pad(x, (lo, padded - n - lo))
        x = x.reshape(x.shape[:-1] + (padded // 32, 32))
        acc = x[..., 0]
        for i in range(1, 32):
            acc = acc + x[..., i]
        x = acc
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _seq_sum_by_node(onehot: torch.Tensor, val: torch.Tensor
                     ) -> torch.Tensor:
    """``out[r, k] = sum over m of onehot[r, m, k]·val[r, m]``, added in
    point order: the order of XLA's CPU batched matrix-vector product (the
    reference's ``onehot.T @ wy`` under its vmap over trees).  Each 0/1
    product is exact, and adding a zero leaves a sum unchanged."""
    acc = onehot[:, 0, :] * val[:, 0, None]
    for m in range(1, val.shape[1]):
        acc = acc + onehot[:, m, :] * val[:, m, None]
    return acc


def _dot_lanes(rows: int, k: int, j: int) -> int:
    """Running sums XLA's CPU backend interleaves over k in a ``[rows, K] x
    [K, J]`` matrix product (measured for 24 <= K <= 512, 4 <= J <= 48)."""
    if rows == 1:
        return 1
    if j <= 16:
        return 4
    if rows <= 50:
        return 1
    if j <= 24:
        return 2 if k % 4 in (1, 2) else 4
    return 2 if j <= 32 else 4


def _xla_dot(a: torch.Tensor, b: torch.Tensor, rows: int) -> torch.Tensor:
    """``a @ b`` ([..., K] x [K, J]) in the summation order XLA's CPU
    backend gives the reference's split-search product, a ``[rows, K] x
    [K, J]`` matrix product: ``L = _dot_lanes(rows, K, J)`` interleaved
    running sums over k mod ``L`` (k below the last multiple of ``L``),
    combined pairwise (``s0 + s1``, or ``(s0 + s1) + (s2 + s3)``), plus the
    remaining k summed left to right.  ``L = 1`` is one running sum, k left
    to right.

    The products are exact here (``b`` is a 0/1 table), so the order alone
    decides the bits, and plain float32 adds give them on every device.
    """
    k, j = a.shape[-1], b.shape[1]
    lanes = _dot_lanes(rows, k, j)
    main = k - k % lanes
    acc = a.new_zeros(a.shape[:-1] + (lanes, j))
    for t in range(0, main, lanes):
        acc = acc + a[..., t:t + lanes, None] * b[t:t + lanes]
    while acc.shape[-2] > 1:
        acc = acc[..., 0::2, :] + acc[..., 1::2, :]
    out = acc[..., 0, :]
    if main < k:
        tail = a[..., main, None] * b[main]
        for t in range(main + 1, k):
            tail = tail + a[..., t, None] * b[t]
        out = out + tail
    return out


def _knuth_cumprod(u: torch.Tensor) -> torch.Tensor:
    """Running product over dim -2 in XLA CPU's blocked order."""
    outs = []
    total = None
    for start in range(0, u.shape[-2], _CUMPROD_BLOCK):
        acc = u[..., start, :]
        blk = [acc]
        for i in range(start + 1, min(start + _CUMPROD_BLOCK, u.shape[-2])):
            acc = acc * u[..., i, :]
            blk.append(acc)
        blk = torch.stack(blk, dim=-2)
        if total is not None:
            blk = blk * total[..., None, :]
        total = blk[..., -1, :]
        outs.append(blk)
    return torch.cat(outs, dim=-2)


def bootstrap_weights(key: torch.Tensor, n_trees: int, m: int) -> torch.Tensor:
    """Poisson(1) bootstrap weights ``[..., n_trees, m]`` — padding-invariant.

    Weight (b, i) is a pure function of ``(key, b, i)``: point i draws 24
    uniforms per tree under ``fold_in(key, i)`` and counts how many prefixes
    of their running product stay above e^-1 (Knuth's sampler).  States are
    drawn in chunks, which changes no bit (each state's draws depend only
    on its own key).
    """
    lead = key.shape[:-1]
    flat = key.reshape(-1, 2)
    per_state = m * _BOOT_ITERS * n_trees
    step = max(1, _BOOT_CHUNK_ELEMS // max(per_state, 1))
    pts = torch.arange(m, device=key.device)
    outs = []
    for s0 in range(0, flat.shape[0], step):
        k = flat[s0:s0 + step]
        point_keys = prng.fold_in(k[:, None, :], pts[None, :])      # [s, m, 2]
        u = prng.uniform(point_keys, (_BOOT_ITERS, n_trees))       # [s,m,I,B]
        cnt = (_knuth_cumprod(u) > _KNUTH_L).sum(dim=-2)           # [s, m, B]
        outs.append(cnt.transpose(-1, -2).to(torch.float32))
    return torch.cat(outs, dim=0).reshape(lead + (n_trees, m))


class ForestParams(NamedTuple):
    """Ensemble parameters. B = n_trees, D = depth, W = 2**(D-1), L = 2**D;
    any leading dims are states."""

    feat: torch.Tensor   # [..., B, D, W] int32 — split feature per node
    thr: torch.Tensor    # [..., B, D, W] f32  — split threshold (+inf = left)
    leaf: torch.Tensor   # [..., B, L]    f32  — leaf values


def make_left_table(points, thresholds, device=None) -> torch.Tensor:
    """LEFT[m, f, t] = (points[m, f] <= thresholds[f, t]) as float32."""
    points = torch.as_tensor(np.asarray(points), device=device)
    thresholds = torch.as_tensor(np.asarray(thresholds), device=device)
    return (points[:, :, None] <= thresholds[None, :, :]).to(torch.float32)


# The row width at which the reference's node sums of the split search are
# trees of halves (read from its compiled padded selector programs).
_BUCKET_ROW = 32


def _fit_trees(y, w, left, *, depth: int, min_weight: float, y_split=None):
    """Fit N independent trees. y, w: [N, M]; left: [M, F, T].  ``y_split``
    (default ``y``) is the y the split search's node sums read; ``y`` the
    one the leaf means read (see :func:`fit_forest`).

    Returns (assign [N, M], leaf [N, 2**depth], feat levels, thr meta)."""
    n_rows, m = w.shape
    _, f_dims, t_dims = left.shape
    width = 2 ** (depth - 1) if depth > 0 else 1
    dev = w.device
    left_flat = left.reshape(m, f_dims * t_dims)
    pts = torch.arange(m, device=dev)
    mw = _f32(min_weight)
    mw_child = _f32(min_weight - 1e-9)

    assign = torch.zeros((n_rows, m), dtype=torch.int64, device=dev)
    sw0 = w.sum(dim=1)
    wy = _no_contract(w * y)
    wys = wy if y_split is None else _no_contract(w * y_split)
    val = _div(_pinned_sum(wy, 1), torch.clamp_min(sw0, _EPS))[:, None]

    feat_lvls, thr_meta = [], []
    for lvl in range(depth):
        n = 2 ** lvl
        onehot = (assign[:, :, None]
                  == torch.arange(n, device=dev)).to(torch.float32)  # [N,M,n]
        sw_n = (onehot * w[:, :, None]).sum(dim=1)                   # [N, n]
        # Over the 32 points of the geometry bucket the reference's CPU
        # backend adds each node's row as a tree of halves.  Elsewhere, at
        # the root every point sits in node 0: XLA folds the one-hot to
        # ones and the product to a plain reduction; below it adds in point
        # order (ROADMAP C4).
        if m == _BUCKET_ROW:
            swy_n = _pinned_sum(onehot * wys[:, :, None], 1)
        elif lvl == 0:
            swy_n = xla_sum(wys)[:, None]
        else:
            swy_n = _seq_sum_by_node(onehot, wys)
        sl_w = torch.matmul((onehot * w[:, :, None]).transpose(1, 2),
                            left_flat)                               # [N,n,FT]
        sl_wy = _xla_dot((onehot * wys[:, :, None]).transpose(1, 2),
                         left_flat, rows=n_rows * 2 * n)
        sl_w = sl_w.reshape(n_rows, n, f_dims, t_dims)
        sl_wy = sl_wy.reshape(n_rows, n, f_dims, t_dims)
        sr_w = sw_n[:, :, None, None] - sl_w
        sr_wy = swy_n[:, :, None, None] - sl_wy
        ml = sl_wy / torch.clamp_min(sl_w, _EPS)
        mr = sr_wy / torch.clamp_min(sr_w, _EPS)
        d = ml - mr
        gain = ((sl_w * sr_w) / torch.clamp_min(sw_n, _EPS)[:, :, None, None]
                * (d * d))
        scale = ((swy_n * swy_n) / torch.clamp_min(sw_n, _EPS))[:, :, None,
                                                                None]
        gain = torch.where(gain < scale * _f32(1e-10),
                           torch.zeros_like(gain), gain)
        valid = (sl_w >= mw) & (sr_w >= mw)
        gain = torch.where(valid, gain, torch.full_like(gain, -math.inf))
        flat = _quantize_scores(gain).reshape(n_rows, n, f_dims * t_dims)
        best = torch.argmax(flat, dim=2)                             # [N, n]
        best_gain = flat.gather(2, best[:, :, None])[:, :, 0]
        f_sel = best // t_dims
        t_sel = best % t_dims
        degenerate = ~torch.isfinite(best_gain)
        f_sel = torch.where(degenerate, torch.zeros_like(f_sel), f_sel)

        feat_pad = torch.zeros((n_rows, width), dtype=torch.int32, device=dev)
        feat_pad[:, :n] = f_sel.to(torch.int32)
        feat_lvls.append(feat_pad)
        col = f_sel.gather(1, assign) * t_dims + t_sel.gather(1, assign)
        goes_left = left_flat[pts[None, :], col] > 0.5
        goes_left = goes_left | degenerate.gather(1, assign)
        assign = 2 * assign + (~goes_left).to(torch.int64)
        n2 = 2 * n
        oh2 = (assign[:, :, None]
               == torch.arange(n2, device=dev)).to(torch.float32)
        sw2 = (oh2 * w[:, :, None]).sum(dim=1)
        swy2 = _pinned_sum(oh2 * wy[:, :, None], 1)
        parent = val.repeat_interleave(2, dim=1)
        val = torch.where(sw2 > mw_child, swy2 / torch.clamp_min(sw2, _EPS),
                          parent)
        thr_meta.append((f_sel, t_sel, degenerate, n))
    return assign, val, feat_lvls, thr_meta


def fit_forest(key, y, obs_mask, points, left, thresholds, *, n_trees: int,
               depth: int, min_weight: float = 1.0, y_split=None):
    """Fit the bagged forest, for one state or a batch of states.

    Args:
      key: PRNG key ``[..., 2]`` (drives the Poisson bootstrap).
      y: ``[..., M]`` observed objective (arbitrary value where unobserved).
      obs_mask: ``[..., M]`` bool/float — 1 for observed points.
      points: ``[M, F]`` normalized features (unused by the fit itself: the
        split search reads ``left``; kept for the reference's signature).
      left: ``[M, F, T]`` precomputed ``make_left_table``.
      thresholds: ``[F, T]`` normalized threshold values (+inf padded).
      y_split: ``[..., M]`` or None (``y``): the y the split search reads,
        where the reference's program gives it another rounding of a
        speculated value than the leaf means get
        (``lookahead._lookahead_tail``).
    Returns:
      (ForestParams, per-tree leaf assignment ``[..., B, M]``).
    """
    del points
    lead = y.shape[:-1]
    m = y.shape[-1]
    width = 2 ** (depth - 1) if depth > 0 else 1
    y = y.reshape(-1, m).to(torch.float32)
    obs = obs_mask.reshape(-1, m).to(torch.float32)
    n_states = y.shape[0]
    boot = bootstrap_weights(key.reshape(-1, 2), n_trees, m)        # [S,B,M]
    w = boot * obs[:, None, :]
    dead = w.sum(dim=2, keepdim=True) < _f32(min_weight)
    w = torch.where(dead, obs[:, None, :].expand_as(w), w)
    rows = lambda v: v.reshape(-1, m).to(torch.float32)[:, None, :].expand(
        n_states, n_trees, m).reshape(-1, m)
    assign, leaf, feat_lvls, thr_meta = _fit_trees(
        rows(y), w.reshape(-1, m), left, depth=depth, min_weight=min_weight,
        y_split=None if y_split is None else rows(y_split))
    n_rows = n_states * n_trees
    if depth > 0:
        feat = torch.stack(feat_lvls, dim=1)
        thr_rows = []
        for f_sel, t_sel, degenerate, n in thr_meta:
            tv = thresholds[f_sel, t_sel]
            tv = torch.where(degenerate, torch.full_like(tv, math.inf), tv)
            row = torch.full((n_rows, width), math.inf, dtype=torch.float32,
                             device=y.device)
            row[:, :n] = tv
            thr_rows.append(row)
        thr = torch.stack(thr_rows, dim=1)
    else:
        feat = torch.zeros((n_rows, 0, width), dtype=torch.int32,
                           device=y.device)
        thr = torch.zeros((n_rows, 0, width), dtype=torch.float32,
                          device=y.device)
    shape = lead + (n_trees,)
    params = ForestParams(feat.reshape(shape + feat.shape[1:]),
                          thr.reshape(shape + thr.shape[1:]),
                          leaf.reshape(shape + leaf.shape[1:]))
    return params, assign.reshape(shape + (m,))


def predict_forest(params: ForestParams, xq: torch.Tensor) -> torch.Tensor:
    """Per-tree predictions for query points. xq: [Q, F] -> [..., B, Q]."""
    q = xq.shape[0]
    xt = xq.t()                                                     # [F, Q]
    qs = torch.arange(q, device=xq.device)
    lead = params.feat.shape[:-2]
    pos = torch.zeros(lead + (q,), dtype=torch.int64, device=xq.device)
    for lvl in range(params.feat.shape[-2]):
        f = params.feat[..., lvl, :].to(torch.int64).gather(-1, pos)
        t = params.thr[..., lvl, :].gather(-1, pos)
        x = xt[f, qs]
        pos = 2 * pos + (x > t).to(torch.int64)
    return params.leaf.gather(-1, pos)


def _inverse(n: int) -> float:
    """``1/n`` rounded to float32.  XLA rewrites a division by a constant
    into a product with the constant's float32 reciprocal, so the
    reference's ``acc / n`` means ``acc * f32(1/n)``."""
    return float(np.float32(1.0) / np.float32(n))


def forest_mu_sigma(preds: torch.Tensor, sigma_floor, *,
                    with_parts: bool = False):
    """Ensemble mean / spread from per-tree predictions [B, ...].

    The tree axis is reduced with the reference's left-associated add
    chain, each squared deviation fenced, and the divisions by B taken as
    the reference's compiled program takes them (:func:`_inverse`); every
    float32 result is flushed to zero where subnormal, as the reference's
    backend and the CUDA kernel (built with ``-ftz=true``) compute.

    ``with_parts=True`` also returns ``(acc, inv)`` with ``mu = acc·inv``,
    for consumers into which the reference contracts that product
    (``acquisition.ei_constrained``'s ``mu_parts``)."""
    n = preds.shape[0]
    inv_n = _inverse(n)
    preds = ftz(preds)
    acc = preds[0]
    for i in range(1, n):
        acc = ftz(acc + preds[i])
    mu = ftz(acc * inv_n)

    def _sq(d):
        return ftz(_no_contract(ftz(d * d)))

    acc2 = _sq(ftz(preds[0] - mu))
    for i in range(1, n):
        acc2 = ftz(acc2 + _sq(ftz(preds[i] - mu)))
    sigma = ftz(sqrt_rn(ftz(acc2 * inv_n)))
    floor = torch.as_tensor(sigma_floor, dtype=torch.float32,
                            device=preds.device)
    sigma = torch.maximum(sigma, ftz(floor).expand_as(sigma))
    if with_parts:
        return mu, sigma, (acc, inv_n)
    return mu, sigma


def fit_predict_mu_sigma(key, y, obs_mask, points, left, thresholds,
                         sigma_floor, *, n_trees: int, depth: int):
    """Fit on (y, obs_mask) and predict mu/sigma over the whole space [M]
    through the fit's own leaf assignment."""
    params, assign = fit_forest(key, y, obs_mask, points, left, thresholds,
                                n_trees=n_trees, depth=depth)
    preds = params.leaf.gather(-1, assign)                          # [B, M]
    return forest_mu_sigma(preds, sigma_floor)
