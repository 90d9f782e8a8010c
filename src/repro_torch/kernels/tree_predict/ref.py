"""Plain PyTorch version of bagged-forest inference — same contract as the
CUDA kernel in ``csrc/tree_predict.cu``.

The PyTorch form of ``repro.kernels.tree_predict.ref.tree_predict_ref``:
a gather descent per tree (node id ``clip(pos) % W``, an +inf threshold
routes left), the mean over trees and the two-pass standard deviation.
It serves the CPU path and the tests; on the card it is the kernel's
yardstick (``chip_smoke.py``).

:func:`tree_predict_held` is the CUDA kernel's order in plain PyTorch:
one prediction per (point, tree), held, then the mean and the two-pass
deviation over the held predictions in tree order.  The tests hold it to
the JAX reference; nothing on the card's path calls it.
"""

from __future__ import annotations

import torch

__all__ = ["tree_predict_held", "tree_predict_ref"]


def _predictions(x, feat, thr, leaf):
    """[B, M]: every tree's leaf value at every point."""
    n_trees, depth, width = feat.shape
    pos = torch.zeros((n_trees, x.shape[0]), dtype=torch.int64,
                      device=x.device)
    for lvl in range(depth):
        node = torch.clamp(pos, 0, width - 1) % width
        f = feat[:, lvl, :].to(torch.int64).gather(1, node)          # [B, M]
        t = thr[:, lvl, :].gather(1, node)
        v = x.t().gather(0, f)                                       # x[m, f]
        right = (v > t) & ~torch.isinf(t)
        pos = 2 * pos + right.to(torch.int64)
    return leaf.gather(1, pos)                                       # [B, M]


def tree_predict_ref(x, feat, thr, leaf, *, sigma_floor=1e-6):
    """x [M, F]; feat/thr [B, D, W]; leaf [B, 2^D] -> (mu [M], sigma [M])."""
    preds = _predictions(x, feat, thr, leaf)
    mu = preds.mean(dim=0)
    sigma = torch.clamp_min(preds.std(dim=0, correction=0), sigma_floor)
    return mu, sigma


def tree_predict_held(x, feat, thr, leaf, *, sigma_floor=1e-6):
    """The kernel's order: the held [B, M] predictions summed tree by tree
    in float32, the mean, then the squared deviations from it summed tree
    by tree (two passes: no E[p^2] - mu^2)."""
    preds = _predictions(x, feat, thr, leaf)
    n_trees = preds.shape[0]
    acc = torch.zeros_like(preds[0])
    for b in range(n_trees):
        acc = acc + preds[b]
    mean = acc / n_trees
    acc2 = torch.zeros_like(preds[0])
    for b in range(n_trees):
        d = preds[b] - mean
        acc2 = acc2 + d * d
    return mean, torch.clamp_min(torch.sqrt(acc2 / n_trees), sigma_floor)
