"""Plain PyTorch version of bagged-forest inference — same contract as the
CUDA kernel in ``csrc/tree_predict.cu``.

The PyTorch form of ``repro.kernels.tree_predict.ref.tree_predict_ref``:
a gather descent per tree (node id ``clip(pos) % W``, an +inf threshold
routes left), the mean over trees and the two-pass standard deviation.
It serves the CPU path and the tests; on the card it is the kernel's
yardstick (``chip_smoke.py``).
"""

from __future__ import annotations

import torch

__all__ = ["tree_predict_ref"]


def tree_predict_ref(x, feat, thr, leaf, *, sigma_floor=1e-6):
    """x [M, F]; feat/thr [B, D, W]; leaf [B, 2^D] -> (mu [M], sigma [M])."""
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
    preds = leaf.gather(1, pos)                                      # [B, M]
    mu = preds.mean(dim=0)
    sigma = torch.clamp_min(preds.std(dim=0, correction=0), sigma_floor)
    return mu, sigma
