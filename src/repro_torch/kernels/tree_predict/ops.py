"""Dispatching entry of forest mu/sigma prediction."""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import (declare_kernel, require_no_grad,
                                         resolve_mode)
from repro_torch.kernels.tree_predict import kernel as _kernel
from repro_torch.kernels.tree_predict import ref as _ref

__all__ = ["tree_predict"]


def tree_predict(x, feat, thr, leaf, *, sigma_floor=1e-6, bm=256,
                 force: str = "auto"):
    """x [M, F]; feat/thr [B, D, W]; leaf [B, 2^D] -> (mu [M], sigma [M]).

    The kernel for CUDA tensors, the plain version for CPU tensors (see
    ``kernels.dispatch``).  ``bm`` is the TPU kernel's point block, kept
    for its signature; the CUDA kernel picks its own blocks.
    """
    del bm
    x = x.to(torch.float32).contiguous()
    plain = lambda: _ref.tree_predict_ref(x, feat, thr, leaf,
                                          sigma_floor=sigma_floor)
    if resolve_mode(force, x.device, op="tree_predict") == "ref":
        return plain()
    require_no_grad("tree_predict", x, feat, thr, leaf)
    out = _kernel.tree_predict_cuda(x, feat, thr, leaf,
                                    sigma_floor=sigma_floor)
    declare_kernel("tree_predict", out, plain)
    return out
