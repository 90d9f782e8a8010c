"""Dispatching entry of the fused selector step."""

from __future__ import annotations

from repro_torch.kernels.dispatch import (declare_kernel, require_no_grad,
                                         resolve_mode)
from repro_torch.kernels.select_step import kernel as _kernel
from repro_torch.kernels.select_step import ref as _ref

__all__ = ["select_step"]


def select_step(feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor,
                xi=None, cens=None, valid=None, *, conf=0.99, cens_rel=0.5,
                score_mode="eic", use_budget=True, emit_full=False,
                want_nodes=False, force: str = "auto"):
    """The kernel for CUDA tensors, the plain version for CPU tensors (see
    ``kernels.dispatch``); ``force="ref"`` takes the plain version on
    either device.  Contract: ``ref.select_step_ref``."""
    kw = dict(conf=conf, cens_rel=cens_rel, score_mode=score_mode,
              use_budget=use_budget, emit_full=emit_full,
              want_nodes=want_nodes)
    args = (feat, thr, leaf, y, obs, beta, bf, points, u, t_max, floor, xi)
    plain = lambda: _ref.select_step_ref(*args, cens=cens, valid=valid, **kw)
    if resolve_mode(force, y.device, op="select_step") == "ref":
        return plain()
    require_no_grad("select_step", *args, cens, valid)
    out = _kernel.select_step_cuda(*args, cens=cens, valid=valid, **kw)
    declare_kernel("select_step", out, plain)
    return out
