"""Dispatching entry of the fused acquisition pass."""

from __future__ import annotations

from repro_torch.core import acquisition as acq
from repro_torch.kernels.dispatch import (declare_kernel, require_no_grad,
                                         resolve_mode)
from repro_torch.kernels.gh_ei import kernel as _kernel
from repro_torch.kernels.gh_ei import ref as _ref

__all__ = ["gh_ei"]


def gh_ei(mu, sigma, u, y_star, t_max, beta, xi, *, cens=None, y_cens=None,
          conf=0.99, cens_sigma_rel=0.5, bm=512, force: str = "auto"):
    """Fused EI_c + budget filter + G-H node expansion over the space:
    (eic [M], ok [M], nodes [K, M]).

    ``cens``/``y_cens`` correct the posterior at timeout-censored
    configurations (``acquisition.censored_adjust``) in an elementwise
    pre-pass before the kernel, as the JAX op does.  The kernel for CUDA
    tensors, the plain version for CPU tensors (``kernels.dispatch``);
    ``bm`` is the TPU kernel's block, kept for its signature.
    """
    del bm
    if cens is not None:
        mu, sigma = acq.censored_adjust(mu, sigma, y_cens, cens,
                                        cens_sigma_rel)
    plain = lambda: _ref.gh_ei_ref(mu, sigma, u, y_star, t_max, beta, xi,
                                   conf=conf)
    if resolve_mode(force, mu.device, op="gh_ei") == "ref":
        return plain()
    require_no_grad("gh_ei", mu, sigma, u, y_star, t_max, beta, xi)
    out = _kernel.gh_ei_cuda(mu, sigma, u, y_star, t_max, beta, xi,
                             conf=conf)
    declare_kernel("gh_ei", out, plain)
    return out
