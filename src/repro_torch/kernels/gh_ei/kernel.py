"""Wrapper of the CUDA acquisition kernel (``csrc/gh_ei.cu``).

:func:`prepare` checks the inputs and allocates the outputs, :func:`launch`
launches once on prepared arguments, and :func:`gh_ei_cuda` does both and
counts the launch in ``gh_ei_cuda.launches`` (and nowhere else).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.acquisition import normal_quantile
from repro_torch.kernels import capi

__all__ = ["gh_ei_cuda", "launch", "prepare"]

_OP = "gh_ei"


def _fn():
    return capi.entry(_OP, "gh_ei_launch",
                      [capi.P] * 5 + [capi.F, capi.I, capi.I]
                      + [capi.P] * 4)


def prepare(mu, sigma, u, y_star, t_max, beta, xi, *, conf=0.99):
    """Returns ``(args, out, keep)``: the C entry's arguments, the outputs
    ``(eic, ok, nodes)`` and the tensors ``args`` points into.  The
    scalars may be Python numbers or float32 tensors on the card (kept
    there: no host round trip)."""
    dev = capi.require_cuda(_OP, mu)
    m_dim = mu.shape[0]
    k_gh = xi.shape[0]
    capi.check(_OP, "mu", mu, torch.float32, (m_dim,), dev)
    capi.check(_OP, "sigma", sigma, torch.float32, (m_dim,), dev)
    capi.check(_OP, "u", u, torch.float32, (m_dim,), dev)
    capi.check(_OP, "xi", xi, torch.float32, (k_gh,), dev)
    scal = torch.stack([torch.as_tensor(v, dtype=torch.float32,
                                        device=dev).reshape(())
                        for v in (y_star, t_max, beta)])
    eic = torch.empty((m_dim,), dtype=torch.float32, device=dev)
    ok = torch.empty((m_dim,), dtype=torch.bool, device=dev)
    nodes = torch.empty((k_gh, m_dim), dtype=torch.float32, device=dev)
    args = (mu.data_ptr(), sigma.data_ptr(), u.data_ptr(), scal.data_ptr(),
            xi.data_ptr(), float(np.float32(normal_quantile(float(conf)))),
            m_dim, k_gh, eic.data_ptr(), ok.data_ptr(), nodes.data_ptr(),
            capi.stream(dev))
    return args, (eic, ok, nodes), (mu, sigma, u, xi, scal)


def launch(args) -> None:
    """One launch on prepared arguments; does not count."""
    capi.raise_on_error(_OP, _fn()(*args))


def gh_ei_cuda(mu, sigma, u, y_star, t_max, beta, xi, *, conf=0.99):
    """EI_c, the budget flag and the G-H nodes on the card; the contract of
    :func:`repro_torch.kernels.gh_ei.ref.gh_ei_ref`."""
    args, out, _keep = prepare(mu, sigma, u, y_star, t_max, beta, xi,
                               conf=conf)
    launch(args)
    gh_ei_cuda.launches += 1
    return out


gh_ei_cuda.launches = 0
