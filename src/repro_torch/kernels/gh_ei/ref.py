"""Plain PyTorch version of the fused acquisition pass — same contract as
the CUDA kernel in ``csrc/gh_ei.cu``.

The PyTorch form of ``repro.kernels.gh_ei.ref.gh_ei_ref``: the port's
``acquisition.ei_constrained`` and ``budget_ok`` and the Gauss-Hermite
node formula, laid out as the kernel writes them (nodes [K, M]).  It
serves the CPU path and the tests; on the card it is the kernel's
yardstick (``chip_smoke.py``).
"""

from __future__ import annotations

import torch

from repro_torch.core import acquisition as acq

__all__ = ["gh_ei_ref"]


def gh_ei_ref(mu, sigma, u, y_star, t_max, beta, xi, *, conf=0.99):
    """mu/sigma/u [M]; scalars y*, t_max, beta; xi [K] -> (eic [M] f32,
    ok [M] bool, nodes [K, M] f32)."""
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=mu.device)
    mu, sigma, u = f32(mu), f32(sigma), f32(u)
    eic = acq.ei_constrained(mu, sigma, f32(y_star), u, f32(t_max))
    ok = acq.budget_ok(mu, sigma, f32(beta), conf)
    nodes = acq.gh_cost_nodes(mu, sigma, f32(xi)).t().contiguous()
    return eic, ok, nodes
