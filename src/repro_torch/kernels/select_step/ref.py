"""Plain PyTorch version of the fused selector step — same contract as the
CUDA kernel in ``csrc/select_step.cu``.

The PyTorch form of ``repro.kernels.select_step.ref.select_step_ref``:
gather-based forest descent (``trees.predict_forest``), the pinned
``forest_mu_sigma`` chain, the shared acquisition functions, and gathers at
each state's argmax pick.  It serves the CPU path and the tests, and on the
card it is the kernel's yardstick (``chip_smoke.py``) and the
``fused_selector="ref"`` path.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import trees

__all__ = ["select_step_ref"]

_EPS = acq._f32(1e-9)


def select_step_ref(feat, thr, leaf, y, obs, beta, bf, points, u, t_max,
                    floor, xi=None, cens=None, valid=None, *, conf=0.99,
                    cens_rel=0.5, score_mode="eic", use_budget=True,
                    emit_full=False, want_nodes=False):
    """Fused selector step over S speculative states.

    feat/thr: [S, B, D, W]; leaf: [S, B, L]; y/obs[/cens]: [S, M];
    beta/bf: [S]; points: [M, F]; u[/valid]: [M]; xi: [K] (required iff
    ``want_nodes``); t_max/floor: scalars.

    Returns ``emit_full=False``: (sel i32, has_cand bool, eic_sel, mu_sel,
    sig_sel[, nodes [S, K]]); ``emit_full=True``: (mu, sigma, eic [S, M],
    ystar [S], cand [S, M] bool, sel [S], has_cand [S][, nodes [S, M, K],
    nodes_y [S, M, K]]).  ``nodes_y`` are the nodes the children's
    speculated y take: the forest mean's product contracted into the
    node's addition where the mean is raw (no censoring), as the
    reference's compiled selector computes its root (ROADMAP C2).
    """
    if want_nodes and xi is None:
        raise ValueError("want_nodes=True requires xi")
    dev = y.device
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
    points, t_max, floor = f32(points), f32(t_max), f32(floor)
    obs = obs.to(torch.bool)
    preds = trees.predict_forest(
        trees.ForestParams(feat, f32(thr), f32(leaf)), points)    # [S, B, M]
    mu, sigma, parts = trees.forest_mu_sigma(preds.transpose(0, 1), floor,
                                             with_parts=True)
    if cens is not None:
        # The adjusted mean is a select, which the reference's backend
        # cannot contract into a subtraction.
        mu, sigma = acq.censored_adjust(mu, sigma, y, cens, cens_rel)
        parts = None
    ystar = acq.incumbent_fallback(bf, y, obs, sigma, valid)
    eic = acq.ei_constrained(mu, sigma, ystar[:, None], u[None, :], t_max,
                             parts)
    untested = ~obs
    if valid is not None:
        untested = untested & valid.to(torch.bool)
    cand = untested
    if use_budget:
        cand = cand & acq.budget_ok(mu, sigma, beta[:, None], conf,
                                    parts)
    if score_mode == "eic":
        raw = eic
    else:
        raw = acq.ftz(eic / torch.clamp_min(mu, _EPS))
    score = acq.quantize_scores(
        torch.where(cand, raw, torch.full_like(raw, -math.inf)))
    sel = torch.argmax(score, dim=1).to(torch.int32)
    has_cand = cand.any(dim=1)

    if emit_full:
        out = (mu, sigma, eic, ystar, cand, sel, has_cand)
        if want_nodes:
            out += (acq.gh_cost_nodes(mu, sigma, f32(xi)),
                    acq.gh_cost_nodes(mu, sigma, f32(xi), parts))
        return out
    take = lambda a: a.gather(1, sel[:, None].to(torch.int64))[:, 0]
    eic_sel, mu_sel, sig_sel = take(eic), take(mu), take(sigma)
    out = (sel, has_cand, eic_sel, mu_sel, sig_sel)
    if want_nodes:
        out += (acq.gh_cost_nodes(mu_sel, sig_sel, f32(xi)),)
    return out
