"""Budget-aware, long-sighted configuration selection (paper §4, Algs. 1–2).

The PyTorch form of ``repro.core.lookahead``: ``NextConfig`` /
``ExplorePaths`` with the whole search frontier flattened into a batch
dimension —

* depth 0: one ensemble fit scores **all M roots** at once (in-breadth rule);
* depth 1: ``M x K`` speculative states (K = Gauss-Hermite nodes), one
  batched fit;
* depth 2: ``M x K x K`` states, again one batched fit.

Every state is the full space with an observation mask, so each level is a
fixed-shape batch.  On the card each level's sweep — forest descent,
censored adjustment, y*, EI_c, Gamma, quantized argmax — is one launch of
the CUDA selector-step kernel (``kernels/select_step``), fed by the batched
forest fit, which stays in PyTorch.

Refit modes: ``exact`` re-fits the bagged forest for every speculative
state (the paper); ``frozen`` freezes the root's tree structures and only
updates the leaf holding the speculated point (no fused kernel).

``Settings.fused_selector``: ``"auto"`` runs the fused step through
``kernels.select_step.ops`` — the kernel for CUDA tensors, its plain
version for CPU tensors; ``"kernel"`` demands the kernel (raises for CPU
tensors); ``"ref"`` runs the unfused plain program on either device.  All
three take the same decisions bit for bit, and the same as the JAX package.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import prng, trees
from repro_torch.core.acquisition import ftz
from repro_torch.device import resolve_device
from repro_torch.kernels.select_step.ops import select_step

__all__ = ["Settings", "select_next", "select_next_batched", "make_selector",
           "make_batch_selector", "space_arrays", "space_valid"]

_EPS = acq._f32(1e-9)


@dataclasses.dataclass(frozen=True)
class Settings:
    """Knobs of the selector (the reference's fields and defaults)."""

    policy: str = "lynceus"      # lynceus | la0 | bo | rnd (rnd handled by driver)
    la: int = 2                  # lookahead window (paper default 2)
    k_gh: int = 3                # Gauss-Hermite nodes per branch
    gamma: float = 0.9           # future-reward discount (paper §4.3)
    n_trees: int = 10            # bagging ensemble size (paper §5.2)
    depth: int = 4               # tree depth
    conf: float = 0.99           # budget-filter confidence (Alg. 1 line 23)
    refit: str = "exact"         # exact | frozen
    sigma_floor_rel: float = 0.01
    timeout: bool = False        # abort deemed-suboptimal runs, learn the bound
    timeout_kappa: float = 1.0   # posterior slack in the predictive cap
    timeout_tmax_mult: float = 3.0
    cens_sigma_rel: float = 0.5  # posterior sigma floor at censored configs
    # "auto" | "kernel" | "ref" — see the module docstring.
    fused_selector: str = "auto"
    # The reference's state-block size of its TPU grid.  The CUDA kernel
    # runs one thread block per state, so the value does not change what
    # the port computes; the field keeps Settings interchangeable.
    fused_block_states: int = 32


def _fused_mode(s: Settings) -> str | None:
    """``s.fused_selector`` as the ops ``force`` ("auto" | "kernel"), or
    None for the unfused program."""
    if s.fused_selector == "ref":
        return None
    if s.fused_selector == "auto":
        return None if s.refit == "frozen" else "auto"
    if s.fused_selector != "kernel":
        raise ValueError(f"fused_selector={s.fused_selector!r}: expected "
                         "'auto', 'kernel' or 'ref'")
    if s.refit == "frozen":
        raise ValueError("fused_selector='kernel' requires refit='exact': "
                         "the frozen incremental leaf update has no fused "
                         "kernel")
    return "kernel"


# --------------------------------------------------------------------------- #
# Model fitting helpers
# --------------------------------------------------------------------------- #
def _sigma_floor(y, obs_mask, rel):
    """``1e-6 + rel·std(observed y)`` as the reference's CPU program
    computes it: XLA-ordered float32 sums (``trees.xla_sum``) and a
    contracted final multiply-add; a float32 scalar on ``y``'s device."""
    obs = obs_mask.to(torch.float32)
    n = torch.clamp_min(obs.sum(), 1.0)
    mean = trees.xla_sum(y * obs) / n
    d = y - mean
    var = trees.xla_sum((d * d) * obs) / n
    sd = acq.sqrt_rn(torch.clamp_min(var, 0.0))
    return acq.fma(acq._f32(rel), sd, acq._f32(1e-6))


def _state_keys(key, n):
    """``fold_in(key, i)`` for every state index i (padding-invariant)."""
    return prng.fold_in(key[None, :], torch.arange(n, device=key.device))


def _fit_root(key, y, obs_mask, cens, points, left, thresholds, floor,
              s: Settings):
    """Root ensemble fit; censored points fit at their billed lower bound,
    then the posterior is corrected there (``acq.censored_adjust``).  Also
    returns the mean's parts (``trees.forest_mu_sigma``), None once the
    censoring correction made the mean a select."""
    params, assign = trees.fit_forest(
        key, y, obs_mask, points, left, thresholds,
        n_trees=s.n_trees, depth=s.depth)
    preds = params.leaf.gather(1, assign)                       # [B, M]
    mu, sigma, parts = trees.forest_mu_sigma(preds, floor, with_parts=True)
    if cens is not None:
        mu, sigma = acq.censored_adjust(mu, sigma, y, cens, s.cens_sigma_rel)
        parts = None
    return params, assign, preds, mu, sigma, parts


def _fit_batch_exact(key, y_b, m_b, cens_b, points, left, thresholds, floor,
                     s: Settings, y_split=None):
    """y_b, m_b[, cens_b]: [S, M] -> mu, sigma: [S, M] and the mean's parts
    (as :func:`_fit_root`); state i fits under ``fold_in(key, i)``.
    ``y_split``: the y the split search reads (``trees.fit_forest``)."""
    params, assign = trees.fit_forest(
        _state_keys(key, y_b.shape[0]), y_b, m_b, points, left, thresholds,
        n_trees=s.n_trees, depth=s.depth, y_split=y_split)
    preds = params.leaf.gather(2, assign)                       # [S, B, M]
    mu, sigma, parts = trees.forest_mu_sigma(preds.transpose(0, 1), floor,
                                             with_parts=True)
    if cens_b is not None:
        mu, sigma = acq.censored_adjust(mu, sigma, y_b, cens_b,
                                        s.cens_sigma_rel)
        parts = None
    return mu, sigma, parts


def _fit_batch_params(key, y_b, m_b, points, left, thresholds, s: Settings,
                      y_split=None):
    """Per-state forest parameters [S, B, D, W] for the fused step, under
    the same key schedule as :func:`_fit_batch_exact`."""
    params, _ = trees.fit_forest(
        _state_keys(key, y_b.shape[0]), y_b, m_b, points, left, thresholds,
        n_trees=s.n_trees, depth=s.depth, y_split=y_split)
    return params


def _seq_sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over dim 0 as XLA's CPU program takes it for <= 32 terms: left
    to right.  A mean is this sum times ``trees._inverse`` of the count."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = ftz(acc + x[i])
    return acc


def _fit_batch_frozen(root_assign, root_preds, boot_w, sel_b, c_b, floor):
    """Frozen-structure incremental refit: adding (x_sel, c) with unit
    weight only changes the leaf holding x_sel, to ``(sw·old + c)/(sw+1)``.
    Tree-axis means run in XLA's order for a reduce over <= 32 terms (left
    to right); the multiply-add is contracted, as the reference's backend
    compiles it."""
    same_leaf = root_assign[:, :, None] == root_assign[:, sel_b][:, None, :]
    sw = (boot_w[:, :, None] * same_leaf.to(torch.float32)).sum(dim=1)
    old = root_preds.gather(1, sel_b[None, :].expand(root_preds.shape[0], -1))
    new_leaf = ftz(acq.fma(sw, old, c_b[None, :]) / (sw + 1.0))
    delta = ftz(new_leaf - old)
    preds = ftz(root_preds[:, None, :]
                + delta[:, :, None] * same_leaf.transpose(1, 2))
    inv = trees._inverse(preds.shape[0])
    acc = _seq_sum0(preds)
    mu = ftz(acc * inv)
    d = ftz(preds - mu[None])
    var = ftz(_seq_sum0(ftz(d * d)) * inv)
    sigma = acq.sqrt_rn(var)
    return mu, torch.maximum(sigma, floor.expand_as(sigma)), (acc, inv)


# --------------------------------------------------------------------------- #
# The selector
# --------------------------------------------------------------------------- #
def _at(a, i):
    """``a[i]`` for a 0-d index tensor ``i``, without reading ``i`` on the
    host (``a[i]`` would: a device-host sync on the card)."""
    return a[i.reshape(1)][0]


def _where(c, a, b):
    return torch.where(c, a, torch.as_tensor(b, dtype=a.dtype,
                                             device=a.device))


def _recurse(key, y_b, m_b, beta_b, bf_b, depth_left, *, points, left,
             thresholds, u, t_max, floor, s: Settings, frozen_ctx,
             cens_b=None, valid=None, y_split=None):
    """Score each state's own argmax-EI_c pick; branch if depth_left > 0.

    ``y_split`` is the y these states' split search reads (see
    :func:`_lookahead_tail`), None for ``y_b``.  Returns (reward [S], cost
    [S]) — zero for states whose Gamma is empty.
    """
    k_fit, k_next = prng.split(key)
    fused = _fused_mode(s)
    xi_np, w = acq.gauss_hermite(s.k_gh)
    xi = torch.as_tensor(xi_np, device=y_b.device)
    if fused is not None:
        params = _fit_batch_params(k_fit, y_b, m_b, points, left,
                                   thresholds, s, y_split)
        # The kernel takes contiguous rows; the speculated states are views
        # of broadcasts.
        y_b, m_b, beta_b, bf_b = (a.contiguous()
                                  for a in (y_b, m_b, beta_b, bf_b))
        if cens_b is not None:
            cens_b = cens_b.contiguous()
        out = select_step(
            params.feat, params.thr, params.leaf, y_b, m_b, beta_b, bf_b,
            points, u, t_max, floor, xi, cens=cens_b, valid=valid,
            conf=s.conf, cens_rel=s.cens_sigma_rel, score_mode="eic",
            use_budget=True, emit_full=False, want_nodes=depth_left > 0,
            force=fused)
        sel, has_cand, eic_sel, mu_sel, sig_sel = out[:5]
        sel = sel.to(torch.int64)
        r0 = _where(has_cand, eic_sel, 0.0)
        c0 = _where(has_cand, mu_sel, 0.0)
        if depth_left == 0:
            return r0, c0
        c_nodes = out[5]                                         # [S, K]
    else:
        if s.refit == "frozen" and frozen_ctx is not None:
            mu, sigma, parts = _fit_batch_frozen(*frozen_ctx, floor)
            if cens_b is not None:
                mu, sigma = acq.censored_adjust(mu, sigma, y_b, cens_b,
                                                s.cens_sigma_rel)
                parts = None
        else:
            mu, sigma, parts = _fit_batch_exact(k_fit, y_b, m_b, cens_b,
                                                points, left, thresholds,
                                                floor, s, y_split)
        ystar = acq.incumbent_fallback(bf_b, y_b, m_b, sigma, valid)
        eic = acq.ei_constrained(mu, sigma, ystar[:, None], u[None, :],
                                 t_max, parts)
        untested = ~m_b.to(torch.bool)
        if valid is not None:
            untested = untested & valid[None, :]
        cand = untested & acq.budget_ok(mu, sigma, beta_b[:, None], s.conf,
                                        parts)
        score = acq.quantize_scores(_where(cand, eic, -math.inf))
        sel = torch.argmax(score, dim=1)                         # [S]
        has_cand = cand.any(dim=1)
        take = lambda a: a.gather(1, sel[:, None])[:, 0]
        r0 = _where(has_cand, take(eic), 0.0)
        c0 = _where(has_cand, take(mu), 0.0)
        if depth_left == 0:
            return r0, c0
        c_nodes = acq.gh_cost_nodes(take(mu), take(sigma), xi)   # [S, K]

    # Branch: Gauss-Hermite speculation on the selected config's cost.
    s_dim, m_dim = y_b.shape
    k = s.k_gh
    sel_oh = sel[:, None] == torch.arange(m_dim, device=y_b.device)
    speculate = lambda y_: torch.where(sel_oh[:, None, :],
                                       c_nodes[:, :, None], y_[:, None, :])
    y_child = speculate(y_b)                                     # [S, K, M]
    m_child = (m_b.to(torch.bool) | sel_oh)[:, None, :].expand(s_dim, k,
                                                               m_dim)
    beta_child = ftz(beta_b[:, None] - c_nodes)
    feas = c_nodes <= ftz(t_max * u[sel])[:, None]
    bf_child = torch.minimum(bf_b[:, None], _where(feas, c_nodes, math.inf))
    flat = lambda a: a.reshape((s_dim * k,) + tuple(a.shape[2:]))
    child_frozen = None
    if s.refit == "frozen" and frozen_ctx is not None:
        ra, rp, bw, _, _ = frozen_ctx
        child_frozen = (ra, rp, bw, flat(sel[:, None].expand(s_dim, k)),
                        flat(c_nodes))
    cens_child = None
    if cens_b is not None:
        cens_child = flat(cens_b[:, None, :].expand(s_dim, k, m_dim))
    r_ch, c_ch = _recurse(
        k_next, flat(y_child), flat(m_child), flat(beta_child),
        flat(bf_child), depth_left - 1, points=points, left=left,
        thresholds=thresholds, u=u, t_max=t_max, floor=floor, s=s,
        frozen_ctx=child_frozen, cens_b=cens_child, valid=valid,
        y_split=None if y_split is None else flat(speculate(y_split)))
    r_ch = r_ch.reshape(s_dim, k)
    c_ch = c_ch.reshape(s_dim, k)
    gamma = acq._f32(s.gamma)
    reward = _where(has_cand, ftz(r0 + ftz(acq.no_contract(
        ftz(gamma * acq.gh_expect(r_ch, w))))), 0.0)
    cost = _where(has_cand, ftz(c0 + acq.gh_expect(c_ch, w)), 0.0)
    return reward, cost


def _policy(s: Settings):
    if s.policy == "bo":
        return "eic", False
    if s.policy == "la0" or (s.policy == "lynceus" and s.la == 0):
        return "ratio", True
    if s.policy == "lynceus":
        return "eic", True
    raise ValueError(f"unknown policy {s.policy!r}")


def _lookahead_tail(k_path, y, obs, beta, best_feas, c_nodes, y_nodes,
                    reward, cost, gamma0, root_factors, *, points, left,
                    thresholds, u, t_max, floor, s: Settings, frozen_ctx,
                    cens, valid):
    """Speculate every root's G-H nodes, recurse, and return the pick and
    the root reward/path-cost diagnostics (shared by the fused and unfused
    roots).

    ``y_nodes`` are the root's nodes with the forest mean's product
    contracted into the addition (``gh_cost_nodes``' ``mu_parts``),
    ``c_nodes`` the same nodes uncontracted; the children's budget and
    incumbent take ``c_nodes``.  Their speculated y is copied into each
    fusion of the reference's program that reads it, and each rounds it
    its own way (ROADMAP C2, C4, C5; read from the compiled programs):
    the split search's node sums take ``y_nodes`` for every root; the leaf
    means of a native program take ``c_nodes`` for the roots its CPU
    backend runs in 8-wide vector lanes (the first ``M // 8 * 8``) and
    ``y_nodes`` for the scalar tail, those of a padded program
    ``y_nodes``.

    ``root_factors = (ei, cp, mu_parts)``: the root's EI and P(feasible),
    whose product is ``reward``, and the parts of ``cost`` (None when a
    censoring mask made it a select).  The reference computes each
    diagnostic in a fusion of its own, which contracts ``ei·cp`` into the
    reward's addition and the forest mean's product into the path cost's,
    in every program shape (native or padded, la 1 or 2: read from the
    compiled programs).  The pick's ratio takes the sums uncontracted, as
    its own fusion does (ROADMAP C4)."""
    m_dim = y.shape[0]
    k = s.k_gh
    _, w = acq.gauss_hermite(k)
    eye = torch.eye(m_dim, dtype=torch.bool, device=y.device)
    if valid is not None:
        eye = eye & valid[None, :]
    speculate = lambda nodes: torch.where(eye[:, None, :], nodes[:, :, None],
                                          y[None, None, :])
    y_means = y_nodes
    if valid is None:
        lanes = torch.arange(m_dim, device=y.device) < m_dim // 8 * 8
        y_means = torch.where(lanes[:, None], c_nodes, y_nodes)
    y1, y1_split = speculate(y_means), speculate(y_nodes)
    m1 = (obs[None, :] | eye)[:, None, :].expand(m_dim, k, m_dim)
    beta1 = ftz(beta - c_nodes)
    feas1 = c_nodes <= ftz(t_max * u)[:, None]
    bf1 = torch.minimum(best_feas, _where(feas1, c_nodes, math.inf))
    flat = lambda a: a.reshape((m_dim * k,) + tuple(a.shape[2:]))
    cens1 = None
    if cens is not None:
        cens1 = flat(cens[None, None, :].expand(m_dim, k, m_dim))
    r1, c1 = _recurse(
        k_path, flat(y1), flat(m1), flat(beta1), flat(bf1), s.la - 1,
        points=points, left=left, thresholds=thresholds, u=u, t_max=t_max,
        floor=floor, s=s, frozen_ctx=frozen_ctx, cens_b=cens1, valid=valid,
        y_split=flat(y1_split))
    gamma = acq._f32(s.gamma)
    future = ftz(acq.no_contract(
        ftz(gamma * acq.gh_expect(r1.reshape(m_dim, k), w))))
    path = acq.gh_expect(c1.reshape(m_dim, k), w)
    ratio = ftz(ftz(reward + future)
                / torch.clamp_min(ftz(cost + path), _EPS))
    score = acq.quantize_scores(_where(gamma0, ratio, -math.inf))
    ei, cp, mu_parts = root_factors
    reward = acq.fma(ei, cp, future)
    cost = (ftz(cost + path) if mu_parts is None
            else acq.fma(mu_parts[0], mu_parts[1], path))
    return torch.argmax(score), reward, cost


def _root_common(y, obs_mask, t_max, u, cens):
    obs = obs_mask.to(torch.bool)
    feas_obs = obs & (y <= ftz(t_max * u))
    if cens is not None:
        # An aborted run never revealed its runtime: it cannot be the
        # feasible incumbent (its billed y is only a lower bound).
        feas_obs = feas_obs & ~cens.to(torch.bool)
    best_feas = _where(feas_obs, y, math.inf).amin()
    return obs, best_feas


def _select_next_fused(key, y, obs_mask, beta, points, left, thresholds, u,
                       t_max, s: Settings, cens, valid, mode: str):
    """Fused-root twin of :func:`_select_next_impl` (same contract): the
    root sweep is one ``select_step`` call with ``emit_full=True``."""
    floor = _sigma_floor(y, obs_mask, s.sigma_floor_rel)
    k_root, k_path = prng.split(key)
    params, assign = trees.fit_forest(k_root, y, obs_mask, points, left,
                                      thresholds, n_trees=s.n_trees,
                                      depth=s.depth)
    obs, best_feas = _root_common(y, obs_mask, t_max, u, cens)
    score_mode, use_budget = _policy(s)
    lookahead = s.policy == "lynceus" and s.la > 0
    xi = torch.as_tensor(acq.gauss_hermite(s.k_gh)[0], device=y.device)
    out = select_step(
        params.feat[None], params.thr[None], params.leaf[None], y[None],
        obs[None], beta.reshape(1), best_feas.reshape(1), points, u, t_max,
        floor, xi, cens=None if cens is None else cens.to(torch.bool)[None],
        valid=valid, conf=s.conf, cens_rel=s.cens_sigma_rel,
        score_mode=score_mode, use_budget=use_budget, emit_full=True,
        want_nodes=lookahead, force=mode)
    mu0, sig0, eic0 = out[0][0], out[1][0], out[2][0]
    ystar0, cand0 = out[3][0], out[4][0]
    sel0, has0 = out[5][0].to(torch.int64), out[6][0]
    diagnostics = {"mu": acq.quantize_scores(mu0),
                   "sigma": acq.quantize_scores(sig0),
                   "ei_c": acq.quantize_scores(eic0),
                   "y_star": acq.quantize_scores(ystar0)}

    def finish(sel, valid_flag):
        if s.timeout:
            diagnostics["timeout"] = acq.timeout_cap(
                best_feas, _at(sig0, sel), _at(u, sel), beta, t_max,
                s.timeout_kappa, s.timeout_tmax_mult)
        return sel, valid_flag, diagnostics

    if not lookahead:
        return finish(sel0, has0)
    # The root's EI and P(feasible) and its mean's parts, as the kernel
    # computed them, for the reward and path-cost diagnostics.
    parts = None
    if cens is None:
        parts = trees.forest_mu_sigma(params.leaf.gather(1, assign), floor,
                                      with_parts=True)[2]
    root_factors = acq.ei_constrained_factors(mu0, sig0, ystar0, u, t_max,
                                              parts) + (parts,)
    sel, reward, cost = _lookahead_tail(
        k_path, y, obs, beta, best_feas, out[7][0], out[8][0], eic0, mu0,
        cand0, root_factors,
        points=points, left=left, thresholds=thresholds, u=u, t_max=t_max,
        floor=floor, s=s, frozen_ctx=None, cens=None if cens is None
        else cens.to(torch.bool), valid=valid)
    diagnostics["reward"] = acq.quantize_scores(reward)
    diagnostics["path_cost"] = acq.quantize_scores(cost)
    return finish(sel, cand0.any())


def _select_next_impl(key, y, obs_mask, beta, points, left, thresholds, u,
                      t_max, s: Settings, cens=None, valid=None):
    """One NextConfig step. Returns (index, valid, diagnostics).

    y: [M] observed costs; obs_mask: [M]; beta: scalar remaining budget;
    u: [M] unit prices; cens: [M] censoring mask (only with ``s.timeout``);
    valid: [M] point-validity mask of a padded space, or None.  With
    ``s.timeout`` the diagnostics carry ``"timeout"``, the predictive cap τ.
    """
    fused = _fused_mode(s)
    if fused is not None:
        return _select_next_fused(key, y, obs_mask, beta, points, left,
                                  thresholds, u, t_max, s, cens, valid,
                                  fused)
    m_dim = y.shape[0]
    floor = _sigma_floor(y, obs_mask, s.sigma_floor_rel)
    k_root, k_path = prng.split(key)
    params, assign, preds, mu0, sig0, parts = _fit_root(
        k_root, y, obs_mask, cens, points, left, thresholds, floor, s)
    obs, best_feas = _root_common(y, obs_mask, t_max, u, cens)
    ystar0 = acq.incumbent_fallback(best_feas, y, obs, sig0, valid)
    ei0, cp0 = acq.ei_constrained_factors(mu0, sig0, ystar0, u, t_max, parts)
    eic0 = ftz(ei0 * cp0)
    untested = ~obs if valid is None else ~obs & valid
    gamma0 = untested & acq.budget_ok(mu0, sig0, beta, s.conf, parts)
    diagnostics = {"mu": acq.quantize_scores(mu0),
                   "sigma": acq.quantize_scores(sig0),
                   "ei_c": acq.quantize_scores(eic0),
                   "y_star": acq.quantize_scores(ystar0)}

    def finish(sel, valid_flag):
        if s.timeout:
            diagnostics["timeout"] = acq.timeout_cap(
                best_feas, _at(sig0, sel), _at(u, sel), beta, t_max,
                s.timeout_kappa, s.timeout_tmax_mult)
        return sel, valid_flag, diagnostics

    if s.policy == "bo":
        score = acq.quantize_scores(_where(untested, eic0, -math.inf))
        return finish(torch.argmax(score), untested.any())
    if s.policy == "la0" or (s.policy == "lynceus" and s.la == 0):
        ratio = ftz(eic0 / torch.clamp_min(mu0, _EPS))
        score = acq.quantize_scores(_where(gamma0, ratio, -math.inf))
        return finish(torch.argmax(score), gamma0.any())
    if s.policy != "lynceus":
        raise ValueError(f"unknown policy {s.policy!r}")

    xi = torch.as_tensor(acq.gauss_hermite(s.k_gh)[0], device=y.device)
    c_nodes = acq.gh_cost_nodes(mu0, sig0, xi)                    # [M, K]
    y_nodes = acq.gh_cost_nodes(mu0, sig0, xi, parts)
    frozen_ctx = None
    if s.refit == "frozen":
        # Leaf weights approximated as uniform over the valid points.
        boot_w = (torch.ones_like(preds) if valid is None
                  else valid.to(preds.dtype)[None, :].expand_as(preds))
        roots = torch.arange(m_dim, device=y.device)
        frozen_ctx = (assign, preds, boot_w,
                      roots[:, None].expand(m_dim, s.k_gh).reshape(-1),
                      y_nodes.reshape(-1))
    sel, reward, cost = _lookahead_tail(
        k_path, y, obs, beta, best_feas, c_nodes, y_nodes, eic0, mu0, gamma0,
        (ei0, cp0, parts), points=points, left=left, thresholds=thresholds,
        u=u, t_max=t_max, floor=floor, s=s, frozen_ctx=frozen_ctx,
        cens=None if cens is None else cens.to(torch.bool), valid=valid)
    diagnostics["reward"] = acq.quantize_scores(reward)
    diagnostics["path_cost"] = acq.quantize_scores(cost)
    return finish(sel, gamma0.any())


select_next = _select_next_impl


def select_next_batched(keys, y, obs_mask, beta, points, left, thresholds, u,
                        t_max, s: Settings, cens=None, valid=None):
    """NextConfig for R slots that share one space and job.

    keys: [R, 2]; y, obs_mask[, cens]: [R, M]; beta: [R]; points [M, F];
    u[, valid]: [M]; t_max: scalar.  Each slot is selected on its own, so a
    slot's result never depends on R.  Returns ([R] indices, [R] valid
    flags, diagnostics stacked over R).
    """
    picks, flags, diags = [], [], []
    for r in range(keys.shape[0]):
        i, v, d = _select_next_impl(
            keys[r], y[r], obs_mask[r], beta[r], points, left, thresholds,
            u, t_max, s, None if cens is None else cens[r], valid)
        picks.append(i)
        flags.append(v)
        diags.append(d)
    return (torch.stack(picks), torch.stack(flags),
            {k: torch.stack([d[k] for d in diags]) for k in diags[0]})


def space_arrays(space, unit_price: np.ndarray, device="cuda"):
    """Space tensors on ``device`` shared by every selector of a space.

    Accepts a native ``DiscreteSpace`` or a ``PaddedSpace``: for the latter
    a native-width ``unit_price`` row is right-padded with 1.0 (inert).
    """
    device = torch.device(device)
    points = torch.as_tensor(np.asarray(space.points, np.float32),
                             device=device)
    thresholds = torch.as_tensor(np.asarray(space.thresholds, np.float32),
                                 device=device)
    left = trees.make_left_table(space.points, space.thresholds,
                                 device=device)
    u = np.asarray(unit_price, dtype=np.float32)
    native = getattr(space, "native", None)
    if native is not None and u.shape[0] != space.n_points:
        if u.shape[0] != native.n_points:
            raise ValueError(
                f"unit_price has {u.shape[0]} rows; expected the native "
                f"width {native.n_points} or the bucket width "
                f"{space.n_points}")
        u = np.pad(u, (0, space.n_points - u.shape[0]),
                   constant_values=np.float32(1.0))
    return points, left, thresholds, torch.as_tensor(u, device=device)


def space_valid(space, device="cuda"):
    """The point-validity mask of ``space`` on ``device``, or None for a
    native (unpadded) space — the selector's ``valid`` argument."""
    valid = getattr(space, "valid", None)
    return None if valid is None else torch.as_tensor(valid,
                                                      device=device)


def make_batch_selector(space, unit_price: np.ndarray, t_max: float,
                        s: Settings, device="cuda"):
    """Bind a space to the selector on ``device``; returns f(keys, y, mask,
    beta[, cens]) over [R, ...] lane-stacked state."""
    device = resolve_device(device)
    _fused_mode(s)
    points, left, thresholds, u = space_arrays(space, unit_price, device)
    valid = space_valid(space, device)
    t = torch.tensor(float(np.float32(t_max)), dtype=torch.float32,
                     device=device)

    def run(keys, y, obs_mask, beta, cens=None):
        as_t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt,
                                             device=device)
        return select_next_batched(
            torch.as_tensor(keys, dtype=torch.int64, device=device),
            as_t(y, torch.float32), as_t(obs_mask, torch.bool),
            as_t(beta, torch.float32), points, left, thresholds, u, t, s,
            None if cens is None else as_t(cens, torch.bool), valid)

    return run


def make_selector(space, unit_price: np.ndarray, t_max: float, s: Settings,
                  device="cuda"):
    """Bind a space to the selector; returns f(key, y, mask, beta[, cens])
    for one run (the R = 1 case of :func:`make_batch_selector`)."""
    batch = make_batch_selector(space, unit_price, t_max, s, device)

    def run(key, y, obs_mask, beta, cens=None):
        idx, valid, diag = batch(
            torch.as_tensor(key)[None], np.asarray(y, np.float32)[None],
            np.asarray(obs_mask)[None], np.asarray(beta, np.float32)[None],
            None if cens is None else np.asarray(cens)[None])
        return idx[0], valid[0], {k: v[0] for k, v in diag.items()}

    return run
