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
           "make_batch_selector", "space_arrays", "space_valid",
           "slot_price_rows", "selector_cache_size"]

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
    # plans its own geometry (``kernels.select_step.kernel.plan``), so the
    # value does not change what the port computes; the field keeps
    # Settings interchangeable.
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
    contracted final multiply-add; a float32 scalar on ``y``'s device, or
    one a run for a batch ``[R, M]``."""
    obs = obs_mask.to(torch.float32)
    n = torch.clamp_min(obs.sum(dim=-1), 1.0)
    mean = trees.xla_sum(y * obs) / n
    d = y - mean[..., None]
    var = trees.xla_sum((d * d) * obs) / n
    sd = acq.sqrt_rn(torch.clamp_min(var, 0.0))
    return acq.fma(acq._f32(rel), sd, acq._f32(1e-6))


def _state_keys(key, n):
    """``fold_in(key, i)`` for every state index i (padding-invariant).
    With R runs' keys ``[R, 2]`` the n states are R runs' n / R states in
    turn, and run r's state i takes ``fold_in(key_r, i)``: the keys it
    has when it is selected alone."""
    if key.dim() == 1:
        return prng.fold_in(key[None, :], torch.arange(n, device=key.device))
    r_dim = key.shape[0]
    local = torch.arange(n // r_dim, device=key.device)
    return prng.fold_in(key[:, None, :], local[None, :]).reshape(n, 2)


def _fit_root(key, y, obs_mask, cens, points, left, thresholds, floor,
              s: Settings):
    """Root ensemble fit; censored points fit at their billed lower bound,
    then the posterior is corrected there (``acq.censored_adjust``).  Also
    returns the mean's parts (``trees.forest_mu_sigma``), None once the
    censoring correction made the mean a select."""
    params, assign = trees.fit_forest(
        key, y, obs_mask, points, left, thresholds,
        n_trees=s.n_trees, depth=s.depth, node_sums="lanes")
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
        n_trees=s.n_trees, depth=s.depth, y_split=y_split,
        node_sums="lanes")
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
    the same key schedule as :func:`_fit_batch_exact`; with R runs' keys
    each run's S / R states fit as they do alone (:func:`_state_keys`,
    ``trees.fit_forest``'s ``program_states``)."""
    s_dim = y_b.shape[0]
    r_dim = 1 if key.dim() == 1 else key.shape[0]
    params, _ = trees.fit_forest(
        _state_keys(key, s_dim), y_b, m_b, points, left, thresholds,
        n_trees=s.n_trees, depth=s.depth, y_split=y_split,
        node_sums="lanes", program_states=s_dim // r_dim)
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


def _recurse(key, y_b, m_b, beta_b, bf_b, depth_left, *, points, left,
             thresholds, u, t_max, floor, s: Settings, frozen_ctx,
             cens_b=None, valid=None, y_split=None):
    """Score each state's own argmax-EI_c pick; branch if depth_left > 0.

    ``y_split`` is the y these states' split search reads (see
    :func:`_lookahead_tail`), None for ``y_b``.  ``key`` is one run's key,
    or (fused only) R runs' keys ``[R, 2]`` with ``floor [R]``, the states
    being the R runs' in turn.  Returns (reward [S], cost [S]) — zero for
    states whose Gamma is empty.
    """
    k_fit, k_next = prng.split(key).unbind(-2)
    fused = _fused_mode(s)
    _, w = acq.gauss_hermite(s.k_gh)
    xi = _gh_nodes(s.k_gh, y_b.device)
    if fused is not None:
        params = _fit_batch_params(k_fit, y_b, m_b, points, left,
                                   thresholds, s, y_split)
        floor_s = (floor if floor.dim() == 0
                   else floor.repeat_interleave(y_b.shape[0]
                                                // floor.shape[0]))
        # The kernel takes contiguous rows; the speculated states are views
        # of broadcasts.
        y_b, m_b, beta_b, bf_b = (a.contiguous()
                                  for a in (y_b, m_b, beta_b, bf_b))
        if cens_b is not None:
            cens_b = cens_b.contiguous()
        out = select_step(
            params.feat, params.thr, params.leaf, y_b, m_b, beta_b, bf_b,
            points, u, t_max, floor_s, xi, cens=cens_b, valid=valid,
            conf=s.conf, cens_rel=s.cens_sigma_rel, score_mode="eic",
            use_budget=True, emit_full=False, want_nodes=depth_left > 0,
            force=fused)
        sel, has_cand, eic_sel, mu_sel, sig_sel = out[:5]
        sel = sel.to(torch.int64)
        r0 = torch.where(has_cand, eic_sel, 0.0)
        c0 = torch.where(has_cand, mu_sel, 0.0)
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
        score = acq.quantize_scores(torch.where(cand, eic, -math.inf))
        sel = torch.argmax(score, dim=1)                         # [S]
        has_cand = cand.any(dim=1)
        take = lambda a: a.gather(1, sel[:, None])[:, 0]
        r0 = torch.where(has_cand, take(eic), 0.0)
        c0 = torch.where(has_cand, take(mu), 0.0)
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
    bf_child = torch.minimum(bf_b[:, None],
                             torch.where(feas, c_nodes, math.inf))
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
    reward = torch.where(has_cand, ftz(r0 + ftz(acq.no_contract(
        ftz(gamma * acq.gh_expect(r_ch, w))))), 0.0)
    cost = torch.where(has_cand, ftz(c0 + acq.gh_expect(c_ch, w)), 0.0)
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
    its own fusion does (ROADMAP C4).

    The root's rows may carry a leading run axis (``y [R, M]``, ``beta``
    and ``best_feas [R]``, ``c_nodes [R, M, K]``; the fused path): the
    R runs' children are then one batch, run after run, under the R keys
    of ``k_path``."""
    m_dim = y.shape[-1]
    lead = tuple(y.shape[:-1])
    k = s.k_gh
    _, w = acq.gauss_hermite(k)
    eye = torch.eye(m_dim, dtype=torch.bool, device=y.device)
    if valid is not None:
        eye = eye & valid[None, :]
    speculate = lambda nodes: torch.where(eye[:, None, :],
                                          nodes[..., :, :, None],
                                          y[..., None, None, :])
    y_means = y_nodes
    if valid is None:
        lanes = torch.arange(m_dim, device=y.device) < m_dim // 8 * 8
        y_means = torch.where(lanes[:, None], c_nodes, y_nodes)
    y1, y1_split = speculate(y_means), speculate(y_nodes)
    m1 = (obs[..., None, :] | eye)[..., :, None, :].expand(
        lead + (m_dim, k, m_dim))
    beta1 = ftz(beta[..., None, None] - c_nodes)
    feas1 = c_nodes <= ftz(t_max * u)[:, None]
    bf1 = torch.minimum(best_feas[..., None, None],
                        torch.where(feas1, c_nodes, math.inf))
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[len(lead) + 2:]))
    cens1 = None
    if cens is not None:
        cens1 = flat(cens[..., None, None, :].expand(lead + (m_dim, k,
                                                             m_dim)))
    r1, c1 = _recurse(
        k_path, flat(y1), flat(m1), flat(beta1), flat(bf1), s.la - 1,
        points=points, left=left, thresholds=thresholds, u=u, t_max=t_max,
        floor=floor, s=s, frozen_ctx=frozen_ctx, cens_b=cens1, valid=valid,
        y_split=flat(y1_split))
    gamma = acq._f32(s.gamma)
    future = ftz(acq.no_contract(
        ftz(gamma * acq.gh_expect(r1.reshape(lead + (m_dim, k)), w))))
    path = acq.gh_expect(c1.reshape(lead + (m_dim, k)), w)
    ratio = ftz(ftz(reward + future)
                / torch.clamp_min(ftz(cost + path), _EPS))
    score = acq.quantize_scores(torch.where(gamma0, ratio, -math.inf))
    ei, cp, mu_parts = root_factors
    reward = acq.fma(ei, cp, future)
    cost = (ftz(cost + path) if mu_parts is None
            else acq.fma(mu_parts[0], mu_parts[1], path))
    return torch.argmax(score, dim=-1), reward, cost


def _root_common(y, obs_mask, t_max, u, cens):
    obs = obs_mask.to(torch.bool)
    feas_obs = obs & (y <= ftz(t_max * u))
    if cens is not None:
        # An aborted run never revealed its runtime: it cannot be the
        # feasible incumbent (its billed y is only a lower bound).
        feas_obs = feas_obs & ~cens.to(torch.bool)
    best_feas = torch.where(feas_obs, y, math.inf).amin(dim=-1)
    return obs, best_feas


def _gh_nodes(k: int, device) -> torch.Tensor:
    """The Gauss-Hermite nodes as a float32 tensor on ``device``, made once
    (a selection step copies no constant to the card)."""
    key = (k, torch.device(device))
    xi = _GH_NODES.get(key)
    if xi is None:
        xi = torch.as_tensor(acq.gauss_hermite(k)[0], device=device)
        _GH_NODES[key] = xi
    return xi


_GH_NODES: dict = {}


def _select_fused_slots(keys, y, obs_mask, beta, points, left, thresholds, u,
                        t_max, s: Settings, cens, valid, mode: str):
    """The fused selection of R runs that share one job's rows (space, unit
    prices, SLO): keys [R, 2]; y, obs_mask[, cens]: [R, M]; beta: [R].

    One root forest fit over the R runs (each under its own root key), the
    root sweep as one ``select_step`` call at S = R, then one call a
    lookahead level at S = R·M·K and R·M·K²: the kernel takes each state's
    own sigma floor, and the shared rows once.  Each run's result is the
    one it gets alone (R = 1), bit for bit.  Returns ([R] indices, [R]
    valid flags, diagnostics stacked over R).
    """
    floor = _sigma_floor(y, obs_mask, s.sigma_floor_rel)          # [R]
    k_root, k_path = prng.split(keys).unbind(-2)
    params, assign = trees.fit_forest(k_root, y, obs_mask, points, left,
                                      thresholds, n_trees=s.n_trees,
                                      depth=s.depth, node_sums="lanes",
                                      program_states=1)
    obs, best_feas = _root_common(y, obs_mask, t_max, u, cens)
    score_mode, use_budget = _policy(s)
    lookahead = s.policy == "lynceus" and s.la > 0
    cens = None if cens is None else cens.to(torch.bool)
    out = select_step(
        params.feat, params.thr, params.leaf, y, obs, beta, best_feas, points,
        u, t_max, floor, _gh_nodes(s.k_gh, y.device), cens=cens, valid=valid,
        conf=s.conf, cens_rel=s.cens_sigma_rel, score_mode=score_mode,
        use_budget=use_budget, emit_full=True, want_nodes=lookahead,
        force=mode)
    mu0, sig0, eic0, ystar0, cand0 = out[:5]
    sel0, has0 = out[5].to(torch.int64), out[6]
    diagnostics = {"mu": acq.quantize_scores(mu0),
                   "sigma": acq.quantize_scores(sig0),
                   "ei_c": acq.quantize_scores(eic0),
                   "y_star": acq.quantize_scores(ystar0)}

    def finish(sel, valid_flag):
        if s.timeout:
            diagnostics["timeout"] = acq.timeout_cap(
                best_feas, sig0.gather(1, sel[:, None])[:, 0], u[sel], beta,
                t_max, s.timeout_kappa, s.timeout_tmax_mult)
        return sel, valid_flag, diagnostics

    if not lookahead:
        return finish(sel0, has0)
    # The root's EI and P(feasible) and its mean's parts, as the kernel
    # computed them, for the reward and path-cost diagnostics.
    parts = None
    if cens is None:
        preds = params.leaf.gather(2, assign).transpose(0, 1)    # [B, R, M]
        parts = trees.forest_mu_sigma(preds, floor[:, None],
                                      with_parts=True)[2]
    root_factors = acq.ei_constrained_factors(
        mu0, sig0, ystar0[:, None], u, t_max, parts) + (parts,)
    sel, reward, cost = _lookahead_tail(
        k_path, y, obs, beta, best_feas, out[7], out[8], eic0, mu0, cand0,
        root_factors, points=points, left=left, thresholds=thresholds, u=u,
        t_max=t_max, floor=floor, s=s, frozen_ctx=None, cens=cens,
        valid=valid)
    diagnostics["reward"] = acq.quantize_scores(reward)
    diagnostics["path_cost"] = acq.quantize_scores(cost)
    return finish(sel, cand0.any(dim=1))


def _select_next_fused(key, y, obs_mask, beta, points, left, thresholds, u,
                       t_max, s: Settings, cens, valid, mode: str):
    """Fused twin of :func:`_select_next_impl` (same contract): the R = 1
    case of :func:`_select_fused_slots`."""
    sel, flag, diag = _select_fused_slots(
        key[None], y[None], obs_mask[None], torch.as_tensor(beta).reshape(1),
        points, left, thresholds, u, t_max, s,
        None if cens is None else cens[None], valid, mode)
    return sel[0], flag[0], {k: v[0] for k, v in diag.items()}


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
        score = acq.quantize_scores(torch.where(untested, eic0, -math.inf))
        return finish(torch.argmax(score), untested.any())
    if s.policy == "la0" or (s.policy == "lynceus" and s.la == 0):
        ratio = ftz(eic0 / torch.clamp_min(mu0, _EPS))
        score = acq.quantize_scores(torch.where(gamma0, ratio, -math.inf))
        return finish(torch.argmax(score), gamma0.any())
    if s.policy != "lynceus":
        raise ValueError(f"unknown policy {s.policy!r}")

    xi = _gh_nodes(s.k_gh, y.device)
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
    """NextConfig for R independent slots at once (the batched harness's
    entry; the sequential oracle is its R = 1 case).

    keys: [R, 2]; y, obs_mask[, cens]: [R, M]; beta: [R].  ``u`` is [M]
    with a scalar ``t_max`` (one job for every slot) or [R, M] with
    ``t_max`` [R] (each slot its own job's prices and SLO); the space
    tensors are shared (``points [M, F]``, ``left [M, F, T]``,
    ``thresholds [F, T]``) or per slot (``[R, ...]``, geometry-bucketed
    jobs, which require ``valid``); ``valid`` is None, [M] or [R, M].

    Slots that share one job's rows are selected together
    (:func:`_select_slots`); which slots those are is read from the
    per-slot rows on the host.  A slot's result is bitwise independent of
    R and of the slots that share its launches.  Returns ([R] indices, [R]
    valid flags, diagnostics stacked over R).
    """
    t_max = torch.as_tensor(t_max, dtype=torch.float32, device=y.device)
    per_slot_u = u.dim() == 2
    if per_slot_u != (t_max.dim() == 1):
        raise ValueError("per-slot u ([R, M]) requires per-slot t_max ([R]) "
                         "and vice versa")
    per_slot_space = points.dim() == 3
    if per_slot_space and valid is None:
        raise ValueError("per-slot space tensors ([R, M, F]) come from "
                         "geometry bucketing and require a validity mask")
    per_slot_valid = valid is not None and valid.dim() == 2
    _SELECTOR_PROGRAMS.add((
        tuple(keys.shape), tuple(y.shape), tuple(points.shape),
        tuple(thresholds.shape), u.dim(), None if cens is None else "cens",
        None if valid is None else valid.dim(), s))
    rows = [a for a, per in ((u, per_slot_u), (t_max, per_slot_u),
                             (points, per_slot_space),
                             (thresholds, per_slot_space),
                             (valid, per_slot_valid)) if per]
    slots = {b"": list(range(y.shape[0]))}
    if rows:
        slots = {}
        for r, row in enumerate(zip(*(a.cpu().numpy() for a in rows))):
            slots.setdefault(b"".join(a.tobytes() for a in row),
                             []).append(r)
    groups = []
    for members in slots.values():
        r0 = members[0]
        pick = lambda a, per: a[r0] if per else a
        groups.append((members if len(slots) > 1 else None, (
            pick(points, per_slot_space), pick(left, per_slot_space),
            pick(thresholds, per_slot_space), pick(u, per_slot_u),
            pick(t_max, per_slot_u),
            None if valid is None else pick(valid, per_slot_valid))))
    return _select_slots(keys, y, obs_mask, beta, cens, groups, s)


def _device_index(index, device) -> torch.Tensor:
    """A host list of indices as an int64 tensor on ``device``, copied
    without waiting for the device."""
    return torch.as_tensor(np.asarray(index, np.int64)).to(device,
                                                           non_blocking=True)


def _select_slots(keys, y, obs_mask, beta, cens, groups, s: Settings):
    """Select R slots grouped by job: ``groups`` lists ``(slots, space)``
    with ``slots`` a host list of slot indices (None: every slot) and
    ``space = (points, left, thresholds, u [M], t_max, valid)`` the rows
    those slots share.

    Fused (``_fused_mode``): each group is one :func:`_select_fused_slots`
    call, so one root fit and one ``select_step`` launch a lookahead level
    whatever its size.  The unfused program (``fused_selector="ref"``,
    ``refit="frozen"``) selects slot by slot.  Results come back in slot
    order."""
    fused = _fused_mode(s)
    results, order = [], []
    for members, (points, left, thresholds, u, t_max, valid) in groups:
        if members is None:
            part = (keys, y, obs_mask, beta, cens)
        else:
            idx = _device_index(members, y.device)
            part = tuple(None if a is None else a.index_select(0, idx)
                         for a in (keys, y, obs_mask, beta, cens))
            order += members
        if fused is not None:
            results.append(_select_fused_slots(
                *part[:4], points, left, thresholds, u, t_max, s, part[4],
                valid, fused))
            continue
        k_g, y_g, m_g, b_g, c_g = part
        one = [_select_next_impl(k_g[r], y_g[r], m_g[r], b_g[r], points, left,
                                 thresholds, u, t_max, s,
                                 None if c_g is None else c_g[r], valid)
               for r in range(k_g.shape[0])]
        results.append((torch.stack([o[0] for o in one]),
                        torch.stack([o[1] for o in one]),
                        {k: torch.stack([o[2][k] for o in one])
                         for k in one[0][2]}))
    if len(results) == 1:
        return results[0]
    back = _device_index(np.argsort(order, kind="stable"), y.device)
    cat = lambda parts: torch.cat(parts).index_select(0, back)
    return (cat([r[0] for r in results]), cat([r[1] for r in results]),
            {k: cat([r[2][k] for r in results]) for k in results[0][2]})


def slot_price_rows(job_ids, rid, u, t_max):
    """Each lane slot's price row and SLO for slot-indexed selection.

    ``job_ids`` is None for a single-job episode: every slot shares the
    one ``u [M]`` row and scalar ``t_max`` (returned untouched).  Otherwise
    ``job_ids`` ([N] int) maps run ids to job indices and ``rid`` ([R],
    clamped non-negative) holds each slot's run id: the slots take their
    run's ``u [R, M]`` row and ``t_max [R]`` entry, and the per-slot job
    index ``jid`` rides along for the caller's table gathers.  Returns
    ``(u_slots, t_max_slots, jid_or_None)``.
    """
    if job_ids is None:
        return u, t_max, None
    jid = job_ids[rid]
    return u[jid], t_max[jid], jid


# The geometries (slots, shapes, per-slot ranks, Settings) the directly
# invoked batched selector has run: the port's counterpart of the
# reference's jit cache entries (eager PyTorch compiles nothing).
_SELECTOR_PROGRAMS: set = set()


def selector_cache_size() -> int:
    """Distinct program geometries of the directly invoked selector
    (:func:`select_next_batched`: the oracle path through
    ``make_selector``/``make_batch_selector``).  The batched harness's
    selections are counted by ``optimizer.episode_cache_size`` instead,
    as the reference inlines them into its episode programs."""
    return len(_SELECTOR_PROGRAMS)


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
