"""Paper §4.4 extensions: multiple constraints and setup costs.

The PyTorch form of ``repro.core.extensions``, decision for decision.  The
paper describes these extensions but does not evaluate them.

Multiple constraints
--------------------
``EI_c(x) = EI(x) · Π_i P(m_i(x) <= t_i)`` with one independently-fit forest
per constraint metric.  The exploration-path speculation keeps branching on
*cost* only (K nodes); speculating the full ``K^(I+1)`` Cartesian product
(paper's sketch) is exposed via ``cartesian_gh`` for I as small as the
example uses, with weight-product pruning of negligible branches.

Setup costs
-----------
``setup_cost(χ, x)`` is added to the spend of every (simulated or real) run,
making path order matter: Lynceus will prefer paths that re-use the deployed
cluster.  The default model charges a per-VM boot fee when the VM type
changes and a delta fee when only the count grows (paper's example).

How the reference computes, and so how the port does:

* the forest fits and the acquisition run on ``device`` (the card by
  default): each fit is the reference's standalone jitted fit
  (``trees.fit_predict_mu_sigma``, point-order node sums), and the
  acquisition is called op by op, as the reference calls it eagerly, so no
  product is contracted (no ``mu_parts``);
* the loop's bookkeeping stays on the host in numpy, on the dtypes the
  reference uses: the job tables in float64 (``job.cost``, not the float32
  ``host_view``), ``y`` and the acquisition terms in float32, the budget in
  Python floats.  Every Python scalar that enters the acquisition is
  rounded to float32 once, as JAX's weak typing rounds it.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import TYPE_CHECKING, Callable, Sequence

import numpy as np
import torch

from repro_torch.core import acquisition as acq
from repro_torch.core import prng, trees
from repro_torch.core.space import DiscreteSpace, latin_hypercube_indices
from repro_torch.device import resolve_device

if TYPE_CHECKING:  # avoid the core <-> jobs import cycle at runtime
    from repro_torch.jobs.tables import JobTable

__all__ = [
    "ConstrainedJob", "multi_constraint_probs", "cartesian_gh",
    "default_setup_cost", "optimize_with_setup_costs",
    "optimize_multi_constraint",
]


def _scalar(v, device) -> torch.Tensor:
    """A host number as the float32 scalar JAX makes of it."""
    return torch.tensor(np.float32(v), device=device)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class _Space:
    """A space's fit inputs on one device."""

    def __init__(self, space: DiscreteSpace, device):
        self.left = trees.make_left_table(space.points, space.thresholds,
                                          device)
        self.thr = torch.as_tensor(space.thresholds, device=device)
        self.device = device

    def fit(self, key, y, mask, floor, n_trees, depth):
        dev = self.device
        return trees.fit_predict_mu_sigma(
            key.to(dev), torch.as_tensor(np.asarray(y, np.float32),
                                         device=dev),
            torch.as_tensor(np.asarray(mask), device=dev), None, self.left,
            self.thr, np.float32(floor), n_trees=n_trees, depth=depth)


# --------------------------------------------------------------------------- #
# Multiple constraints
# --------------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ConstrainedJob:
    """A job table plus extra constraint metrics ``m_i(x) <= t_i``."""

    job: JobTable
    metrics: dict[str, np.ndarray]      # name -> [M] measured metric values
    thresholds: dict[str, float]        # name -> t_i

    @property
    def feasible(self) -> np.ndarray:
        ok = self.job.feasible.copy()
        for name, vals in self.metrics.items():
            ok &= vals <= self.thresholds[name]
        return ok

    @property
    def optimum_index(self) -> int:
        c = np.where(self.feasible, self.job.cost, np.inf)
        if not np.isfinite(c).any():
            raise ValueError("no feasible config under joint constraints")
        return int(c.argmin())

    def cno(self, index: int) -> float:
        return float(self.job.cost[index] / self.job.cost[self.optimum_index])


def _constraint_probs(key, metric_obs, mask, thresholds_t, sp: _Space, *,
                      n_trees: int, depth: int) -> torch.Tensor:
    prob = torch.ones(sp.left.shape[0], device=sp.device)
    for i, (obs, t_i) in enumerate(zip(metric_obs, thresholds_t)):
        k = prng.fold_in(key, i)
        floor = 1e-6 + 0.01 * float(
            np.std(np.asarray(obs)[np.asarray(mask)]) or 1.0)
        mu, sigma = sp.fit(k, obs, mask, floor, n_trees, depth)
        prob = acq.ftz(prob * acq.prob_leq(mu, sigma,
                                           _scalar(t_i, sp.device)))
    return prob


def multi_constraint_probs(key, metric_obs: Sequence[np.ndarray], mask,
                           thresholds_t: Sequence[float], space: DiscreteSpace,
                           *, n_trees: int = 10, depth: int = 4,
                           device="cuda") -> torch.Tensor:
    """Π_i P(m_i <= t_i) over the whole space, one forest per metric,
    computed on ``device`` (``"cuda"`` by default; raises without a card)."""
    sp = _Space(space, resolve_device(device))
    return _constraint_probs(key, metric_obs, mask, thresholds_t, sp,
                             n_trees=n_trees, depth=depth)


def cartesian_gh(mus: Sequence[float], sigmas: Sequence[float], k: int,
                 prune: float = 1e-3) -> tuple[np.ndarray, np.ndarray]:
    """K^(I+1) Gauss-Hermite product expansion with weight pruning.

    Returns (values [P, I+1], weights [P]) where branches whose joint weight
    is below ``prune`` (relative) are dropped and the rest renormalized —
    the paper's 'numerical methods can prune unnecessary pairs'.  Host
    numpy, as in the reference.
    """
    xi, w = acq.gauss_hermite(k)
    vals, wts = [], []
    for combo in itertools.product(range(k), repeat=len(mus)):
        weight = float(np.prod([w[c] for c in combo]))
        vals.append([m + np.sqrt(2.0) * s * xi[c]
                     for m, s, c in zip(mus, sigmas, combo)])
        wts.append(weight)
    vals = np.asarray(vals)
    wts = np.asarray(wts)
    keep = wts >= prune * wts.max()
    vals, wts = vals[keep], wts[keep]
    return vals, wts / wts.sum()


def optimize_multi_constraint(cjob: ConstrainedJob, *, budget_b: float = 3.0,
                              seed: int = 0, n_trees: int = 10,
                              depth: int = 4, settings=None,
                              device="cuda") -> dict:
    """Greedy EI_c/E[cost] loop with the product-of-probabilities acquisition.

    The cost model speculates as usual; constraint forests are refit each
    step.  Returns the recommendation and its joint-constraint CNO.

    ``settings`` (a :class:`repro_torch.core.lookahead.Settings`) opts this
    loop into the same timeout-censored exploration as the core optimizer:
    runs are aborted at ``min(timeout_tmax_mult·t_max, (y* + kappa·sigma)/U)``,
    billed up to the cap, recorded as censored lower bounds (posterior
    clamped via ``acq.censored_adjust``), and excluded from incumbent and
    recommendation.  A censored run also reveals none of its constraint
    metrics.  When given, ``settings.n_trees``/``settings.depth`` override
    the keyword defaults.  The fits and the acquisition run on ``device``
    (``"cuda"`` by default; raises without a card).
    """
    sp = _Space(cjob.job.space, resolve_device(device))
    dev = sp.device
    job = cjob.job
    rng = np.random.default_rng(seed)
    space = job.space
    n_boot = job.bootstrap_size()
    boot = latin_hypercube_indices(space, n_boot, rng)
    cost = job.cost
    timeout = settings is not None and settings.timeout
    if settings is not None:
        n_trees, depth = settings.n_trees, settings.depth

    m = space.n_points
    y = np.zeros(m, np.float32)
    mask = np.zeros(m, bool)
    cens = np.zeros(m, bool)
    metric_obs = {k: np.zeros(m, np.float32) for k in cjob.metrics}
    beta = job.budget(budget_b)
    explored: list[int] = []
    tau_boot = (job.t_max * settings.timeout_tmax_mult if timeout
                else np.inf)

    def run(i: int, tau=np.inf):
        nonlocal beta
        cut = timeout and job.runtime[i] > tau
        billed = float(tau * job.unit_price[i]) if cut else cost[i]
        y[i] = billed
        cens[i] = bool(cut)
        if not cut:
            # an aborted run never reported its constraint metrics
            for k in metric_obs:
                metric_obs[k][i] = cjob.metrics[k][i]
        mask[i] = True
        explored.append(i)
        beta -= billed

    for i in boot:
        run(int(i), tau_boot)

    u = torch.as_tensor(np.asarray(job.unit_price, np.float32), device=dev)
    t_max = _scalar(job.t_max, dev)
    key = prng.PRNGKey(seed)
    names = list(cjob.metrics)
    while True:
        key, k_cost, k_con = prng.split(key, 3).unbind(-2)
        obs_y = y[mask]
        floor = 1e-6 + 0.01 * float(obs_y.std() if obs_y.size else 1.0)
        mu, sigma = sp.fit(k_cost, y, mask, floor, n_trees, depth)
        if timeout:
            mu, sigma = acq.censored_adjust(
                mu, sigma, torch.as_tensor(y, device=dev),
                torch.as_tensor(cens, device=dev), settings.cens_sigma_rel)
        # time constraint through the cost model + extra metric constraints;
        # censored runs never reported their metrics, so the metric forests
        # see only the completed observations.
        p_time = acq.constraint_prob(mu, sigma, u, t_max)
        p_rest = _constraint_probs(
            k_con, [metric_obs[k] for k in names], mask & ~cens,
            [cjob.thresholds[k] for k in names], sp,
            n_trees=n_trees, depth=depth)
        feas_obs = mask & ~cens & (job.runtime <= job.t_max)
        for k in names:
            feas_obs &= ~mask | (cjob.metrics[k] <= cjob.thresholds[k])
        best = float(np.min(np.where(feas_obs & mask, cost, np.inf)))
        ystar = best if np.isfinite(best) else float(
            np.max(np.where(mask, cost, -np.inf)) + 3 * float(sigma.max()))
        ei = acq.expected_improvement(mu, sigma, _scalar(ystar, dev))
        eic = acq.ftz(acq.ftz(ei * p_time) * p_rest)
        gamma = (~mask) & _host(acq.budget_ok(mu, sigma, _scalar(beta, dev)))
        if not gamma.any():
            break
        score = np.where(gamma, _host(eic) / np.maximum(_host(mu), 1e-9),
                         -np.inf)
        nxt = int(score.argmax())
        if cost[nxt] > beta:
            break
        tau = np.inf
        if timeout:
            tau = float(acq.timeout_cap(
                _scalar(best, dev), sigma[nxt],
                np.float32(job.unit_price[nxt]), np.float32(beta),
                job.t_max, settings.timeout_kappa,
                settings.timeout_tmax_mult).item())
        run(nxt, tau)

    arr = np.array(explored)
    feas = cjob.feasible[arr] & ~cens[arr]
    if feas.any():
        sub = arr[feas]
    else:
        sub = arr[~cens[arr]] if (~cens[arr]).any() else arr
    rec = int(sub[cost[sub].argmin()])
    return {"recommended": rec, "cno": cjob.cno(rec), "nex": len(explored),
            "censored": [int(i) for i in arr[cens[arr]]],
            "explored": explored}


# --------------------------------------------------------------------------- #
# Setup costs
# --------------------------------------------------------------------------- #
def default_setup_cost(space: DiscreteSpace, *, vm_type_dim: str = "vm_type",
                       n_dim: str = "cluster_vcpus", boot_fee: float = 0.002
                       ) -> Callable[[int | None, int], float]:
    """Paper §4.4 example model: booting new/changed VMs costs money.

    Charged per raw unit of the cluster-size dimension: a type change
    re-boots everything; growing the cluster boots only the delta; shrinking
    or re-using is free.  Host arithmetic, as in the reference.
    """
    names = list(space.names)
    ti = names.index(vm_type_dim)
    ni = names.index(n_dim)
    raw = space.points_raw

    def setup(prev: int | None, nxt: int) -> float:
        if prev is None:
            return boot_fee * float(raw[nxt, ni])
        if raw[prev, ti] != raw[nxt, ti]:
            return boot_fee * float(raw[nxt, ni])
        delta = float(raw[nxt, ni]) - float(raw[prev, ni])
        return boot_fee * max(delta, 0.0)

    return setup


def optimize_with_setup_costs(job: JobTable, settings, *, setup_cost,
                              budget_b: float = 3.0, seed: int = 0,
                              device="cuda") -> dict:
    """Greedy cost-aware loop where each step's spend includes setup(χ, x).

    The acquisition denominator becomes ``E[cost(x)] + setup(χ, x)`` (Alg. 2
    lines 3/19 amendment), so config order matters; the budget is likewise
    debited for setup.  Returns outcome dict with total setup spend.  The
    fits and the acquisition run on ``device`` (``"cuda"`` by default;
    raises without a card).
    """
    sp = _Space(job.space, resolve_device(device))
    dev = sp.device
    rng = np.random.default_rng(seed)
    space = job.space
    boot = latin_hypercube_indices(space, job.bootstrap_size(), rng)
    cost = job.cost
    m = space.n_points
    y = np.zeros(m, np.float32)
    mask = np.zeros(m, bool)
    beta = job.budget(budget_b)
    chi: int | None = None
    explored: list[int] = []
    setup_spent = 0.0

    def run(i: int):
        nonlocal beta, chi, setup_spent
        fee = setup_cost(chi, i)
        y[i] = cost[i]
        mask[i] = True
        explored.append(i)
        beta -= cost[i] + fee
        setup_spent += fee
        chi = i

    for i in boot:
        run(int(i))

    key = prng.PRNGKey(seed)
    u = torch.as_tensor(np.asarray(job.unit_price, np.float32), device=dev)
    t_max = _scalar(job.t_max, dev)
    while True:
        key, sub = prng.split(key).unbind(-2)
        obs_y = y[mask]
        floor = 1e-6 + 0.01 * float(obs_y.std() if obs_y.size else 1.0)
        mu, sigma = sp.fit(sub, y, mask, floor, settings.n_trees,
                           settings.depth)
        feas_obs = mask & (job.runtime <= job.t_max)
        best = float(np.min(np.where(feas_obs, cost, np.inf)))
        ystar = best if np.isfinite(best) else float(
            np.max(np.where(mask, cost, -np.inf)) + 3 * float(sigma.max()))
        eic = _host(acq.ei_constrained(mu, sigma, _scalar(ystar, dev), u,
                                       t_max))
        fees = np.array([setup_cost(chi, i) for i in range(m)])
        tot = _host(mu) + fees
        left_f32 = torch.as_tensor((beta - fees).astype(np.float32),
                                   device=dev)
        gamma = (~mask) & _host(acq.budget_ok(mu, sigma, left_f32))
        if not gamma.any():
            break
        score = np.where(gamma, eic / np.maximum(tot, 1e-9), -np.inf)
        nxt = int(score.argmax())
        if cost[nxt] + fees[nxt] > beta:
            break
        run(nxt)

    arr = np.array(explored)
    feas = job.feasible[arr]
    sub_arr = arr[feas] if feas.any() else arr
    rec = int(sub_arr[cost[sub_arr].argmin()])
    return {"recommended": rec, "cno": job.cno(rec), "nex": len(explored),
            "setup_spent": setup_spent, "explored": explored}
