"""The Lynceus optimization loop (paper Alg. 1) and its baselines, run as
the sequential oracle: one Python-driven run at a time.

``optimize`` drives one full optimization of a :class:`~repro_torch.jobs.
tables.JobTable`: LHS bootstrap, then ``select_next → run(config) →
update state`` until the budget filter comes back empty.  The
recommendation is the cheapest *feasible* completed config tried (Alg. 1
line 12).  Policies: ``lynceus`` (LA >= 1), ``la0`` (cost-normalized
greedy), ``bo`` (CherryPick-style greedy EI_c) and ``rnd`` (uniform random
under the same budget).  All consume the budget identically, bootstrap
included.

Selections run on the card by default (``device="cuda"``); the budget
accounting runs on the host in float32, the arithmetic the reference
performs, so both packages bill every run identically.
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable

import numpy as np

from repro_torch.core import lookahead, prng
from repro_torch.core.space import latin_hypercube_indices
from repro_torch.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.jobs.tables import JobTable

__all__ = ["Outcome", "optimize", "run_many"]


@dataclasses.dataclass(frozen=True)
class Outcome:
    """Result of one optimization run."""

    job: str
    policy: str
    recommended: int            # config index recommended at the end
    cno: float                  # cost(recommended) / cost(optimum)
    nex: int                    # number of explorations (bootstrap included)
    spent: float                # total profiling spend ($)
    budget: float               # the budget B it ran under
    found_optimum: bool
    explored: tuple[int, ...]   # exploration order (config indices)
    select_seconds: float       # mean wall-time of next-config selection
    trajectory: tuple[float, ...]  # best feasible CNO after each exploration
    censored: tuple[int, ...] = ()  # explored configs aborted at the timeout
    spend_trajectory: tuple[float, ...] = ()  # cumulative billed spend ($)


def _recommend(job: JobTable, explored: list[int], cens=None) -> int:
    """Cheapest feasible *completed* explored config (Alg. 1 line 12);
    fallbacks: cheapest completed, then cheapest explored."""
    arr = np.array(explored, dtype=int)
    cost = job.cost[arr]
    c = (np.asarray(cens, dtype=bool) if cens is not None
         else np.zeros(arr.size, dtype=bool))
    feas = job.feasible[arr] & ~c
    if feas.any():
        return int(arr[feas][cost[feas].argmin()])
    if (~c).any():
        return int(arr[~c][cost[~c].argmin()])
    return int(arr[cost.argmin()])


def _trajectory_point(job: JobTable, explored: list[int], cens=None) -> float:
    return job.cno(_recommend(job, explored, cens))


def _boot_tau(job: JobTable, settings: lookahead.Settings) -> np.float32:
    """Timeout for model-less runs (bootstrap, RND): the constraint cap
    ``f32(t_max)·f32(mult)``, as ``acq.timeout_cap`` computes it."""
    if not settings.timeout:
        return np.float32(np.inf)
    return np.float32(np.float32(job.t_max)
                      * np.float32(settings.timeout_tmax_mult))


def optimize(job: JobTable, settings: lookahead.Settings, *,
             budget_b: float = 3.0, seed: int = 0,
             bootstrap: np.ndarray | None = None,
             selector: Callable | None = None, device="cuda") -> Outcome:
    """Run one optimization of ``job`` under policy ``settings.policy``.

    Args:
      job: fully profiled job table (the simulator looks costs up).
      settings: selector knobs; ``settings.policy`` picks the algorithm.
      budget_b: the paper's ``b`` multiplier — B = N·m̃·b.
      seed: drives LHS bootstrap, bootstrap resampling and RND.
      bootstrap: optional explicit bootstrap indices.
      selector: pre-built ``make_selector`` closure for this space.
      device: where selections run — ``"cuda"`` (default; raises without a
        card) or ``"cpu"``.

    With ``settings.timeout`` each exploration runs under a cap τ; a run
    whose table runtime exceeds τ is billed ``τ·U`` and recorded as a
    censored observation.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_boot = job.bootstrap_size()
    budget = job.budget(budget_b)
    host = job.host_view()
    cost = host.cost

    if bootstrap is None:
        bootstrap = latin_hypercube_indices(job.space, n_boot, rng)

    m = job.space.n_points
    y = np.zeros(m, dtype=np.float32)
    mask = np.zeros(m, dtype=bool)
    cens = np.zeros(m, dtype=bool)
    cens_order: list[bool] = []
    explored: list[int] = []
    beta = np.float32(budget)
    trajectory: list[float] = []
    spend_traj: list[float] = []
    tau_boot = _boot_tau(job, settings)

    def run_config(i: int, tau=np.float32(np.inf)) -> None:
        nonlocal beta
        t = host.runtime[i]
        cut = bool(t > tau)
        billed = np.float32(tau * host.unit_price[i]) if cut else cost[i]
        y[i] = billed
        mask[i] = True
        cens[i] = cut
        explored.append(int(i))
        cens_order.append(cut)
        beta -= billed
        trajectory.append(_trajectory_point(job, explored, cens_order))
        spend_traj.append(float(budget - beta))

    for i in bootstrap:                       # Alg. 1 lines 6-8
        run_config(int(i), tau_boot)

    select_times: list[float] = []
    if settings.policy == "rnd":
        while True:
            free = np.where(~mask & (cost <= beta))[0]
            if free.size == 0:
                break
            run_config(int(rng.choice(free)), tau_boot)
    else:
        sel = selector or lookahead.make_selector(
            job.space, job.unit_price, job.t_max, settings, device=device)
        key = prng.PRNGKey(seed)
        while True:
            key, sub = prng.split(key)
            t0 = time.perf_counter()
            if settings.timeout:
                idx, valid, diag = sel(sub, y, mask, max(beta, 0.0), cens)
                tau = np.float32(diag["timeout"].item())
            else:
                idx, valid, _ = sel(sub, y, mask, max(beta, 0.0))
                tau = np.float32(np.inf)
            idx = int(idx)
            valid = bool(valid)
            select_times.append(time.perf_counter() - t0)
            if not valid:                     # Gamma empty -> stop (line 11)
                break
            if settings.policy == "bo" and cost[idx] > beta:
                break
            run_config(idx, tau)
            if beta <= 0:
                break

    rec = _recommend(job, explored, cens_order)
    return Outcome(
        job=job.name, policy=settings.policy, recommended=rec,
        cno=job.cno(rec), nex=len(explored), spent=float(budget - beta),
        budget=float(budget), found_optimum=(rec == job.optimum_index),
        explored=tuple(explored),
        select_seconds=float(np.mean(select_times)) if select_times else 0.0,
        trajectory=tuple(trajectory),
        censored=tuple(i for i, c in zip(explored, cens_order) if c),
        spend_trajectory=tuple(spend_traj))


def _per_run_seeds(seed: int, n_runs: int) -> list[int]:
    return [seed * 100003 + r for r in range(n_runs)]


def _per_run_bootstraps(job: JobTable, seeds) -> list[np.ndarray]:
    """The i-th bootstrap is a pure function of the i-th seed, so every
    policy handed the same seeds sees the same bootstraps (paper fairness)."""
    return [latin_hypercube_indices(job.space, job.bootstrap_size(),
                                    np.random.default_rng(s)) for s in seeds]


def run_many(job: JobTable, settings: lookahead.Settings, *, n_runs: int = 100,
             budget_b: float = 3.0, seed: int = 0, seeds=None,
             bootstraps=None, device="cuda") -> list[Outcome]:
    """Paper methodology: many runs, each with a different bootstrap; every
    policy sees the same i-th bootstrap for the same seed.  ``budget_b`` may
    be a scalar or a per-run sequence."""
    device = resolve_device(device)
    seeds, bootstraps = _resolve_runs(job, seed, n_runs, seeds, bootstraps)
    budgets_b = _resolve_budget_b(budget_b, len(seeds))
    selector = None
    if settings.policy != "rnd":
        selector = lookahead.make_selector(
            job.space, job.unit_price, job.t_max, settings, device=device)
    return [optimize(job, settings, budget_b=b, seed=s, bootstrap=boot,
                     selector=selector, device=device)
            for s, boot, b in zip(seeds, bootstraps, budgets_b)]


def _resolve_budget_b(budget_b, n_runs: int) -> list[float]:
    """Scalar -> broadcast; sequence -> validated per-run b multipliers."""
    if np.ndim(budget_b) == 0:
        return [float(budget_b)] * n_runs
    budgets = [float(b) for b in budget_b]
    if len(budgets) != n_runs:
        raise ValueError(f"{n_runs} runs but {len(budgets)} budget_b values; "
                         "pass a scalar or a matching sequence")
    return budgets


def _resolve_runs(job: JobTable, seed: int, n_runs: int, seeds, bootstraps):
    """Materialize per-run seeds/bootstraps; reject mismatched overrides."""
    seeds = list(seeds) if seeds is not None else _per_run_seeds(seed, n_runs)
    if bootstraps is None:
        bootstraps = _per_run_bootstraps(job, seeds)
    if len(bootstraps) != len(seeds):
        raise ValueError(f"{len(seeds)} seeds but {len(bootstraps)} "
                         "bootstraps; pass matching lists")
    return seeds, list(bootstraps)
