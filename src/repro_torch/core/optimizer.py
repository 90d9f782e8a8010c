"""The Lynceus optimization loop (paper Alg. 1), its baselines, and the
batched harness that runs many simulated optimizations at once.

``optimize`` drives one full optimization of a :class:`~repro_torch.jobs.
tables.JobTable`: LHS bootstrap, then ``select_next → run(config) →
update state`` until the budget filter comes back empty.  The
recommendation is the cheapest *feasible* completed config tried (Alg. 1
line 12).  Policies: ``lynceus`` (LA >= 1), ``la0`` (cost-normalized
greedy), ``bo`` (CherryPick-style greedy EI_c) and ``rnd`` (uniform random
under the same budget).  All consume the budget identically, bootstrap
included.

Execution backends, one Alg. 1 and the same Outcomes bit for bit:

* :func:`run_many` / :func:`run_queue` — the sequential oracle, one
  Python-driven run at a time, the budget accounting on the host in
  float32 (the arithmetic the reference performs);
* :func:`run_many_batched` with ``scheduler="lockstep"`` — fixed lanes,
  :func:`_batched_episode`: a chunk of runs advances step by step until
  its last lane's budget empties;
* ``scheduler="compact"`` (default) and :func:`run_queue_batched` — the
  lane-compacting work queue, :func:`_episode_segment`: a slot whose run
  ends banks it by run id and takes the next pending run, so short runs
  never idle behind long ones; queues may mix budgets and jobs, and jobs
  of different space geometries are padded into one
  :class:`~repro_torch.core.space.GeometryBucket`.

The batched state lives on the device in fixed-shape tensors; where the
reference runs a ``lax.while_loop``, the port runs a host loop of
device-side steps whose one host read a step is the loop condition (with
the slots' job ids, which group the selection: one root fit and one
``select_step`` launch a lookahead level for all slots of a job).  Every
slot is selected every step, idle ones included, as in the reference.

Everything runs on the card by default (``device="cuda"``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Callable

import numpy as np

import torch

from repro_torch.core import lookahead, prng, trees
from repro_torch.core.space import GeometryBucket, latin_hypercube_indices
from repro_torch.device import resolve_device

if TYPE_CHECKING:
    from repro_torch.jobs.tables import JobTable

__all__ = ["Outcome", "RunRequest", "episode_cache_size", "optimize",
           "run_many", "run_many_batched", "run_queue", "run_queue_batched"]


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


def optimize_live(evaluator, space, unit_price, t_max: float,
                  settings: lookahead.Settings, *, budget: float,
                  n_bootstrap: int | None = None, seed: int = 0,
                  log=None, device="cuda") -> dict:
    """Sequential optimization against a LIVE evaluator (no precomputed table).

    This is the framework-integration path (``launch/autotune.py``): each
    "run" of a configuration actually profiles it and charges its cost
    against the budget.  Selections run on ``device`` (``"cuda"`` by
    default; raises without a card), through ``make_selector`` as in
    :func:`optimize`.

    With ``settings.timeout`` every probe runs under a cap τ — the
    constraint cap ``timeout_tmax_mult·t_max`` for bootstrap probes, the
    selector's predictive cap afterwards.  A probe whose runtime exceeds τ
    is billed pro rata (``c·τ/t`` — the cost accrued up to the abort) and
    recorded as a censored lower bound; censored probes are never
    recommendable (their runtime was not observed to meet the SLO).

    The reference's precisions are kept, since they decide the cut and the
    bill: τ is a Python float (unlike :func:`optimize`'s float32), the pro
    rata bill is float64, the remaining budget float32.

    Args:
      evaluator: f(index) -> (runtime_seconds, cost_dollars) for config i.
      unit_price: [M] $/h while a config runs (for the EI_c constraint).
      t_max: runtime SLO in the same units as evaluator's runtime.
      budget: total profiling budget in cost units.
    Returns dict with explored, costs, runtimes, recommended, trajectory.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    m = space.n_points
    n_boot = n_bootstrap or max(int(np.ceil(0.03 * m)), space.n_dims)
    y = np.zeros(m, np.float32)
    runtimes = np.zeros(m, np.float32)
    mask = np.zeros(m, bool)
    cens = np.zeros(m, bool)
    explored: list[int] = []
    beta = np.float32(budget)
    tau_boot = (float(np.float32(t_max)
                      * np.float32(settings.timeout_tmax_mult))
                if settings.timeout else float("inf"))

    def run_config(i: int, tau: float = float("inf")):
        nonlocal beta
        t, c = evaluator(int(i))
        cut = settings.timeout and t > tau
        if cut:
            c = float(c) * tau / max(float(t), 1e-12)
        y[i] = c
        runtimes[i] = t
        mask[i] = True
        cens[i] = bool(cut)
        explored.append(int(i))
        beta = np.float32(beta - np.float32(c))
        if log:
            log(f"[tune] cfg {i}: runtime {t:.4f}s cost {c:.4f} "
                f"beta {beta:.3f}" + (f" CENSORED at tau {tau:.3f}s" if cut
                                      else ""))

    for i in latin_hypercube_indices(space, n_boot, rng):
        run_config(i, tau_boot)

    sel = lookahead.make_selector(space, unit_price, t_max, settings,
                                  device=device)
    key = prng.PRNGKey(seed)
    while beta > 0:
        key, sub = prng.split(key)
        if settings.timeout:
            idx, valid, diag = sel(sub, y, mask, max(beta, 0.0), cens)
            tau = float(diag["timeout"].item())
        else:
            idx, valid, _ = sel(sub, y, mask, max(beta, 0.0))
            tau = float("inf")
        if not bool(valid):
            break
        run_config(int(idx), tau)

    arr = np.array(explored)
    feas = (runtimes[arr] <= t_max) & ~cens[arr]
    if feas.any():
        sub_arr = arr[feas]
    elif (~cens[arr]).any():
        sub_arr = arr[~cens[arr]]
    else:
        sub_arr = arr
    rec = int(sub_arr[y[sub_arr].argmin()])
    return {"recommended": rec, "explored": explored,
            "costs": y[arr].tolist(), "runtimes": runtimes[arr].tolist(),
            "censored": [int(i) for i in arr[cens[arr]]],
            "spent": float(budget - beta), "budget": budget,
            "best_runtime": float(runtimes[rec]), "best_cost": float(y[rec])}


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


# --------------------------------------------------------------------------- #
# Batched, device-resident harness
# --------------------------------------------------------------------------- #
def _alg1_step(st, idx, c, t_run, u_at, valid, tau, s: lookahead.Settings,
               m_dim):
    """One masked Alg. 1 step on lane-stacked state, shared by both episode
    bodies so that their billing and censoring cannot drift apart.

    ``st`` carries y/mask/beta/explored/n_exp/active (+ cens/cexpl/bexpl
    with ``s.timeout``); ``idx``/``valid`` come from the selection,
    ``c``/``t_run``/``u_at`` are each lane's table rows at its pick
    (t_run, u_at and tau only with ``s.timeout``).  Every write is a
    select on the lane's row, so the step is elementwise and deterministic.
    Returns the updated fields and ``alive`` (Alg. 1 line 11).
    """
    run = st["active"] & valid                          # Gamma empty -> stop
    if s.policy == "bo":
        # Cost-unaware greedy stops when its pick is unaffordable.
        run = run & (c <= st["beta"])
    if s.timeout:
        # Abort at the predictive cap: bill tau·U, learn the lower bound.
        cut = run & (t_run > tau)
        billed = torch.where(cut, tau * u_at, c)
    else:
        billed = c
    cols = torch.arange(m_dim, device=idx.device)[None, :]
    hit = run[:, None] & (cols == idx[:, None])
    pos = torch.clamp_max(st["n_exp"], m_dim - 1)
    at = run[:, None] & (cols == pos[:, None])          # the trace's next slot
    nxt = {"y": torch.where(hit, billed[:, None], st["y"]),
           "mask": st["mask"] | hit,
           "beta": torch.where(run, st["beta"] - billed, st["beta"]),
           "explored": torch.where(at, idx.to(torch.int32)[:, None],
                                   st["explored"]),
           "n_exp": st["n_exp"] + run.to(torch.int32)}
    if s.timeout:
        nxt["cens"] = st["cens"] | (hit & cut[:, None])
        nxt["cexpl"] = torch.where(at, cut[:, None], st["cexpl"])
        nxt["bexpl"] = torch.where(at, billed[:, None], st["bexpl"])
    alive = run & (nxt["beta"] > 0.0)                   # Alg. 1 line 11
    return nxt, alive


# The program geometries the episode functions have run, keyed as the
# reference's jit cache keys its episode programs (shapes, Settings, the
# queue's kind and the device the program runs on, as a jitted program
# placed on another device is another executable): eager PyTorch compiles
# nothing, so this set is the port's compile-count observable.
_EPISODE_PROGRAMS: set = set()


def episode_cache_size() -> int:
    """Distinct episode program geometries run so far (lockstep and
    segment), one per (geometry, device): draining a queue that mixes J
    native geometries padded into one bucket adds exactly one, where J
    per-geometry sub-queues would add J; a sharded service adds one per
    shard device.  The selections inside an episode are not counted by
    ``lookahead.selector_cache_size``, as the reference inlines them."""
    return len(_EPISODE_PROGRAMS)


def _read_step(active, *ints):
    """A step's one host read, its loop condition: whether any lane of
    ``active`` is on, and the values of the int tensors ``ints``, in one
    copy from the device."""
    vals = torch.cat([active.any().reshape(1).to(torch.int64)]
                     + [t.reshape(-1).to(torch.int64) for t in ints])
    vals = vals.tolist()
    return bool(vals[0]), vals[1:]


def _lockstep_body(st, cost, runtime, space, s: lookahead.Settings):
    """One step of :func:`_batched_episode`: select for every lane (one
    job: one group), then Alg. 1's masked update."""
    m_dim = st["y"].shape[1]
    key, sub = prng.split(st["key"]).unbind(-2)
    idx, valid, diag = lookahead._select_slots(
        sub, st["y"], st["mask"], torch.clamp_min(st["beta"], 0.0),
        st.get("cens"), [(None, space)], s)
    u = space[3]
    nxt, alive = _alg1_step(
        st, idx, cost[idx], runtime[idx] if s.timeout else None,
        u[idx] if s.timeout else None, valid, diag.get("timeout"), s, m_dim)
    nxt.update(key=key, active=alive)
    return nxt


def _batched_episode(keys, y, mask, beta, explored, n_exp, cens, cexpl,
                     bexpl, cost, runtime, points, left, thresholds, u, t_max,
                     s: lookahead.Settings):
    """Advance R simulated optimizations to completion in lockstep.

    A host loop of :func:`_lockstep_body` steps over device tensors; the
    loop condition (any lane active) is each step's one host read.  keys:
    [R, 2]; y/mask: [R, M]; beta: [R]; explored: [R, M] int32 (-1 padded,
    bootstrap prefix written); n_exp: [R] int32; with ``s.timeout`` cens,
    cexpl [R, M] bool, bexpl [R, M] float32 and ``runtime`` [M] (all None
    without).  Returns (beta, explored, n_exp, steps[, cexpl, bexpl]).
    """
    r_dim, m_dim = y.shape
    _EPISODE_PROGRAMS.add(("lockstep", r_dim, m_dim, tuple(points.shape),
                           tuple(thresholds.shape), s, y.device))
    st = {"key": keys, "y": y, "mask": mask, "beta": beta,
          "explored": explored, "n_exp": n_exp,
          "active": torch.ones((r_dim,), dtype=torch.bool, device=y.device)}
    if s.timeout:
        st.update(cens=cens, cexpl=cexpl, bexpl=bexpl)
    space = (points, left, thresholds, u, t_max, None)
    steps = 0
    while _read_step(st["active"])[0]:
        st = _lockstep_body(st, cost, runtime, space, s)
        steps += 1
    base = (st["beta"], st["explored"], st["n_exp"], steps)
    return base + (st["cexpl"], st["bexpl"]) if s.timeout else base


def _auto_lane_chunk(job: JobTable, s: lookahead.Settings, n_runs: int,
                     m: int | None = None) -> int:
    """Slot-count sizing: bound the deepest speculative tensor
    (n_trees × M × M·k^la per slot).  Used both as the lockstep chunk width
    and as the compacting scheduler's seat count.  ``m`` overrides the
    job's native point count (a geometry-bucketed queue pays the *bucket*
    width per slot, not the native one)."""
    m = job.space.n_points if m is None else m
    states = m * (s.k_gh ** max(s.la, 0) if s.policy == "lynceus" else 1)
    budget_elems = 1.5e8
    return int(max(1, min(n_runs, budget_elems // (s.n_trees * m * states))))


@dataclasses.dataclass(frozen=True)
class RunRequest:
    """One pending simulated optimization in a work queue.

    ``bootstrap`` is derived from ``seed`` when None — the derivation
    :func:`optimize` performs, so a queue and the sequential oracle replay
    identical bootstraps for the same seed.  Jobs and budgets may differ
    per request; jobs whose spaces differ in geometry are padded into one
    :class:`~repro_torch.core.space.GeometryBucket` (see
    :func:`run_queue_batched`).
    """

    job: JobTable
    seed: int
    budget_b: float = 3.0
    bootstrap: np.ndarray | None = None

    def resolved_bootstrap(self) -> np.ndarray:
        if self.bootstrap is not None:
            return np.asarray(self.bootstrap)
        return latin_hypercube_indices(
            self.job.space, self.job.bootstrap_size(),
            np.random.default_rng(self.seed))


def _init_run_states(requests: list[RunRequest],
                     settings: lookahead.Settings,
                     m_pad: int | None = None) -> dict:
    """Host-side bootstrap replay for a batch of pending runs, float32 —
    Alg. 1 lines 6-8, the arithmetic :func:`optimize` performs before its
    selection loop (the constraint-cap censoring of bootstrap runs
    included).  Returns [R, ...] numpy initial-state arrays, the [R, 2]
    keys (``prng.PRNGKey``) and the per-run budgets.  ``m_pad`` widens the
    rows to a geometry bucket's width; the padding tail stays unobserved.
    """
    r_tot = len(requests)
    m = requests[0].job.space.n_points if m_pad is None else m_pad
    y0 = np.zeros((r_tot, m), np.float32)
    m0 = np.zeros((r_tot, m), bool)
    c0 = np.zeros((r_tot, m), bool)
    cx0 = np.zeros((r_tot, m), bool)
    bx0 = np.zeros((r_tot, m), np.float32)
    beta0 = np.zeros(r_tot, np.float32)
    expl0 = np.full((r_tot, m), -1, np.int32)
    n_exp0 = np.zeros(r_tot, np.int32)
    budgets = np.zeros(r_tot, np.float64)
    for r, req in enumerate(requests):
        host = req.job.host_view()
        tau_boot = _boot_tau(req.job, settings)
        budget = req.job.budget(req.budget_b)
        budgets[r] = budget
        beta0[r] = np.float32(budget)
        boot = req.resolved_bootstrap()
        for j, i in enumerate(boot):
            i = int(i)
            cut = bool(host.runtime[i] > tau_boot)
            billed = (np.float32(tau_boot * host.unit_price[i]) if cut
                      else host.cost[i])
            y0[r, i] = billed
            m0[r, i] = True
            c0[r, i] = cut
            cx0[r, j] = cut
            bx0[r, j] = billed
            beta0[r] = beta0[r] - billed
            expl0[r, j] = i
        n_exp0[r] = len(boot)
    keys0 = torch.stack([prng.PRNGKey(req.seed) for req in requests]).numpy()
    return {"keys": keys0, "y": y0, "mask": m0, "beta": beta0,
            "explored": expl0, "n_exp": n_exp0, "cens": c0, "cexpl": cx0,
            "bexpl": bx0, "budgets": budgets}


def _reconstruct_outcome(job: JobTable, settings: lookahead.Settings,
                         budget: float, explored: list[int],
                         cflags: list[bool], billed, beta_final: float,
                         sel_s: float) -> Outcome:
    """Post-hoc :class:`Outcome` from a recorded exploration trace — pure
    table math, what the sequential loop computes inline.
    ``spend_trajectory`` replays the run's float32 budget subtraction on
    the host, in the episode's order."""
    rec = _recommend(job, explored, cflags)
    trajectory = [_trajectory_point(job, explored[:j + 1], cflags[:j + 1])
                  for j in range(len(explored))]
    beta_r = np.float32(budget)
    spend_traj = []
    for b in billed:
        beta_r = np.float32(beta_r - b)
        spend_traj.append(float(budget - beta_r))
    return Outcome(
        job=job.name, policy=settings.policy, recommended=rec,
        cno=job.cno(rec), nex=len(explored),
        spent=float(budget - beta_final), budget=float(budget),
        found_optimum=(rec == job.optimum_index),
        explored=tuple(explored), select_seconds=sel_s,
        trajectory=tuple(trajectory),
        censored=tuple(i for i, f in zip(explored, cflags) if f),
        spend_trajectory=tuple(spend_traj))


# --------------------------------------------------------------------------- #
# Lane-compacting work-queue scheduler (segment-driven)
# --------------------------------------------------------------------------- #
# A step quota that a terminating queue can never hit: "run to completion".
_STEPS_UNBOUNDED = np.iinfo(np.int32).max

# Slot-carry fields present only when ``s.timeout``.
_CARRY_TIMEOUT_KEYS = ("cens", "cexpl", "bexpl")


def _fresh_slot_carry(l_dim: int, m_dim: int, s: lookahead.Settings,
                      device="cuda") -> dict:
    """All-idle slot carry for a segment-driven episode on ``device``:
    every seat empty (``rid = -1``, inactive), queue head at 0."""
    dev = torch.device(device)
    z = lambda dt, *shape: torch.zeros(shape, dtype=dt, device=dev)
    carry = {"key": z(torch.int64, l_dim, 2),
             "y": z(torch.float32, l_dim, m_dim),
             "mask": z(torch.bool, l_dim, m_dim),
             "beta": z(torch.float32, l_dim),
             "explored": torch.full((l_dim, m_dim), -1, dtype=torch.int32,
                                    device=dev),
             "n_exp": z(torch.int32, l_dim),
             "rid": torch.full((l_dim,), -1, dtype=torch.int32, device=dev),
             "active": z(torch.bool, l_dim),
             "qhead": z(torch.int32)}
    if s.timeout:
        carry["cens"] = z(torch.bool, l_dim, m_dim)
        carry["cexpl"] = z(torch.bool, l_dim, m_dim)
        carry["bexpl"] = z(torch.float32, l_dim, m_dim)
    return carry


def _seed_carry_from_queue(queue: dict, l_dim: int,
                           s: lookahead.Settings) -> dict:
    """Seat the first ``l_dim`` queue rows in the slots (``qhead = l_dim``,
    ``rid = l_dim + row``): the one-shot entry's initial state."""
    dev = queue["y"].device
    carry = {k: queue[k][:l_dim] for k in ("keys", "y", "mask", "beta",
                                           "explored", "n_exp")}
    carry["key"] = carry.pop("keys")
    carry.update(rid=l_dim + torch.arange(l_dim, dtype=torch.int32,
                                          device=dev),
                 active=torch.ones((l_dim,), dtype=torch.bool, device=dev),
                 qhead=torch.full((), l_dim, dtype=torch.int32, device=dev))
    if s.timeout:
        for k in _CARRY_TIMEOUT_KEYS:
            carry[k] = queue[k][:l_dim]
    return carry


_BANKED = {"out_beta": "beta", "out_nexp": "n_exp", "out_expl": "explored",
           "out_cexpl": "cexpl", "out_bexpl": "bexpl"}


def _bank(out: dict, tgt, state: dict) -> dict:
    """Write each lane's ``state`` into the output rows ``tgt`` (the sink
    row ``n_out`` for lanes that bank nothing; distinct rows otherwise)."""
    return {k: (v.index_put((tgt,), state[_BANKED[k]]) if k in _BANKED
                else v) for k, v in out.items()}


def _job_groups(jids, space_of):
    """The selection groups of a step: the slots of each job (from the
    host copy of their job ids) and that job's rows."""
    members: dict[int, list[int]] = {}
    for r, j in enumerate(jids):
        members.setdefault(j, []).append(r)
    if len(members) == 1:
        return [(None, space_of(jids[0]))]
    return [(m, space_of(j)) for j, m in members.items()]


def _job_rows(job_ids, points, left, thresholds, u, t_max, valid):
    """``space_of(j)``: the rows job j's slots select on — the queue's
    shared rows for a single-job queue, else job j's price row and SLO,
    and (geometry-bucketed) its padded space and validity rows."""
    if job_ids is None:
        return lambda j: (points, left, thresholds, u, t_max, valid)
    bucketed = points.dim() == 3
    return lambda j: (
        points[j] if bucketed else points, left[j] if bucketed else left,
        thresholds[j] if bucketed else thresholds, u[j], t_max[j],
        valid[j] if bucketed else valid)


def _segment_body(st, queue, qtail: int, groups, job_ids, cost, runtime, u,
                  s: lookahead.Settings, n_out: int):
    """One step of :func:`_episode_segment`: select for every slot (one
    group a job), Alg. 1's masked update, bank the runs that ended by run
    id, and refill the seatless slots from the queue head in slot order."""
    l_dim, m_dim = st["y"].shape
    key, sub = prng.split(st["key"]).unbind(-2)
    rid_safe = torch.clamp_min(st["rid"], 0)
    idx, sel_ok, diag = lookahead._select_slots(
        sub, st["y"], st["mask"], torch.clamp_min(st["beta"], 0.0),
        st.get("cens"), groups, s)
    if job_ids is None:
        pick = lambda tab: tab[idx]
    else:
        jid = job_ids[rid_safe]
        pick = lambda tab: tab[jid, idx]
    step, alive = _alg1_step(
        st, idx, pick(cost), pick(runtime) if s.timeout else None,
        pick(u) if s.timeout else None, sel_ok, diag.get("timeout"), s,
        m_dim)

    # A slot's run terminated this step -> bank it by run id.
    finished = st["active"] & ~alive
    tgt = torch.where(finished, rid_safe, n_out)
    out = _bank({k: v for k, v in st.items() if k.startswith("out_")}, tgt,
                step)
    out["out_done"] = out["out_done"].index_put(
        (tgt,), torch.ones_like(finished))

    # Refill seatless slots (just finished, or idle from an earlier drain)
    # from the queue head, in slot order: the k-th seatable slot takes
    # queue row qhead + k.
    seatable = ~alive
    rank = torch.cumsum(seatable.to(torch.int32), 0, dtype=torch.int32) - 1
    cand = st["qhead"] + rank
    got = seatable & (cand < qtail)
    src = torch.where(got, cand, 0).to(torch.int64)
    fill = lambda init, cur: torch.where(
        got.reshape((l_dim,) + (1,) * (cur.dim() - 1)),
        init.index_select(0, src), cur)
    nxt = {"key": fill(queue["keys"], key),
           "rid": torch.where(got, l_dim + cand,
                              torch.where(finished, -1, st["rid"])),
           "active": alive | got,
           "qhead": st["qhead"] + got.sum(dtype=torch.int32),
           "busy": st["busy"] + st["active"].sum(dtype=torch.int32)}
    for k, v in step.items():
        nxt[k] = fill(queue[k], v)
    nxt.update(out)
    return nxt


def _segment_start(carry, evict, n_out: int, s: lookahead.Settings):
    """A segment's state before its first step: the carry, the banking
    rows (``n_out`` and the sink row) and the step counters, after the
    boundary eviction: each seated slot flagged in ``evict`` banks its
    partial state by run id (``out_done`` stays False) and frees its seat,
    which then refills like any drained slot."""
    m_dim = carry["y"].shape[1]
    dev = carry["y"].device
    rows = n_out + 1
    st = dict(carry)
    st.update(busy=torch.zeros((), dtype=torch.int32, device=dev),
              out_done=torch.zeros((rows,), dtype=torch.bool, device=dev),
              out_beta=torch.zeros((rows,), dtype=torch.float32, device=dev),
              out_nexp=torch.zeros((rows,), dtype=torch.int32, device=dev),
              out_expl=torch.full((rows, m_dim), -1, dtype=torch.int32,
                                  device=dev))
    if s.timeout:
        st["out_cexpl"] = torch.zeros((rows, m_dim), dtype=torch.bool,
                                      device=dev)
        st["out_bexpl"] = torch.zeros((rows, m_dim), dtype=torch.float32,
                                      device=dev)
    kill = carry["active"] & evict
    tgt0 = torch.where(kill, torch.clamp_min(carry["rid"], 0), n_out)
    st.update(_bank({k: v for k, v in st.items() if k.startswith("out_")},
                    tgt0, carry))
    st["active"] = carry["active"] & ~kill
    st["rid"] = torch.where(kill, -1, carry["rid"])
    return st


def _episode_segment(carry, queue, qtail, evict, low_water, step_quota,
                     job_ids, cost, runtime, points, left, thresholds,
                     valid, u, t_max, s: lookahead.Settings):
    """Advance ``l_dim`` lane *slots* through one bounded episode segment.

    A host loop of :func:`_segment_body` steps over device tensors.  A slot
    holds a *seat*, not a fixed run: when its run terminates (Gamma empty,
    unaffordable BO pick, or budget empty), the slot banks the run's final
    state into run-id-indexed output rows and takes the next pending run
    from the queue head.  Each step's one host read (``_read_step``) is the
    loop condition: whether any slot is active, the queue head, and (for a
    mixed-job queue) each slot's job, which groups the selection.

    The segment exits when the queue is drained (head at ``qtail``, every
    slot idle), when fewer than ``low_water`` pending rows remain (0
    disables; a segment always runs at least one step), or after
    ``step_quota`` steps.

    ``carry`` holds the persistent slot state (:func:`_fresh_slot_carry` /
    :func:`_seed_carry_from_queue`); ``queue`` [C, ...] pending initial run
    states, rows ``qhead..qtail`` unconsumed.  A run seated from queue row
    ``j`` banks into output row ``l_dim + j``; rows below ``l_dim`` take
    runs already seated at segment start.  ``evict`` ([l_dim] bool): before
    the first step, each seated slot whose flag is set banks its partial
    state into its run's row (``out_done`` stays False) and frees its
    seat.  The reference's dropped scatters write the sink row ``n_out``,
    which the report slices off.

    ``job_ids`` is None for a single-job queue (``cost``/``runtime``/``u``
    [M] rows, a scalar ``t_max``); else [l_dim + C] int job indices by run
    id into [J, M]-stacked tables and [J] ``t_max``.  ``valid`` is None for
    a native shared space; for a geometry-bucketed queue ``points``/
    ``left``/``thresholds`` are [J, ...]-stacked padded tensors and
    ``valid`` the [J, M] point-validity rows.

    Returns ``(carry', report)``: the persistent slot state and the
    banking rows (``out_done``/``out_beta``/``out_nexp``/``out_expl``
    [+ ``out_cexpl``/``out_bexpl``]) with ``steps`` and ``busy``
    (active-slot-steps).  Outcomes do not depend on seating or arrival
    order; the caller keys results by run id, never by slot.
    """
    l_dim, m_dim = carry["y"].shape
    c_dim = queue["y"].shape[0]
    n_out = l_dim + c_dim
    kind = ("single" if job_ids is None
            else "bucketed" if points.dim() == 3 else "mixed")
    _EPISODE_PROGRAMS.add(("segment", kind, l_dim, c_dim, m_dim,
                           tuple(points.shape), tuple(thresholds.shape),
                           tuple(cost.shape), s, carry["y"].device))
    st = _segment_start(carry, evict, n_out, s)
    space_of = _job_rows(job_ids, points, left, thresholds, u, t_max, valid)
    steps = 0
    while True:
        extra = () if job_ids is None else (
            job_ids[torch.clamp_min(st["rid"], 0)],)
        any_active, (qhead, *jids) = _read_step(st["active"], st["qhead"],
                                                *extra)
        pending = qtail - qhead
        if not ((any_active or pending > 0) and steps < step_quota
                and (steps == 0 or pending >= low_water)):
            break
        groups = _job_groups(jids or [0], space_of)
        st = _segment_body(st, queue, qtail, groups, job_ids, cost, runtime,
                           u, s, n_out)
        steps += 1
    report = {k: st.pop(k)[:n_out] for k in list(st) if k.startswith("out_")}
    report.update(steps=steps, busy=st.pop("busy"))
    return st, report


def _spaces_shared(jobs: list[JobTable]) -> bool:
    """True when every job's space is bit-identical to the first's — the
    condition for the native shared-tensor selector program."""
    ref = jobs[0].space
    return all(job.space.n_points == ref.n_points
               and np.array_equal(job.space.points, ref.points)
               and np.array_equal(job.space.thresholds, ref.thresholds)
               for job in jobs[1:])


def _resolve_bucket(jobs: list[JobTable], bucket) -> GeometryBucket | None:
    """The geometry bucket a queue must run under, or None for the native
    shared-space program.  ``bucket`` may be None (auto: pad only when the
    jobs' spaces differ), a ``(m, f, t)`` tuple or a
    :class:`GeometryBucket`: an explicit bucket pads even a single
    geometry.  A bucket narrower than a member geometry raises in
    :func:`_queue_spaces`."""
    if bucket is None:
        if _spaces_shared(jobs):
            return None
        return GeometryBucket.for_spaces([j.space for j in jobs])
    if not isinstance(bucket, GeometryBucket):
        bucket = GeometryBucket(*bucket)
    return bucket


def _queue_spaces(jobs: list[JobTable], bucket: GeometryBucket, device):
    """[J, ...]-stacked padded space tensors and validity masks of a
    geometry-bucketed queue on ``device``: ``(points [J, M, F], left
    [J, M, F, T], thresholds [J, F, T], valid [J, M])``."""
    pads = [j.space.pad_to(bucket) for j in jobs]
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    return (torch.stack([as_t(p.points) for p in pads]),
            torch.stack([trees.make_left_table(p.points, p.thresholds,
                                               device=device)
                         for p in pads]),
            torch.stack([as_t(p.thresholds) for p in pads]),
            torch.stack([as_t(p.valid) for p in pads]))


def _queue_tables(jobs: list[JobTable], u0, bucket: GeometryBucket | None,
                  device):
    """Device job tables of a (possibly mixed-job) queue.  Single job, no
    bucket: shared [M] rows and a scalar t_max (``u0``, the space-bound
    price row of ``lookahead.space_arrays``).  Otherwise [J, M]-stacked
    tables (padded to ``bucket.m`` with a bucket) and [J] t_max for
    run-id-indexed gathers.  Returns ``(cost, runtime, u, t_max, single)``.
    """
    if len(jobs) == 1 and bucket is None:
        dev = jobs[0].device_view(device=device)
        t_max = torch.tensor(float(np.float32(jobs[0].t_max)),
                             dtype=torch.float32, device=device)
        return dev.cost, dev.runtime, u0, t_max, True
    m_pad = None if bucket is None else bucket.m
    devs = [j.device_view(m_pad, device=device) for j in jobs]
    return (torch.stack([d.cost for d in devs]),
            torch.stack([d.runtime for d in devs]),
            torch.stack([d.unit_price for d in devs]),
            torch.tensor([j.t_max for j in jobs], dtype=torch.float32,
                         device=device), False)


def run_queue(requests: list[RunRequest], settings: lookahead.Settings,
              device="cuda") -> list[Outcome]:
    """Sequential oracle over a heterogeneous work queue — one
    :func:`optimize` call per request, selectors cached per job."""
    device = resolve_device(device)
    selectors: dict[int, Callable] = {}
    outs = []
    for req in requests:
        sel = None
        if settings.policy != "rnd":
            sel = selectors.get(id(req.job))
            if sel is None:
                sel = lookahead.make_selector(
                    req.job.space, req.job.unit_price, req.job.t_max,
                    settings, device=device)
                selectors[id(req.job)] = sel
        outs.append(optimize(req.job, settings, budget_b=req.budget_b,
                             seed=req.seed,
                             bootstrap=req.resolved_bootstrap(),
                             selector=sel, device=device))
    return outs


def _outcomes(requests, settings, budgets, beta_f, expl_f, n_exp_f, cexpl_f,
              bexpl_f, sel_s) -> list[Outcome]:
    """The Outcomes of banked runs, row r for ``requests[r]``."""
    outs = []
    for r, req in enumerate(requests):
        explored = [int(i) for i in expl_f[r, :n_exp_f[r]]]
        if settings.timeout:
            cflags = [bool(f) for f in cexpl_f[r, :n_exp_f[r]]]
            billed = bexpl_f[r, :n_exp_f[r]]
        else:
            cflags = [False] * len(explored)
            billed = req.job.host_view().cost[explored]
        outs.append(_reconstruct_outcome(
            req.job, settings, float(budgets[r]), explored, cflags, billed,
            beta_f[r], sel_s))
    return outs


def run_queue_batched(requests: list[RunRequest],
                      settings: lookahead.Settings, *,
                      lane_slots: int | None = None, bucket=None,
                      device="cuda") -> list[Outcome]:
    """Drain a mixed-budget, mixed-job run queue through compacting lanes.

    The device-resident counterpart of :func:`run_queue`: R pending runs,
    ``lane_slots`` seats (default :func:`_auto_lane_chunk`), one unbounded
    :func:`_episode_segment`.  Jobs whose spaces differ in geometry are
    right-padded into one :class:`~repro_torch.core.space.GeometryBucket`
    (auto-sized, or forced via ``bucket``, a ``(m, f, t)`` tuple or a
    ``GeometryBucket``).  Outcomes come back in request order, bit-identical
    to :func:`run_queue`'s.  ``rnd`` falls through to :func:`run_queue`.
    """
    device = resolve_device(device)
    if not requests:
        return []
    if settings.policy == "rnd":
        return run_queue(requests, settings, device=device)
    jobs: list[JobTable] = []
    for req in requests:
        if not any(req.job is j for j in jobs):
            jobs.append(req.job)
    bucket = _resolve_bucket(jobs, bucket)
    job0 = jobs[0]
    r_tot = len(requests)
    m_sel = job0.space.n_points if bucket is None else bucket.m
    if lane_slots is None:
        lane_slots = _auto_lane_chunk(job0, settings, r_tot, m=m_sel)
    lane_slots = max(1, min(lane_slots, r_tot))

    if bucket is None:
        points, left, thresholds, u0 = lookahead.space_arrays(
            job0.space, job0.unit_price, device)
        valid_t = None
    else:
        # Also validates bucket >= every member geometry (pad_to raises)
        # before any bucket-width state is built.
        points, left, thresholds, valid_t = _queue_spaces(jobs, bucket,
                                                          device)
        u0 = None
    queue = _init_run_states(requests, settings,
                             None if bucket is None else bucket.m)
    budgets = queue.pop("budgets")
    cost_t, runtime_t, u_t, tmax_t, single = _queue_tables(jobs, u0, bucket,
                                                           device)
    job_ids = None
    if not single:
        index_of = {id(j): k for k, j in enumerate(jobs)}
        # Run-id indexed: rows below lane_slots are seat-section padding
        # (in-flight runs keep their queue-row run id lane_slots + r).
        job_ids = torch.tensor(
            [0] * lane_slots + [index_of[id(req.job)] for req in requests],
            dtype=torch.int64, device=device)
    qarrays = {k: torch.as_tensor(v, device=device)
               for k, v in queue.items()
               if settings.timeout or k not in _CARRY_TIMEOUT_KEYS}
    carry = _seed_carry_from_queue(qarrays, lane_slots, settings)
    t0 = time.perf_counter()
    # One unbounded segment (no low-water mark, no step quota) drains the
    # whole queue.
    _, report = _episode_segment(
        carry, qarrays, r_tot,
        torch.zeros((lane_slots,), dtype=torch.bool, device=device), 0,
        _STEPS_UNBOUNDED, job_ids, cost_t, runtime_t, points, left,
        thresholds, valid_t, u_t, tmax_t, settings)
    host = {k: v.cpu().numpy() for k, v in report.items()
            if isinstance(v, torch.Tensor)}
    wall = time.perf_counter() - t0
    # Amortized wall time per selection (steps x slots selections).
    sel_s = wall / max(report["steps"] * lane_slots, 1)
    cut = lambda k: host[k][lane_slots:] if k in host else None
    return _outcomes(requests, settings, budgets, cut("out_beta"),
                     cut("out_expl"), cut("out_nexp"), cut("out_cexpl"),
                     cut("out_bexpl"), sel_s)


def run_many_batched(job: JobTable, settings: lookahead.Settings, *,
                     n_runs: int = 100, budget_b: float = 3.0, seed: int = 0,
                     seeds=None, bootstraps=None,
                     lane_chunk: int | None = None,
                     scheduler: str = "compact", bucket=None,
                     device="cuda") -> list[Outcome]:
    """Batched :func:`run_many`: R device-resident runs on shared lane
    slots, each with the oracle's exact Alg. 1 semantics (key schedule,
    float32 budget accounting, bootstrap replay, stopping rule), so the
    Outcomes are bit-identical to :func:`run_many`'s.

    ``scheduler="compact"`` (default) drains a queue of the runs through
    ``lane_chunk`` compacting slots (:func:`run_queue_batched`);
    ``"lockstep"`` advances chunks of ``lane_chunk`` runs in lockstep until
    each chunk's last lane ends (:func:`_batched_episode`).  ``bucket``
    (compact only) forces a geometry bucket.  ``rnd`` falls through to
    the sequential path.  ``budget_b`` may be a scalar or a per-run
    sequence.
    """
    if scheduler not in ("compact", "lockstep"):
        raise ValueError(f"unknown scheduler {scheduler!r}; "
                         "expected 'compact' or 'lockstep'")
    if bucket is not None and scheduler != "compact":
        raise ValueError("geometry buckets run on the compacting "
                         "scheduler only (lockstep is the native-geometry "
                         "audit baseline)")
    device = resolve_device(device)
    if settings.policy == "rnd":
        return run_many(job, settings, n_runs=n_runs, budget_b=budget_b,
                        seed=seed, seeds=seeds, bootstraps=bootstraps,
                        device=device)
    seeds, bootstraps = _resolve_runs(job, seed, n_runs, seeds, bootstraps)
    budgets_b = _resolve_budget_b(budget_b, len(seeds))
    n_runs = len(seeds)
    requests = [RunRequest(job, s, b, boot)
                for s, b, boot in zip(seeds, budgets_b, bootstraps)]
    if scheduler == "compact":
        # Slot sizing is left to run_queue_batched when lane_chunk is None:
        # it must count the bucket's point width, not the native one.
        return run_queue_batched(requests, settings, lane_slots=lane_chunk,
                                 bucket=bucket, device=device)
    if lane_chunk is None:
        lane_chunk = _auto_lane_chunk(job, settings, n_runs)

    dev = job.device_view(device=device)
    points, left, thresholds, u = lookahead.space_arrays(
        job.space, job.unit_price, device)
    t_max32 = torch.tensor(float(np.float32(job.t_max)), dtype=torch.float32,
                           device=device)
    outs: list[Outcome] = []
    for lo in range(0, n_runs, lane_chunk):
        chunk = requests[lo:lo + lane_chunk]
        st = {k: torch.as_tensor(v, device=device) if k != "budgets" else v
              for k, v in _init_run_states(chunk, settings).items()}
        to = lambda k: st[k] if settings.timeout else None
        t0 = time.perf_counter()
        res = _batched_episode(
            st["keys"], st["y"], st["mask"], st["beta"], st["explored"],
            st["n_exp"], to("cens"), to("cexpl"), to("bexpl"), dev.cost,
            dev.runtime, points, left, thresholds, u, t_max32, settings)
        host = [r.cpu().numpy() if isinstance(r, torch.Tensor) else r
                for r in res]
        wall = time.perf_counter() - t0
        # Amortized wall time per selection (steps x lanes selections).
        sel_s = wall / max(host[3] * len(chunk), 1)
        outs += _outcomes(chunk, settings, st["budgets"], host[0], host[1],
                          host[2], host[4] if settings.timeout else None,
                          host[5] if settings.timeout else None, sel_s)
    return outs
