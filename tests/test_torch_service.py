"""The port's streaming service against the JAX package: arrival-order
invariance, shard-count invariance, and the service's construction and
configuration.

The arrival-order cases of ``tests/test_streaming_service.py`` and the
shard-count cases of ``tests/test_sharded_service.py`` and
``tests/test_placement.py``, run through the port's ``StreamingTuner`` on
the CPU: however runs reach the lanes — one batch, shuffled mid-episode
submits, reversed bursts, one shard or two, a preempted run resumed on its
home shard — every streamed Outcome's pinned fields (JSON of
``outcome_to_dict``, ``spend_trajectory`` included) equal, byte for byte,
those the JAX package's sequential oracle ``repro.core.run_queue`` gives
for the same request.  The oracle runs once per module and setting, over
the pool of every request the module streams; each module holds the
cases of as few JAX settings as it can, since every test process compiles
each setting it runs.  The helpers here serve the other
``test_torch_service_*`` files too.
"""

import json
import time

import pytest
import torch

from repro.core import RunRequest as JRunRequest
from repro.core import Settings as JSettings
from repro.core import run_queue as jax_run_queue
from repro.jobs.synthetic import synthetic_job as jax_synthetic_job
from repro.obs.forensics import outcome_to_dict as jax_outcome_to_dict
from repro_torch.core import RunRequest, Settings, run_queue_batched
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs import validate_lifecycle, validate_trace
from repro_torch.obs.forensics import diff_outcomes, outcome_to_dict
from repro_torch.service import ServiceConfig, StreamingTuner, TuningTicket

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

CPU = "cpu"
CFG = ServiceConfig(lane_slots=3, queue_capacity=4, step_quota=8)


# --------------------------------------------------------------------------- #
# Shared helpers (the other service test files import them)
# --------------------------------------------------------------------------- #
def syn_jobs(make, n=3):
    return [make(i, name=f"syn{i}") for i in range(n)]


def geometry_jobs(make):
    """The three jobs of pairwise-distinct [M, F, T] geometries of
    ``tests/test_batched_harness._distinct_geometry_jobs``."""
    return [make(0, n_a=6, n_b=4, name="g24"),
            make(1, n_a=5, n_b=3, name="g15"),
            make(2, n_a=4, n_b=8, name="g32")]


def pinned(outcome) -> str:
    return json.dumps(outcome_to_dict(outcome), sort_keys=True)


class JaxOracle:
    """The JAX package's ``run_queue`` over a pool of requests, each
    ``(job index, seed, budget_b)``, under one setting: the pinned JSON of
    each request's Outcome, computed once."""

    def __init__(self, fleet, plans, **settings):
        self.settings = settings
        jobs = fleet(jax_synthetic_job)
        pool = sorted(set(plans))
        outs = jax_run_queue([JRunRequest(jobs[j], seed=sd, budget_b=b)
                              for j, sd, b in pool], JSettings(**settings))
        self.outcomes = dict(zip(pool, outs))
        self.want = {k: json.dumps(jax_outcome_to_dict(o), sort_keys=True)
                     for k, o in self.outcomes.items()}

    def check(self, plans, outs) -> None:
        """``outs[i]`` is the port's Outcome of ``plans[i]``."""
        assert len(plans) == len(outs)
        bad = [i for i, (p, o) in enumerate(zip(plans, outs))
               if pinned(o) != self.want[p]]
        assert not bad, diff_outcomes([self.outcomes[plans[i]] for i in bad],
                                      [outs[i] for i in bad])


def requests(jobs, plans):
    return [RunRequest(jobs[j], seed=sd, budget_b=b) for j, sd, b in plans]


def stream(jobs, settings, reqs, arrival, config=CFG):
    """Drive one CPU service through an arrival schedule; outcomes return
    in request order regardless of how they arrived."""
    svc = StreamingTuner(jobs, settings, config, device=CPU)
    tickets: dict[int, TuningTicket] = {}
    for batch in arrival:
        for r in batch:
            tickets[r] = svc.submit(reqs[r])
        svc.pump()                      # later batches land mid-episode
    svc.drain()
    return [tickets[r].result() for r in range(len(reqs))]


def serve(jobs, settings, reqs, num_shards, arrival=None, **cfg_kw):
    """Drive one traced CPU service on ``num_shards`` shards; returns the
    service and the outcomes in request order."""
    cfg_kw.setdefault("lane_slots", 2)
    cfg_kw.setdefault("queue_capacity", 3)
    cfg_kw.setdefault("step_quota", 8)
    cfg = ServiceConfig(num_shards=num_shards, trace=True, **cfg_kw)
    svc = StreamingTuner(jobs, settings, cfg, device=CPU)
    tickets = {}
    for batch in arrival or [list(range(len(reqs)))]:
        for r in batch:
            tickets[r] = svc.submit(reqs[r])
        svc.pump()                      # later batches land mid-episode
    svc.drain()
    return svc, [tickets[r].result() for r in range(len(reqs))]


def plan_two_jobs(n=7, seed0=300):
    """The reference's ``_requests``: two jobs, every third run long."""
    return [(r % 2, seed0 + r, 5.0 if r % 3 == 0 else 1.5)
            for r in range(n)]


LA1 = dict(policy="lynceus", la=1, k_gh=2, refit="frozen")
LA0 = dict(policy="la0", la=0, k_gh=2)


def check_arrival_orders(timeout, oracle):
    """Three arrival orders (single batch, shuffled mid-episode submits,
    reversed bursts) of ``plan_two_jobs`` against the JAX oracle."""
    jobs = syn_jobs(synthetic_job)
    s = Settings(timeout=timeout, **LA1)
    plans = plan_two_jobs()
    if timeout:
        assert any(oracle.outcomes[p].censored for p in plans)
    for arrival in ([[0, 1, 2, 3, 4, 5, 6]],
                    [[3, 0, 6], [2, 5], [1, 4]],
                    [[6, 5], [4, 3], [2, 1], [0]]):
        oracle.check(plans, stream(jobs, s, requests(jobs, plans), arrival))


_INVARIANCE = [(r % 2, 410 + r, 5.0 if r % 3 == 0 else 1.5)
               for r in range(9)]
# test_placement.py's preempted victim and its followers
_STICKY = [(0, 320, 5.0)] + [(r % 2, 320 + r, 1.5) for r in range(1, 5)]


@pytest.fixture(scope="module")
def la1_oracle():
    """LA1 with timeout off, over every request this module streams
    (timeout on is ``test_torch_service_lifecycle.py``'s setting)."""
    return JaxOracle(syn_jobs, plan_two_jobs() + _INVARIANCE + _STICKY,
                     timeout=False, **LA1)


# --------------------------------------------------------------------------- #
# Arrival order
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("timeout", [False])
def test_arrival_order_invariance(timeout, la1_oracle):
    """Three arrival orders against the JAX oracle, timeout censoring off
    (on: ``test_torch_service_lifecycle.py``)."""
    check_arrival_orders(timeout, la1_oracle)


# --------------------------------------------------------------------------- #
# Shard count (``tests/test_sharded_service.py``, ``test_placement.py``)
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("num_shards", [1, 2])
def test_shard_count_invariance(num_shards, la1_oracle):
    jobs = syn_jobs(synthetic_job)
    svc, outs = serve(jobs, Settings(timeout=False, **LA1),
                       requests(jobs, _INVARIANCE), num_shards,
                       arrival=[[3, 0, 6], [2, 5, 8], [1, 4, 7]])
    la1_oracle.check(_INVARIANCE, outs)
    events = svc.flight_record()
    assert validate_trace(events) == []
    assert validate_lifecycle(events, require_terminal=True) == []
    if num_shards == 2:
        assert {e.data["shard"] for e in events if e.kind == "dispatch"} \
            == {0, 1}


def test_sticky_affinity_survives_preempt_and_resume(la1_oracle):
    """A preempted ticket re-queues to its home shard and resumes there;
    its final Outcome equals the uninterrupted oracle's."""
    jobs = syn_jobs(synthetic_job)
    reqs = requests(jobs, _STICKY)
    svc = StreamingTuner(jobs, Settings(timeout=False, **LA1),
                         ServiceConfig(lane_slots=1, queue_capacity=3,
                                       step_quota=3, high_water=0,
                                       num_shards=2, trace=True),
                         device=CPU)
    victim = svc.submit(reqs[0], priority=5)
    svc.pump()                           # seats the low-prio victim
    tickets = [victim] + [svc.submit(q) for q in reqs[1:]]
    svc.pump()
    svc.drain()
    assert victim.preemptions >= 1
    la1_oracle.check(_STICKY, [t.result() for t in tickets])
    events = svc.flight_record()
    assert {e.data["shard"] for e in events
            if e.ticket == victim.id and "shard" in e.data} == {victim.shard}
    resumes = [e for e in events if e.kind == "resume"
               and e.ticket == victim.id]
    assert resumes and all(e.data["shard"] == victim.shard
                           for e in resumes)
    assert validate_lifecycle(events, require_terminal=True) == []


def test_streamed_matches_compact_batch():
    """The service and the port's one-shot compacting entry drain the same
    queue to identical outcomes (they share the segment by construction)."""
    jobs = syn_jobs(synthetic_job)
    s = Settings(**LA0)
    reqs = requests(jobs, [(r % 3, 900 + r, 5.0 if r % 3 == 0 else 1.5)
                           for r in range(8)])
    bat = run_queue_batched(reqs, s, lane_slots=3, device=CPU)
    outs = stream(jobs, s, reqs, [[2, 7, 0], [5, 1], [3, 6, 4]])
    assert [pinned(o) for o in outs] == [pinned(o) for o in bat]


def test_unregistered_job_and_rnd_rejected():
    jobs = syn_jobs(synthetic_job, 2)
    svc = StreamingTuner(jobs, Settings(policy="la0", k_gh=2), CFG,
                         device=CPU)
    with pytest.raises(ValueError, match="not registered"):
        svc.submit(job=synthetic_job(9, name="stranger"), seed=1)
    with pytest.raises(ValueError, match="rnd"):
        StreamingTuner(jobs, Settings(policy="rnd"), CFG, device=CPU)


def test_config_validation():
    with pytest.raises(ValueError, match="lane_slots"):
        ServiceConfig(lane_slots=0)
    with pytest.raises(ValueError, match="step_quota"):
        ServiceConfig(step_quota=0)
    with pytest.raises(ValueError, match="max_pending"):
        ServiceConfig(max_pending=0)
    with pytest.raises(ValueError, match="bucket"):
        ServiceConfig(bucket=(16, 2))
    with pytest.raises(ValueError, match="bucket"):
        ServiceConfig(bucket=(16, 0, 4))
    with pytest.raises(ValueError, match="high_water"):
        ServiceConfig(high_water=-1)
    with pytest.raises(ValueError, match="aging_rate"):
        ServiceConfig(aging_rate=-0.5)
    with pytest.raises(ValueError, match="deadline_policy"):
        ServiceConfig(deadline_policy="defer")
    with pytest.raises(ValueError, match="trace_profiler requires"):
        ServiceConfig(trace_profiler=True)
    with pytest.raises(ValueError, match="num_shards"):
        ServiceConfig(num_shards=0)
    with pytest.raises(ValueError, match="placement_policy"):
        ServiceConfig(placement_policy="hash")
    assert ServiceConfig(lane_slots=4, queue_capacity=2,
                         low_water=None).resolved_low_water() == 2


def test_config_fields_match_the_reference():
    """Same fields, defaults and low-water resolution as the JAX
    package's ``ServiceConfig``."""
    import dataclasses

    from repro.service import ServiceConfig as JServiceConfig
    mine = {f.name: f.default for f in dataclasses.fields(ServiceConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JServiceConfig)}
    assert mine == ref
    for kw in ({}, dict(lane_slots=5, queue_capacity=3),
               dict(low_water=0), dict(low_water=7, queue_capacity=4)):
        assert (ServiceConfig(**kw).resolved_low_water()
                == JServiceConfig(**kw).resolved_low_water())


def test_bootstrap_prefix_respected():
    """Submitted runs replay the seed-derived bootstrap the oracle uses,
    and explicit bootstraps are honored."""
    job = synthetic_job(2)
    s = Settings(**LA0)
    cfg = ServiceConfig(lane_slots=1, queue_capacity=1, step_quota=64)
    req = RunRequest(job, seed=77, budget_b=1.5)
    out = StreamingTuner([job], s, cfg, device=CPU).submit(req).result()
    boot = tuple(int(i) for i in req.resolved_bootstrap())
    assert out.explored[:len(boot)] == boot
    explicit = (3, 5, 1)
    out = StreamingTuner([job], s, cfg, device=CPU).submit(
        RunRequest(job, seed=77, budget_b=1.5,
                   bootstrap=list(explicit))).result()
    assert out.explored[:3] == explicit


def test_default_device_is_the_card():
    """Without ``device=`` the service runs on the card: here, with no
    card, it raises instead of falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingTuner(syn_jobs(synthetic_job, 1), Settings(**LA0), CFG)


def test_submit_accepts_fields_and_times_out():
    """``submit(job=, seed=)`` builds the request; a zero-second wait on an
    unresolved ticket raises TimeoutError and leaves it drivable."""
    jobs = syn_jobs(synthetic_job, 1)
    svc = StreamingTuner(jobs, Settings(**LA0), CFG, device=CPU)
    t = svc.submit(job=jobs[0], seed=5, budget_b=1.5)
    with pytest.raises(ValueError, match="RunRequest"):
        svc.submit(job=jobs[0])
    start = time.perf_counter()
    with pytest.raises(TimeoutError):
        t.result(timeout=0)
    assert time.perf_counter() - start < 5.0
    assert t.state == "pending"
    svc.drain()
    assert t.state == "done"
