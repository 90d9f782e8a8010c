"""The port's mixed queues against the JAX package's and the port's own
sequential oracle: ``tests/test_batched_harness.py``'s
``test_mixed_job_queue_matches_sequential`` and
``test_mixed_geometry_queue_matches_sequential`` queues, pinned fields byte
for byte.

The port runs every slot count of the reference's test against its own
oracle; the JAX package runs one slot count each (each of its slot counts
is another compiled program, and its own suite holds them equal).
"""

import json

import pytest
import torch

from repro.core import RunRequest as JRunRequest
from repro.core import Settings as JSettings
from repro.core import run_queue_batched as jax_run_queue_batched
from repro.jobs.synthetic import synthetic_job as jax_synthetic_job
from repro.obs.forensics import outcome_to_dict as jax_outcome_to_dict
from repro_torch.core import (RunRequest, Settings, episode_cache_size,
                              run_queue, run_queue_batched)
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs.forensics import diff_outcomes, outcome_to_dict

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)


def _pinned(outcomes, to_dict):
    return json.dumps([to_dict(o) for o in outcomes], sort_keys=True)


def _plan(seed0, long_b, short_b, n):
    """(job index, seed, budget_b) of each request: every third request on
    job 0 with the long budget."""
    return [(r % 3, seed0 + r, long_b if r % 3 == 0 else short_b)
            for r in range(n)]


@pytest.mark.parametrize("timeout", [False, True])
def test_mixed_job_queue_matches_sequential(timeout):
    """A mixed-job, mixed-budget queue (per-slot prices and SLOs) drains to
    each request's oracle Outcome, in request order, at 2 and 8 slots."""
    kw = dict(policy="lynceus", la=1, k_gh=2, refit="frozen",
              timeout=timeout)
    plan = _plan(100, 5.0, 1.5, 8)
    jjobs = [jax_synthetic_job(i, name=f"syn{i}") for i in range(3)]
    want = jax_run_queue_batched(
        [JRunRequest(jjobs[j], seed=sd, budget_b=b) for j, sd, b in plan],
        JSettings(**kw), lane_slots=2)
    jobs = [synthetic_job(i, name=f"syn{i}") for i in range(3)]
    reqs = [RunRequest(jobs[j], seed=sd, budget_b=b) for j, sd, b in plan]
    s = Settings(**kw)
    seq = run_queue(reqs, s, device="cpu")
    assert [o.job for o in seq] == [q.job.name for q in reqs]
    for slots in (2, 8):
        bat = run_queue_batched(reqs, s, lane_slots=slots, device="cpu")
        assert diff_outcomes(seq, bat) == [], slots
        assert _pinned(bat, outcome_to_dict) == _pinned(
            want, jax_outcome_to_dict), slots


def _geometries(make):
    return [make(0, n_a=6, n_b=4, name="g24"),
            make(1, n_a=5, n_b=3, name="g15"),
            make(2, n_a=4, n_b=8, name="g32")]


@pytest.mark.parametrize("timeout", [False, True])
def test_mixed_geometry_queue_matches_sequential(timeout):
    """Three jobs of distinct [M, F, T] geometries, padded into one bucket:
    one program geometry, each run's oracle Outcome at 2 and 5 slots."""
    kw = dict(policy="lynceus", la=1, k_gh=2, refit="frozen",
              timeout=timeout)
    plan = _plan(700, 4.0, 1.5, 7)
    jjobs = _geometries(jax_synthetic_job)
    want = jax_run_queue_batched(
        [JRunRequest(jjobs[j], seed=sd, budget_b=b) for j, sd, b in plan],
        JSettings(**kw), lane_slots=2)
    jobs = _geometries(synthetic_job)
    assert len({j.space.geometry for j in jobs}) == 3
    reqs = [RunRequest(jobs[j], seed=sd, budget_b=b) for j, sd, b in plan]
    s = Settings(**kw)
    seq = run_queue(reqs, s, device="cpu")
    if timeout:
        assert any(o.censored for o in seq)
    for slots in (2, 5):
        before = episode_cache_size()
        bat = run_queue_batched(reqs, s, lane_slots=slots, device="cpu")
        assert episode_cache_size() - before == 1
        assert diff_outcomes(seq, bat) == [], slots
        assert _pinned(bat, outcome_to_dict) == _pinned(
            want, jax_outcome_to_dict), slots
