"""The port's two schedulers against the JAX package's and the port's own
sequential oracle: ``tests/test_batched_harness.py``'s
``test_refill_order_invariance`` and ``test_mixed_budget_parity`` queues,
pinned fields byte for byte.

The port runs every slot count of the reference's test against its own
oracle; the JAX package runs one slot count each (each of its slot counts
is another compiled program, and its own suite holds them equal).
"""

import json

import pytest
import torch

from repro.core import Settings as JSettings
from repro.core import run_many_batched as jax_run_many_batched
from repro.jobs.synthetic import synthetic_job as jax_synthetic_job
from repro.obs.forensics import outcome_to_dict as jax_outcome_to_dict
from repro_torch.core import Settings, run_many, run_many_batched
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs.forensics import diff_outcomes, outcome_to_dict

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)


def _pinned(outcomes, to_dict):
    return json.dumps([to_dict(o) for o in outcomes], sort_keys=True)


@pytest.mark.parametrize("scheduler", ["lockstep", "compact"])
@pytest.mark.parametrize("timeout", [False, True])
def test_refill_order_invariance(timeout, scheduler):
    """One run set through the oracle and a scheduler at 1, 3 and 7 slots
    (serial draining, mid-episode refills, lockstep-like occupancy)."""
    kw = dict(policy="lynceus", la=1, k_gh=3, refit="frozen",
              timeout=timeout)
    run = dict(n_runs=7, budget_b=3.0, seed=4)
    job, s = synthetic_job(0), Settings(**kw)
    seq = run_many(job, s, **run, device="cpu")
    if timeout:
        assert any(o.censored for o in seq)
    want = jax_run_many_batched(jax_synthetic_job(0), JSettings(**kw), **run,
                                lane_chunk=3, scheduler=scheduler)
    for chunk in (1, 3, 7):
        bat = run_many_batched(job, s, **run, lane_chunk=chunk,
                               scheduler=scheduler, device="cpu")
        assert diff_outcomes(seq, bat) == [], chunk
        assert _pinned(bat, outcome_to_dict) == _pinned(
            want, jax_outcome_to_dict), chunk


@pytest.mark.parametrize("scheduler", ["compact", "lockstep"])
def test_mixed_budget_parity(scheduler):
    """Per-run ``budget_b``: both schedulers reproduce the oracle, and each
    Outcome carries its own B; the compacting one also on 2 slots."""
    kw = dict(policy="la0", la=0, k_gh=2)
    budgets = [1.0, 6.0, 1.5, 8.0, 1.0]
    run = dict(n_runs=5, budget_b=budgets, seed=2)
    job, s = synthetic_job(1), Settings(**kw)
    seq = run_many(job, s, **run, device="cpu")
    assert [o.budget for o in seq] == [job.budget(b) for b in budgets]
    want = jax_run_many_batched(jax_synthetic_job(1), JSettings(**kw), **run,
                                scheduler=scheduler)
    bat = run_many_batched(job, s, **run, scheduler=scheduler, device="cpu")
    assert _pinned(bat, outcome_to_dict) == _pinned(want, jax_outcome_to_dict)
    assert diff_outcomes(seq, bat) == []
    if scheduler == "compact":
        bat = run_many_batched(job, s, **run, lane_chunk=2, device="cpu")
        assert diff_outcomes(seq, bat) == []
