"""The port's sequential oracle against ``repro.core.optimizer``.

``run_many``'s ``PINNED_OUTCOME_FIELDS`` (the fields the JAX package pins
across its own backends) must be byte-identical to the JAX package's on
``synthetic_job``, for the policies lynceus / la0 / bo / rnd with the
timeout off and on; then the helpers the loop is built from.
"""

import json

import numpy as np
import pytest
import torch

from repro.core import Settings as JSettings
from repro.core import run_many as jax_run_many
from repro.jobs.synthetic import synthetic_job as jax_synthetic_job
from repro.obs.forensics import PINNED_OUTCOME_FIELDS as JAX_PINNED
from repro.obs.forensics import outcome_to_dict as jax_outcome_to_dict
from repro_torch.core import Settings, optimize, run_many
from repro_torch.core import optimizer as topt
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs.forensics import (PINNED_OUTCOME_FIELDS, diff_outcomes,
                                       outcome_to_dict)

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

SMALL = dict(la=1, k_gh=3, n_trees=4, depth=3)


def _pinned(outcomes, to_dict):
    return json.dumps([to_dict(o) for o in outcomes], sort_keys=True)


@pytest.mark.parametrize("timeout", [False, True])
@pytest.mark.parametrize("policy", ["lynceus", "la0", "bo", "rnd"])
def test_run_many_pinned_fields_match_jax(policy, timeout):
    kw = dict(SMALL, policy=policy, timeout=timeout)
    want = jax_run_many(jax_synthetic_job(1), JSettings(**kw), n_runs=3,
                        budget_b=4.0, seed=2)
    got = run_many(synthetic_job(1), Settings(**kw), n_runs=3, budget_b=4.0,
                   seed=2, device="cpu")
    assert _pinned(got, outcome_to_dict) == _pinned(want, jax_outcome_to_dict)
    assert diff_outcomes(want, got) == []


def test_pinned_field_list_matches_jax():
    assert tuple(PINNED_OUTCOME_FIELDS) == tuple(JAX_PINNED)


def test_per_run_seeds_and_budgets():
    from repro.core import optimizer as jopt
    assert topt._per_run_seeds(3, 4) == jopt._per_run_seeds(3, 4)
    assert topt._resolve_budget_b([1.0, 2.0], 2) == [1.0, 2.0]
    assert topt._resolve_budget_b(2.5, 3) == [2.5] * 3
    with pytest.raises(ValueError):
        topt._resolve_budget_b([1.0], 2)
    job, jjob = synthetic_job(0), jax_synthetic_job(0)
    seeds = topt._per_run_seeds(1, 3)
    for a, b in zip(topt._per_run_bootstraps(job, seeds),
                    jopt._per_run_bootstraps(jjob, seeds)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        topt._resolve_runs(job, 0, 2, [1, 2], [np.arange(3)])


def test_optimize_with_explicit_bootstrap_and_budget_sequence():
    job = synthetic_job(0)
    s = Settings(**dict(SMALL, policy="la0"))
    boot = np.array([0, 5, 9, 13, 20])
    a = optimize(job, s, bootstrap=boot, seed=4, device="cpu")
    assert a.explored[:5] == tuple(boot)
    assert a.nex == len(a.explored) == len(a.trajectory)
    assert a.spent <= a.budget + 1e-6
    outs = run_many(job, s, n_runs=2, budget_b=[2.0, 5.0], device="cpu")
    assert outs[0].budget < outs[1].budget
