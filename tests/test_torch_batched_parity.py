"""The port's batched harness against the JAX package's, and against its
own sequential oracle: ``tests/test_batched_harness.py``'s
``test_batched_matches_sequential_bit_exact`` queue.

For each policy the port's ``run_many_batched`` (default compacting
scheduler and slot count) must reproduce, byte for byte in
``PINNED_OUTCOME_FIELDS``, the JAX package's ``run_many_batched`` and the
port's own ``run_many`` on the same seeds.  The other queues are in
``tests/test_torch_batched_{timeout,queues,mixed}.py``.
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

POLICIES = [
    ("bo", 0, "exact"),
    ("la0", 0, "exact"),
    ("lynceus", 1, "frozen"),
    ("lynceus", 2, "frozen"),
    ("lynceus", 2, "exact"),
]


def _pinned(outcomes, to_dict):
    return json.dumps([to_dict(o) for o in outcomes], sort_keys=True)


@pytest.mark.parametrize("policy,la,refit", POLICIES)
def test_batched_matches_sequential_bit_exact(policy, la, refit):
    kw = dict(policy=policy, la=la, k_gh=2, refit=refit)
    run = dict(n_runs=6, budget_b=3.0, seed=11)
    want = jax_run_many_batched(jax_synthetic_job(3), JSettings(**kw), **run)
    job, s = synthetic_job(3), Settings(**kw)
    bat = run_many_batched(job, s, **run, device="cpu")
    assert _pinned(bat, outcome_to_dict) == _pinned(want, jax_outcome_to_dict)
    assert diff_outcomes(run_many(job, s, **run, device="cpu"), bat) == []
