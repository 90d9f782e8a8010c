"""The port's streaming service over a fleet of three space geometries,
padded into one bucket, against the JAX package
(``tests/test_streaming_service.py:225``), with the frozen refit.

A service registering jobs of distinct [M, F, T] geometries runs one
segment program geometry and resolves every ticket, submits landing
mid-episode, to the pinned fields the JAX package's sequential oracle
``run_queue`` gives.  ``test_torch_service_fused.py`` holds the same
fleet with the exact refit through the fused selector.
"""

import pytest
import torch

from repro_torch.core import Settings, episode_cache_size
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.service import ServiceConfig
from tests.test_torch_service import (JaxOracle, geometry_jobs, requests,
                                      stream)

torch.set_num_threads(1)

_PLANS = [(r % 3, 800 + r, 4.0 if r % 3 == 0 else 1.5) for r in range(7)]
_ARRIVAL = [[3, 0, 6], [2, 5], [1, 4]]
_CFG = ServiceConfig(lane_slots=2, queue_capacity=3, step_quota=5)
_FROZEN = dict(policy="lynceus", la=1, k_gh=2, refit="frozen")


# Timeout on: the censoring path of the carry and queue (cens, cexpl,
# bexpl); the fleet with it off is held in the fused-selector file, and
# the mixed-job services in both settings in test_torch_service.py (each
# geometry costs the JAX oracle a compile per setting).
@pytest.mark.parametrize("timeout", [True])
def test_mixed_geometry_streaming_matches_oracle(timeout):
    """Frozen refit: every ticket equals its oracle Outcome bit for bit
    (censored sets included), and the fleet ran one segment geometry."""
    oracle = JaxOracle(geometry_jobs, _PLANS, timeout=timeout, **_FROZEN)
    if timeout:
        assert any(o.censored for o in oracle.outcomes.values())
    jobs = geometry_jobs(synthetic_job)
    before = episode_cache_size()
    outs = stream(jobs, Settings(timeout=timeout, **_FROZEN),
                  requests(jobs, _PLANS), _ARRIVAL, _CFG)
    oracle.check(_PLANS, outs)
    assert episode_cache_size() - before <= 1
