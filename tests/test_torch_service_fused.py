"""The port's streaming service over the three-geometry fleet with the
exact refit through the fused selector, against the JAX package's
*unfused* sequential oracle (``tests/test_streaming_service.py:588``).

Each job's slots are selected together: one root fit and one
``select_step`` call a lookahead level (its plain version on the CPU).
Fusion must be invisible to the spend ledger: every ticket's pinned fields
equal the oracle's, byte for byte.
"""

import pytest
import torch

from repro_torch.core import Settings
from repro_torch.jobs.synthetic import synthetic_job
from tests.test_torch_service import (JaxOracle, geometry_jobs, requests,
                                      stream)
from tests.test_torch_service_geometry import _ARRIVAL, _CFG, _PLANS

torch.set_num_threads(1)

_EXACT = dict(policy="lynceus", la=1, k_gh=2, n_trees=3, depth=3,
              refit="exact")


# Timeout off: the frozen-refit file holds the fleet with it on (each
# geometry costs the JAX oracle a compile per setting).
@pytest.mark.parametrize("timeout", [False])
def test_mixed_geometry_streaming_fused_selector(timeout):
    """Exact refit through the fused selector (one root fit and one
    ``select_step`` call a lookahead level for each job's slots) against
    the JAX package's unfused oracle: fusion is invisible to the spend
    ledger."""
    oracle = JaxOracle(geometry_jobs, _PLANS, timeout=timeout,
                       fused_selector="ref", **_EXACT)
    jobs = geometry_jobs(synthetic_job)
    outs = stream(jobs, Settings(timeout=timeout, fused_selector="auto",
                                 **_EXACT),
                  requests(jobs, _PLANS), _ARRIVAL, _CFG)
    oracle.check(_PLANS, outs)
