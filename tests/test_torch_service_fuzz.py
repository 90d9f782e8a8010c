"""Randomized lifecycle schedules through the port's streaming service,
bounded (``tests/test_lifecycle_fuzz.py``'s property).

No interleaving of submit / cancel / deadline / preemption / pump events
can break the service's lifecycle contract:

1. every ticket that runs to completion equals the JAX package's
   sequential oracle byte for byte, ``spend_trajectory`` included (even
   after preempt+resume);
2. every accepted cancel resolves, with a partial Outcome that is None or
   an exact prefix of its oracle;
3. every engine returns to all-idle (no slot leaks);
4. the metrics counters balance, per shard and in aggregate;
5. the flight record passes ``validate_trace`` and
   ``validate_lifecycle(require_terminal=True)`` (on two shards that
   includes sticky placement), and its full-history counts balance with
   the metrics.

The examples come from the repository's deterministic hypothesis shim
(``tests/_hypothesis_fallback.py``), each running 3 derived schedules, as
``scripts/ci.sh`` bounds the reference's fuzz; on 1 and on 2 shards.  The
fleet is the two-job one of ``test_torch_service.py`` (one space geometry,
so the JAX oracle compiles two selectors a setting).
"""

import numpy as np
import pytest
import torch

from _hypothesis_fallback import given, settings, st
from repro_torch.core import Settings
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs import validate_lifecycle, validate_trace
from repro_torch.service import ServiceConfig, StreamingTuner, TicketCancelled
from tests.test_torch_service import (CPU, LA1, JaxOracle, requests,
                                      syn_jobs)

torch.set_num_threads(1)

_SCHEDULES = 3
_PLANS = [(r % 2, 640 + r, 4.0 if r % 3 == 0 else 1.5) for r in range(8)]
_ORACLE: dict[bool, JaxOracle] = {}


def _oracle(timeout: bool) -> JaxOracle:
    """The JAX oracle of the request pool, once per setting."""
    if timeout not in _ORACLE:
        _ORACLE[timeout] = JaxOracle(syn_jobs, _PLANS, timeout=timeout,
                                     **LA1)
    return _ORACLE[timeout]


def _run_schedule(rng: np.random.Generator, timeout: bool,
                  num_shards: int) -> None:
    oracle = _oracle(timeout)
    jobs = syn_jobs(synthetic_job, 2)
    reqs = requests(jobs, _PLANS)
    cfg = ServiceConfig(
        lane_slots=2, queue_capacity=3,
        step_quota=int(rng.integers(2, 6)),
        high_water=0 if rng.random() < 0.5 else None,
        aging_rate=float(rng.choice([0.0, 1.0])),
        deadline_policy="admit", trace=True, num_shards=num_shards)
    svc = StreamingTuner(jobs, Settings(timeout=timeout, **LA1), cfg,
                         device=CPU)

    picks = rng.choice(len(reqs), size=int(rng.integers(3, 7)),
                       replace=False)
    tickets: list = []          # (request index, ticket)
    want_cancelled: list = []
    for r in picks:
        deadline = (float(rng.choice([1e-9, 60.0]))
                    if rng.random() < 0.3 else None)
        t = svc.submit(reqs[r], priority=int(rng.integers(-1, 3)),
                       deadline=deadline)
        tickets.append((int(r), t))
        if rng.random() < 0.35:  # cancel someone, maybe ourselves
            _, victim = tickets[int(rng.integers(0, len(tickets)))]
            if victim.cancel():
                want_cancelled.append(victim)
        if rng.random() < 0.5:
            svc.pump()
    outs = svc.drain()

    # 1) every ticket resolved, exactly one way; accepted cancels win
    for _, t in tickets:
        assert t.done(), f"ticket {t.id} never resolved"
        assert not (t.cancelled() and t._outcome is not None)
    for t in want_cancelled:
        assert t.state == "cancelled"

    # 2) completed == the JAX oracle, byte for byte
    done = [(r, t) for r, t in tickets if t.state == "done"]
    oracle.check([_PLANS[r] for r, _ in done], [t.result() for _, t in done])
    assert len(outs) == len(done)

    # 3) cancelled tickets: well-formed partials (prefix of the oracle)
    for r, t in tickets:
        if t.state != "cancelled":
            continue
        with pytest.raises(TicketCancelled):
            t.result()
        p = t.partial_outcome()
        if p is not None:
            full = oracle.outcomes[_PLANS[r]]
            assert 0 < p.nex <= full.nex
            assert p.explored == full.explored[:p.nex]
            assert (p.spend_trajectory
                    == full.spend_trajectory[:len(p.spend_trajectory)])

    # 4) no slot leaks on any shard; counters balance per shard and in
    #    aggregate
    for eng in svc._engines.shards:
        assert eng.in_flight() == 0
        assert not eng._carry["active"].any()
    m = svc.metrics()
    per = svc.shard_metrics()
    for ms in per:
        assert ms.submitted == ms.resolved + ms.cancelled
        assert ms.outstanding == 0
    for f in ("submitted", "resolved", "cancelled", "preempted",
              "resumed", "slo_missed", "deadline_rejected"):
        assert getattr(m, f) == sum(getattr(ms, f) for ms in per), f
    assert m.submitted == len(tickets)
    assert m.submitted == m.resolved + m.cancelled
    assert m.outstanding == 0
    assert m.resolved == len(done)
    assert m.resumed <= m.preempted

    # 5) the flight record is a valid per-ticket state machine and its
    #    full-history counts balance with the metrics
    events = svc.flight_record()
    assert validate_trace(events) == []
    assert validate_lifecycle(events, require_terminal=True) == []
    counts = svc.recorder.counts()
    assert counts.get("submit", 0) == m.submitted
    assert counts.get("resolve", 0) == m.resolved == counts.get("harvest", 0)
    assert counts.get("cancel", 0) == m.cancelled
    assert counts.get("preempt", 0) == m.preempted
    assert counts.get("resume", 0) == m.resumed
    assert counts.get("deadline_reject", 0) == m.deadline_rejected
    assert sum(e.data.get("slo_missed", False) for e in events
               if e.kind == "resolve") == m.slo_missed


@settings(max_examples=6, deadline=None)
@given(block=st.integers(0, 9), timeout=st.sampled_from([False, True]))
def test_lifecycle_schedules(block, timeout):
    for k in range(_SCHEDULES):
        _run_schedule(np.random.default_rng((block, k, int(timeout))),
                      timeout, num_shards=1)


@settings(max_examples=6, deadline=None)
@given(block=st.integers(0, 9), timeout=st.sampled_from([False, True]))
def test_lifecycle_schedules_sharded(block, timeout):
    """The same property over 2 shards: the merged shard-tagged trace
    must validate, which adds the sticky-placement check."""
    for k in range(_SCHEDULES):
        _run_schedule(np.random.default_rng((block, k, int(timeout), 2)),
                      timeout, num_shards=2)
