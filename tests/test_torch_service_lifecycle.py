"""The port's request lifecycle against the JAX package: cancellation of
unseated and seated runs, and preemption with resume, under three arrival
schedules each (``tests/test_streaming_service.py:310``); and the arrival
orders of ``test_torch_service.py`` with timeout censoring on, this
module's JAX setting.

Survivors stay byte-identical to the JAX package's sequential oracle
(``spend_trajectory`` included) whatever was cancelled or preempted around
them; a cancelled seated run's partial Outcome is an exact prefix of its
oracle; a preempted-then-resumed run's final Outcome equals the same
request run uninterrupted.
"""

import pytest
import torch

from repro_torch.core import Settings
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs import validate_lifecycle, validate_trace
from repro_torch.service import ServiceConfig, StreamingTuner, TicketCancelled
from tests.test_torch_service import (CPU, LA1, JaxOracle,
                                      check_arrival_orders, plan_two_jobs,
                                      requests, syn_jobs)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def oracle():
    return JaxOracle(syn_jobs, plan_two_jobs(), timeout=True, **LA1)


@pytest.mark.parametrize("timeout", [True])
def test_arrival_order_invariance(timeout, oracle):
    """Three arrival orders against the JAX oracle, timeout censoring on
    (off: ``test_torch_service.py``)."""
    check_arrival_orders(timeout, oracle)


@pytest.mark.parametrize("mode", ["cancel_unseated", "cancel_seated",
                                  "preempt_resume"])
def test_lifecycle_arrival_order_invariance(mode, oracle):
    jobs = syn_jobs(synthetic_job)
    s = Settings(timeout=True, **LA1)
    plans = plan_two_jobs()
    reqs = requests(jobs, plans)
    want = [oracle.outcomes[p] for p in plans]
    victim = 0                       # long-budget: survives early segments
    others = [r for r in range(len(reqs)) if r != victim]
    schedules = [[others],
                 [others[:3], others[3:]],
                 [others[4:], others[:2], others[2:4]]]
    for arrival in schedules:
        if mode == "preempt_resume":
            cfg = ServiceConfig(lane_slots=1, queue_capacity=3,
                                step_quota=3, high_water=0, trace=True)
        else:
            cfg = ServiceConfig(lane_slots=2, queue_capacity=3,
                                step_quota=2, trace=True)
        svc = StreamingTuner(jobs, s, cfg, device=CPU)
        tickets = {}
        if mode == "cancel_unseated":
            tickets[victim] = svc.submit(reqs[victim])
            assert tickets[victim].cancel()   # tombstoned before any pump
        elif mode == "cancel_seated":
            tickets[victim] = svc.submit(reqs[victim], priority=-1)
            svc.pump()                        # seats it, runs 2 steps
            assert any(t is tickets[victim]
                       for t in svc._engine._slot_tickets)
            assert tickets[victim].cancel()   # evicted at next boundary
        else:
            tickets[victim] = svc.submit(reqs[victim], priority=5)
            svc.pump()                        # seats the low-prio victim
        for batch in arrival:
            for r in batch:
                tickets[r] = svc.submit(reqs[r])
            svc.pump()
        svc.drain()
        if mode == "preempt_resume":
            oracle.check(plans, [tickets[r].result()
                                 for r in range(len(reqs))])
            assert tickets[victim].preemptions >= 1
            assert svc.metrics().preempted >= 1
            assert svc.metrics().resumed >= 1
        else:
            t = tickets[victim]
            assert t.state == "cancelled" and t.cancelled()
            with pytest.raises(TicketCancelled) as ei:
                t.result()
            partial = ei.value.partial
            if mode == "cancel_unseated":
                assert partial is None        # never ran: nothing paid for
            else:
                full = want[victim]
                assert partial is not None
                assert 0 < partial.nex < full.nex
                assert partial.explored == full.explored[:partial.nex]
                assert (partial.spend_trajectory
                        == full.spend_trajectory[
                            :len(partial.spend_trajectory)])
            oracle.check([plans[r] for r in others],
                         [tickets[r].result() for r in others])
        assert svc._engine.in_flight() == 0   # no slot leaks
        m = svc.metrics()
        assert m.submitted == m.resolved + m.cancelled
        assert m.outstanding == 0
        events = svc.flight_record()
        assert validate_trace(events) == []
        assert validate_lifecycle(events, require_terminal=True) == []
