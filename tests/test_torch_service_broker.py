"""The port's streaming broker against the JAX package: priorities,
backpressure, the background worker, step quotas, metrics, and the request
lifecycle (cancellation, failures, deadlines, aging, thread safety).

The broker cases of ``tests/test_streaming_service.py`` (``:84``-``:290``,
``:386``-``:585``) on the port's ``StreamingTuner`` on the CPU, each
resolved run held byte for byte against the JAX package's ``run_queue``
(one oracle run over the module's pool of la0 requests).  Last, one
lifecycle schedule runs through both packages' services, and their
per-ticket event sequences must be the same.
"""

import threading
import time

import numpy as np
import pytest
import torch

from repro.core import Settings as JSettings
from repro.core import RunRequest as JRunRequest
from repro.jobs.synthetic import synthetic_job as jax_synthetic_job
from repro.service import ServiceConfig as JServiceConfig
from repro.service import StreamingTuner as JStreamingTuner
from repro_torch.core import RunRequest, Settings
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs import validate_lifecycle, validate_trace
from repro_torch.service import (DeadlineUnmeetable, QueueFull,
                                 ServiceConfig, StreamingTuner,
                                 TicketCancelled)
from tests.test_torch_service import (CFG, CPU, LA0, JaxOracle, requests,
                                      stream, syn_jobs)

torch.set_num_threads(1)

# Every la0 request this module streams.
_LA0_PLANS = {
    "single": [(1, 50 + r, 1.5) for r in range(4)],
    "bucket": [(1, 60 + r, 1.5) for r in range(4)],
    "priorities": [(r % 2, 700 + r, 5.0 if r % 3 == 0 else 1.5)
                   for r in range(6)],
    "backpressure": [(r % 2, 810 + r, 5.0 if r % 3 == 0 else 1.5)
                     for r in range(5)],
    "worker": [(r % 2, 610 + r, 5.0 if r % 3 == 0 else 1.5)
               for r in range(4)],
    "quota": [(r % 2, 420 + r, 5.0 if r % 3 == 0 else 1.5)
              for r in range(6)],
    "restage": [(r % 2, 222 + r, 5.0 if r % 3 == 0 else 1.5)
                for r in range(3)],
    # test_broker_thread_safety_stress: worker w's i-th submit
    "stress": [((w + i) % 2, 1000 + w * 10 + i, 1.5)
               for w in range(4) for i in range(6)],
    "schedule": [(r % 2, 1200 + r, 8.0 if r < 2 else 1.5)
                 for r in range(6)],
}


@pytest.fixture(scope="module")
def la0_oracle():
    return JaxOracle(syn_jobs, [p for ps in _LA0_PLANS.values()
                                for p in ps], **LA0)


def test_single_job_service(la0_oracle):
    """One registered job keeps the shared-[M] selector geometry."""
    job = synthetic_job(1, name="syn1")
    plans = _LA0_PLANS["single"]
    reqs = requests({1: job}, plans)
    outs = stream([job], Settings(**LA0), reqs, [[1, 0], [3, 2]],
                  ServiceConfig(lane_slots=2, queue_capacity=2,
                                step_quota=6))
    la0_oracle.check(plans, outs)


def test_explicit_bucket_covers_future_registrations(la0_oracle):
    """``config.bucket`` pads even a single geometry and the runs stay
    oracle-exact; a bucket narrower than the job is rejected eagerly."""
    job = synthetic_job(1, name="syn1")
    plans = _LA0_PLANS["bucket"]
    s = Settings(**LA0)
    outs = stream([job], s, requests({1: job}, plans), [[1, 0], [3, 2]],
                  ServiceConfig(lane_slots=2, queue_capacity=2,
                                step_quota=6, bucket=(32, 3, 6)))
    la0_oracle.check(plans, outs)
    with pytest.raises(ValueError, match="bucket"):
        StreamingTuner([job], s, ServiceConfig(bucket=(8, 2, 5)),
                       device=CPU)


def test_priorities_reorder_seating_not_outcomes(la0_oracle):
    """Priorities decide when a run is seated, never what it computes; a
    high-priority latecomer overtakes the backlog."""
    jobs = syn_jobs(synthetic_job)
    plans = _LA0_PLANS["priorities"]
    reqs = requests(jobs, plans)
    svc = StreamingTuner(jobs, Settings(**LA0),
                         ServiceConfig(lane_slots=2, queue_capacity=2,
                                       step_quota=6), device=CPU)
    tickets = [svc.submit(q, priority=len(reqs) - r)
               for r, q in enumerate(reqs[:-1])]
    urgent = svc.submit(reqs[-1], priority=-1)
    svc.pump()
    assert urgent.done() or svc._engine._slot_tickets.count(urgent) == 1
    svc.drain()
    la0_oracle.check(plans, [t.result() for t in tickets + [urgent]])


def test_backpressure_max_pending(la0_oracle):
    jobs = syn_jobs(synthetic_job)
    plans = _LA0_PLANS["backpressure"]
    reqs = requests(jobs, plans)
    svc = StreamingTuner(jobs, Settings(**LA0),
                         ServiceConfig(lane_slots=2, queue_capacity=2,
                                       step_quota=32, max_pending=2),
                         device=CPU)
    t0 = svc.submit(reqs[0])
    t1 = svc.submit(reqs[1])
    with pytest.raises(QueueFull):
        svc.submit(reqs[2], block=False)
    # block=True makes room by pumping inline (no worker running).
    t2 = svc.submit(reqs[2], block=True)
    assert t0.done() or t1.done()
    rest = [svc.submit(q) for q in reqs[3:]]
    svc.drain()
    la0_oracle.check(plans, [t.result() for t in [t0, t1, t2] + rest])


def test_background_worker_resolves_futures(la0_oracle):
    jobs = syn_jobs(synthetic_job)
    plans = _LA0_PLANS["worker"]
    with StreamingTuner(jobs, Settings(**LA0), CFG,
                        device=CPU).start() as svc:
        tickets = [svc.submit(q) for q in requests(jobs, plans)]
        outs = [t.result(timeout=300) for t in tickets]
        assert svc.drain(timeout=300) is not None
    assert svc.outstanding == 0
    la0_oracle.check(plans, outs)


def test_step_quota_bounds_segments(la0_oracle):
    jobs = syn_jobs(synthetic_job)
    plans = _LA0_PLANS["quota"]
    svc = StreamingTuner(jobs, Settings(**LA0),
                         ServiceConfig(lane_slots=2, queue_capacity=4,
                                       step_quota=3), device=CPU)
    tickets = [svc.submit(q) for q in requests(jobs, plans)]
    svc.drain()
    m = svc.metrics()
    assert m.segments >= 2                    # quota forced multiple slices
    assert m.steps <= m.segments * 3
    la0_oracle.check(plans, [t.result() for t in tickets])


def test_metrics_accounting():
    jobs = syn_jobs(synthetic_job)
    svc = StreamingTuner(jobs, Settings(**LA0), CFG, device=CPU)
    tickets = [svc.submit(q) for q in requests(
        jobs, [(r % 2, 530 + r, 1.5) for r in range(5)])]
    outs = svc.drain()
    m = svc.metrics()
    assert m.submitted == m.resolved == len(tickets)
    assert m.outstanding == 0
    assert 0.0 < m.lane_occupancy <= 1.0
    assert m.busy_slot_steps <= m.steps * m.lane_slots
    assert m.explorations == sum(o.nex for o in outs)
    assert m.serve_seconds > 0 and m.runs_per_second > 0
    assert m.latency_p50_s <= m.latency_p95_s
    assert [o.explored for o in outs] == [t.result().explored
                                          for t in tickets]
    # the harvest's host reads are counted
    assert svc._engine.host_reads > 0
    svc.reset_metrics()
    assert svc.metrics().segments == 0


def test_pump_failure_restages_staged_tickets(monkeypatch, la0_oracle):
    """A segment that dies must not strand admitted tickets: unstarted
    staged tickets return to the backlog and a later pump drains them."""
    jobs = syn_jobs(synthetic_job)
    plans = _LA0_PLANS["restage"]
    svc = StreamingTuner(jobs, Settings(**LA0), CFG, device=CPU)
    tickets = [svc.submit(q) for q in requests(jobs, plans)]
    orig = svc._engine.run_segment
    calls = {"n": 0}

    def boom(staged, evict, low, quota):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device failure")
        return orig(staged, evict, low, quota)

    monkeypatch.setattr(svc._engine, "run_segment", boom)
    with pytest.raises(RuntimeError, match="transient"):
        svc.pump()
    svc.drain()                               # retry drains the restaged work
    la0_oracle.check(plans, [t.result() for t in tickets])




# --------------------------------------------------------------------------- #
# Request lifecycle
# --------------------------------------------------------------------------- #
def test_result_resolution_paths():
    """All four terminal behaviours of ``TuningTicket.result()`` — done,
    cancelled, service failure, timeout — each with its own exception."""
    jobs = syn_jobs(synthetic_job, 2)
    s = Settings(**LA0)
    svc = StreamingTuner(jobs, s, CFG, device=CPU)
    t_done = svc.submit(RunRequest(jobs[0], seed=1, budget_b=1.5))
    svc.drain()
    assert t_done.state == "done" and t_done.result() is not None
    assert t_done.cancel() is False           # resolution stands
    assert t_done.state == "done"
    t_canc = svc.submit(RunRequest(jobs[0], seed=2, budget_b=1.5))
    assert t_canc.cancel() is True
    svc.pump()
    assert t_canc.state == "cancelled"
    with pytest.raises(TicketCancelled):
        t_canc.result()
    assert t_canc.cancel() is False           # idempotent once terminal
    svc2 = StreamingTuner(jobs, s, CFG, device=CPU)
    t_slow = svc2.submit(RunRequest(jobs[0], seed=3, budget_b=1.5))
    with pytest.raises(TimeoutError):
        t_slow.result(timeout=0)
    assert t_slow.state == "pending"          # still drivable
    svc3 = StreamingTuner(jobs, s, CFG, device=CPU).start()

    def boom(*args):
        raise RuntimeError("device on fire")

    svc3._engine.run_segment = boom
    t_fail = svc3.submit(RunRequest(jobs[0], seed=4, budget_b=1.5))
    with pytest.raises(RuntimeError, match="failed"):
        t_fail.result(timeout=60)
    svc3.stop()
    assert t_fail.state == "failed"


def test_broker_thread_safety_stress(la0_oracle):
    """4 threads hammer submit()/cancel() against the background worker:
    no deadlock, every ticket reaches exactly one terminal state,
    completed tickets still match the JAX oracle, counters balance."""
    jobs = syn_jobs(synthetic_job, 2)
    results: dict[int, list] = {}
    lock = threading.Lock()
    with StreamingTuner(jobs, Settings(**LA0),
                        ServiceConfig(lane_slots=2, queue_capacity=3,
                                      step_quota=4),
                        device=CPU).start() as svc:
        def worker(w):
            rng = np.random.default_rng(w)
            tix = []
            for i in range(6):
                plan = ((w + i) % 2, 1000 + w * 10 + i, 1.5)
                t = svc.submit(requests(jobs, [plan])[0])
                tix.append((plan, t))
                if rng.random() < 0.4:
                    t.cancel()
            with lock:
                results[w] = tix
        threads = [threading.Thread(target=worker, args=(w,))
                   for w in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        svc.drain(timeout=600)
    tickets = [pt for ts in results.values() for pt in ts]
    assert len(tickets) == 24
    for _, t in tickets:
        assert t.done()
        assert not (t._cancelled and t._outcome is not None)
        assert t.state in ("done", "cancelled")
    done = [(p, t) for p, t in tickets if t.state == "done"]
    la0_oracle.check([p for p, _ in done], [t.result() for _, t in done])
    m = svc.metrics()
    assert m.submitted == 24
    assert m.resolved + m.cancelled == 24
    assert m.resolved == len(done)
    assert m.outstanding == 0
    assert svc._engine.in_flight() == 0


def test_failure_propagation_reaches_cancelled_and_outstanding():
    """A dying worker fails every outstanding ticket; tickets already
    cancelled keep their cancellation (no double resolution)."""
    jobs = syn_jobs(synthetic_job, 2)
    svc = StreamingTuner(jobs, Settings(**LA0), CFG, device=CPU)

    def boom(*args):
        raise RuntimeError("dead device")

    svc._engine.run_segment = boom
    svc.start()
    tix = [svc.submit(RunRequest(jobs[0], seed=5000 + i, budget_b=1.5))
           for i in range(4)]
    tix[0].cancel()
    with pytest.raises(RuntimeError, match="failed"):
        svc.drain(timeout=60)
    svc.stop()
    for t in tix:
        assert t.done()
        assert t.state in ("failed", "cancelled")
    assert any(t.state == "failed" for t in tix)
    with pytest.raises(RuntimeError, match="failed"):
        svc.submit(RunRequest(jobs[0], seed=5999, budget_b=1.5))


def test_deadline_validation_and_rejection():
    """``submit(deadline=...)`` validates, and under the default "reject"
    policy refuses a deadline below the observed resolution floor."""
    jobs = syn_jobs(synthetic_job, 2)
    svc = StreamingTuner(jobs, Settings(**LA0), CFG, device=CPU)
    with pytest.raises(ValueError, match="deadline"):
        svc.submit(RunRequest(jobs[0], seed=1, budget_b=1.5), deadline=0)
    t = svc.submit(RunRequest(jobs[0], seed=1, budget_b=1.5),
                   deadline=1e-9)
    svc.drain()
    assert t.state == "done"
    assert svc.metrics().slo_missed == 1
    floor = svc._metrics.latency_floor()
    assert floor is not None and floor > 0
    with pytest.raises(DeadlineUnmeetable):
        svc.submit(RunRequest(jobs[0], seed=2, budget_b=1.5),
                   deadline=floor / 1e6)
    m = svc.metrics()
    assert m.deadline_rejected == 1
    assert m.submitted == m.resolved == 1
    t2 = svc.submit(RunRequest(jobs[0], seed=2, budget_b=1.5),
                    deadline=3600.0)
    svc.drain()
    assert t2.state == "done"
    assert svc.metrics().slo_missed == 1


def test_deadline_admit_policy_counts_slo_misses():
    jobs = syn_jobs(synthetic_job, 2)
    svc = StreamingTuner(jobs, Settings(**LA0),
                         ServiceConfig(lane_slots=2, queue_capacity=2,
                                       step_quota=8,
                                       deadline_policy="admit"), device=CPU)
    svc.submit(RunRequest(jobs[0], seed=3, budget_b=1.5))
    svc.drain()
    assert svc._metrics.latency_floor() is not None
    t = svc.submit(RunRequest(jobs[0], seed=4, budget_b=1.5),
                   deadline=1e-9)
    svc.drain()
    assert t.state == "done"
    m = svc.metrics()
    assert m.slo_missed == 1 and m.deadline_rejected == 0


def test_admission_aging_and_tombstone_purge():
    """``_AdmissionBuffer``: aging lets an old low-priority ticket overtake
    fresh high-priority traffic; purge drops tombstoned tickets."""
    from repro_torch.service.broker import _AdmissionBuffer

    class Stub:
        def __init__(self, tid, priority, age=0.0):
            self.id = tid
            self.priority = priority
            self.submitted_at = time.perf_counter() - age
            self._cancel_requested = False

    buf = _AdmissionBuffer()
    old_low = Stub(1, priority=10, age=100.0)
    fresh_high = Stub(2, priority=0)
    buf.push(old_low)
    buf.push(fresh_high)
    assert [t.id for t in buf.stage(2)] == [2, 1]       # strict priority
    buf.push(old_low)
    buf.push(fresh_high)
    assert [t.id for t in buf.stage(2, aging_rate=1.0)] == [1, 2]
    a, b = Stub(3, 0), Stub(4, 1)
    buf.push(a)
    buf.push(b)
    b._cancel_requested = True
    assert [t.id for t in buf.purge_cancelled()] == [4]
    assert [t.id for t in buf.stage(4)] == [3]
    assert len(buf) == 0


# --------------------------------------------------------------------------- #
# One lifecycle schedule through both packages' services
# --------------------------------------------------------------------------- #
_KEYS = ("kind", "ticket", "slot", "segment", "shard")


def _schedule(svc, reqs):
    """2 jobs on 2 lanes: two long runs seated at low priority, then a
    burst of urgent ones (preempting a seat, high_water=0) with one
    cancelled before it is staged, then a late submit, then a drain."""
    tickets = [svc.submit(reqs[0], priority=5),
               svc.submit(reqs[1], priority=5)]
    svc.pump()
    tickets += [svc.submit(q, priority=p)
                for q, p in zip(reqs[2:5], (0, 0, 1))]
    assert tickets[3].cancel()
    svc.pump()
    tickets.append(svc.submit(reqs[5]))
    svc.drain()
    return tickets


def _per_ticket(events):
    seqs: dict[int, list] = {}
    for e in events:
        if e.ticket is None:
            continue
        d = e.to_json()
        seqs.setdefault(e.ticket, []).append(
            tuple(d.get(k) for k in _KEYS))
    return seqs


def test_one_schedule_same_events_in_both_services(la0_oracle):
    """The same schedule through the JAX package's ``StreamingTuner`` and
    the port's: each ticket's ``(kind, ticket, slot, segment, shard)``
    sequence is the same (timestamps and durations aside), and so are the
    outcomes, which equal the oracle's."""
    plans = _LA0_PLANS["schedule"]
    kw = dict(lane_slots=2, queue_capacity=3, step_quota=6, high_water=0,
              trace=True)
    jjobs = syn_jobs(jax_synthetic_job, 2)
    jsvc = JStreamingTuner(jjobs, JSettings(**LA0), JServiceConfig(**kw))
    jt = _schedule(jsvc, [JRunRequest(jjobs[j], seed=sd, budget_b=b)
                          for j, sd, b in plans])
    jobs = syn_jobs(synthetic_job, 2)
    svc = StreamingTuner(jobs, Settings(**LA0), ServiceConfig(**kw),
                         device=CPU)
    pt = _schedule(svc, requests(jobs, plans))
    assert [t.state for t in pt] == [t.state for t in jt]
    assert pt[3].state == "cancelled"
    assert svc.metrics().preempted >= 1
    assert svc.metrics().resumed >= 1
    events = svc.flight_record()
    assert validate_trace(events) == []
    assert validate_lifecycle(events, require_terminal=True) == []
    assert _per_ticket(events) == _per_ticket(jsvc.flight_record())
    done = [i for i, t in enumerate(pt) if t.state == "done"]
    la0_oracle.check([plans[i] for i in done],
                     [pt[i].result() for i in done])
