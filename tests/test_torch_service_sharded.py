"""The port's sharded streaming service against the JAX package
(``tests/test_sharded_service.py``, ``tests/test_placement.py``).

Sticky placement (no cross-shard leakage, in the trace and in the
engines), per-shard metrics balancing to the aggregate, every resident
tensor on its engine's device, the modulo device mapping of
``placement.shard_devices`` (with a stubbed card count), one segment
program geometry per (geometry, shard device), and the placement policies
held equal to the reference's.  Shard-count invariance and sticky
preempt-and-resume against the JAX oracle live in
``test_torch_service.py``, whose oracle runs their setting already (each
JAX setting compiles once a test process).
"""

import pytest
import torch

from repro.service.placement import choose_shard as jax_choose_shard
from repro_torch.core import Settings, episode_cache_size
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs import validate_lifecycle, validate_trace
from repro_torch.service import QueueFull, ServiceConfig, StreamingTuner
from repro_torch.service.placement import (PLACEMENT_POLICIES, choose_shard,
                                           shard_devices)
from tests.test_torch_service import (CPU, LA0, geometry_jobs, pinned,
                                      requests, serve, syn_jobs)

torch.set_num_threads(1)

_BUCKETED = [(r % 3, 230 + r, 1.5) for r in range(6)]


def test_shard_count_invariance_bucketed():
    """The geometry-bucketed program on 2 shards: the same outcomes as on
    one shard (the mixed-geometry fleet is held against the JAX oracle in
    ``test_torch_service_geometry.py``)."""
    jobs = geometry_jobs(synthetic_job)
    s = Settings(**LA0)
    reqs = requests(jobs, _BUCKETED)
    _, one = serve(jobs, s, reqs, 1, arrival=[[5, 0, 3], [1, 4, 2]])
    _, two = serve(jobs, s, reqs, 2, arrival=[[5, 0, 3], [1, 4, 2]])
    assert [pinned(o) for o in two] == [pinned(o) for o in one]


def test_no_cross_shard_leakage_and_metrics_balance():
    jobs = syn_jobs(synthetic_job)
    reqs = requests(jobs, [(r % 2, 640 + r, 1.5) for r in range(10)])
    svc, _ = serve(jobs, Settings(**LA0), reqs, 2,
                    arrival=[[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]])
    events = svc.flight_record()
    assert validate_trace(events) == []
    assert validate_lifecycle(events, require_terminal=True) == []
    shards_of: dict[int, set] = {}
    for e in events:
        sh = e.data.get("shard")
        if e.ticket is not None and sh is not None:
            shards_of.setdefault(e.ticket, set()).add(sh)
    assert len(shards_of) == len(reqs)
    assert all(len(seen) == 1 for seen in shards_of.values())
    assert {next(iter(seen)) for seen in shards_of.values()} == {0, 1}
    per = svc.shard_metrics()
    agg = svc.metrics()
    assert all(m.submitted > 0 and m.resolved == m.submitted for m in per)
    for f in ("submitted", "resolved", "steps", "segments",
              "busy_slot_steps", "explorations"):
        assert sum(getattr(m, f) for m in per) == getattr(agg, f), f
    assert agg.submitted == agg.resolved == len(reqs)
    assert agg.outstanding == 0


def test_resident_tensors_on_each_engines_device():
    """Every resident tensor of every shard — slot carry, space, tables —
    lies on its engine's device; one shard is on the service's device."""
    jobs = syn_jobs(synthetic_job)
    svc = StreamingTuner(jobs, Settings(**LA0),
                         ServiceConfig(lane_slots=2, queue_capacity=2,
                                       step_quota=6, num_shards=3),
                         device=CPU)
    for d, eng in enumerate(svc._engines.shards):
        assert eng.shard_id == d and eng.device == torch.device("cpu")
        tensors = (list(eng._carry.values()) + list(eng._space)
                   + [eng._cost, eng._runtime, eng._u, eng._tmax])
        for t in tensors:
            if isinstance(t, torch.Tensor):
                assert t.device == eng.device
    one = StreamingTuner(jobs, Settings(**LA0), ServiceConfig(lane_slots=2),
                         device=CPU)
    assert [e.device for e in one._engines.shards] == [torch.device("cpu")]


def test_shard_devices_modulo_mapping(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert shard_devices(5, "cuda") == [torch.device("cuda", d)
                                        for d in (0, 1, 2, 0, 1)]
    assert shard_devices(2, "cuda:1") == [torch.device("cuda", 0),
                                          torch.device("cuda", 1)]
    assert shard_devices(4, "cpu") == [torch.device("cpu")] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        shard_devices(2, "cuda")
    with pytest.raises(ValueError):
        shard_devices(0, "cpu")


def test_one_program_geometry_per_shard_device():
    """The episode program cache keys on the device: 2 shards that share
    the CPU add one geometry, and repeat traffic on a fresh service adds
    none."""
    jobs = syn_jobs(synthetic_job)
    # Unique (lane_slots, queue_capacity) so no other test's geometries
    # alias this one's.
    kw = dict(lane_slots=4, queue_capacity=5, step_quota=9)
    s = Settings(**LA0)
    base = episode_cache_size()
    serve(jobs, s, requests(jobs, [(r % 2, 620 + r, 1.5)
                                    for r in range(6)]), 2, **kw)
    assert episode_cache_size() - base == 1
    base = episode_cache_size()
    serve(jobs, s, requests(jobs, [(r % 2, 780 + r, 1.5)
                                    for r in range(6)]), 2, **kw)
    assert episode_cache_size() - base == 0


@pytest.mark.parametrize("policy", PLACEMENT_POLICIES)
def test_choose_shard_matches_the_reference(policy):
    cases = [([3, 1, 2], None, 0), ([2, 1, 1], None, 0), ([0, 0, 0], None, 4),
             ([5, 0], None, 1), ([5, 0, 0], None, 7), ([9, 0], 0, 3),
             ([7], None, 2)]
    for loads, home, rr in cases:
        assert (choose_shard(policy, loads, home=home, rr=rr)
                == jax_choose_shard(policy, loads, home=home, rr=rr))
    with pytest.raises(ValueError, match="out of range"):
        choose_shard(policy, [1, 1], home=2)
    with pytest.raises(ValueError):
        choose_shard(policy, [])
    with pytest.raises(ValueError, match="unknown placement_policy"):
        choose_shard("hash", [1, 2])


def test_broker_placement_policies_and_service_wide_backpressure():
    jobs = syn_jobs(synthetic_job)
    s = Settings(**LA0)
    svc = StreamingTuner(jobs, s, ServiceConfig(
        lane_slots=2, queue_capacity=2, step_quota=6, num_shards=2),
        device=CPU)
    tickets = [svc.submit(q) for q in requests(
        jobs, [(r % 2, 130 + r, 1.5) for r in range(6)])]
    assert [t.shard for t in tickets] == [0, 1, 0, 1, 0, 1]
    svc.drain()
    svc = StreamingTuner(jobs, s, ServiceConfig(
        lane_slots=2, queue_capacity=2, step_quota=6, num_shards=3,
        placement_policy="round_robin", max_pending=4), device=CPU)
    reqs = requests(jobs, [(r % 2, 200 + r, 1.5) for r in range(6)])
    tickets = [svc.submit(q) for q in reqs[:4]]
    assert [t.shard for t in tickets] == [0, 1, 2, 0]
    with pytest.raises(QueueFull):
        svc.submit(reqs[4], block=False)
    svc.drain()
    assert svc.metrics().resolved == 4
