"""The port's ``ServiceMetrics`` against the JAX package's
(``tests/test_service_metrics.py``): the same sample sequence, fed to both
packages' ``MetricsRecorder``, gives the same snapshot field for field —
empty windows, single samples, window wraparound, resets taken mid-flight,
the lifetime latency floor, and shard aggregation.
"""

import dataclasses

import numpy as np
import pytest

from repro.service.metrics import MetricsRecorder as JMetricsRecorder
from repro_torch.service.metrics import MetricsRecorder, ServiceMetrics


def _feed(recs, ops):
    """Apply one op list to every recorder of ``recs``."""
    for name, *args in ops:
        if name == "reset":
            for r in recs:
                r.reset()
            continue
        for r in recs:
            getattr(r, f"record_{name}")(*args)


def _random_ops(seed: int, n: int) -> list:
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, 9))
        if k == 0:
            ops.append(("submit",))
        elif k == 1:
            ops.append(("resolve", float(rng.uniform(0.01, 2.0)),
                        int(rng.integers(1, 9))))
        elif k == 2:
            ops.append(("cancel",))
        elif k == 3:
            ops.append(("segment", int(rng.integers(1, 9)),
                        int(rng.integers(0, 17)),
                        float(rng.uniform(0.0, 0.1)),
                        int(rng.integers(0, 5))))
        elif k == 4:
            ops.append(("preempt",))
        elif k == 5:
            ops.append(("resume", int(rng.integers(1, 3))))
        elif k == 6:
            ops.append(("slo_miss",))
        elif k == 7:
            ops.append(("deadline_reject",))
        elif rng.random() < 0.1:
            ops.append(("reset",))
    return ops


_CASES = {
    "empty": (4, None, []),
    "single": (2, None, [("submit",), ("segment", 5, 7, 2.0, 3),
                         ("resolve", 0.25, 12)]),
    "wraparound": (1, 4, [op for v in (100.0, 100.0, 100.0, 1.0, 2.0, 3.0,
                                       4.0)
                          for op in (("submit",), ("resolve", v, 1))]),
    "reset_mid_flight": (1, None, [("submit",)] * 3 + [
        ("reset",), ("resolve", 0.1, 2)]),
    "floor_survives_reset": (1, None, [("submit",), ("resolve", 0.25, 3),
                                       ("reset",), ("submit",),
                                       ("resolve", 0.1, 1)]),
    "zero_wall": (2, None, [("segment", 1, 2, 0.0, 0)]),
    "p99": (1, None, [op for v in range(1, 101)
                      for op in (("submit",), ("resolve", float(v), 1))]),
    "random_a": (3, 16, _random_ops(7, 300)),
    "random_b": (2, None, _random_ops(11, 500)),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_snapshot_equals_the_reference(case):
    slots, window, ops = _CASES[case]
    kw = {} if window is None else {"latency_window": window}
    mine, ref = MetricsRecorder(slots, **kw), JMetricsRecorder(slots, **kw)
    _feed([mine, ref], ops)
    got, want = mine.snapshot(), ref.snapshot()
    assert isinstance(got, ServiceMetrics)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    assert mine.latency_floor() == ref.latency_floor()
    for f in dataclasses.fields(got):
        assert np.isfinite(getattr(got, f.name)), f.name


@pytest.mark.parametrize("shards", [1, 2, 3])
def test_aggregate_equals_the_reference(shards):
    mine = [MetricsRecorder(2 + d) for d in range(shards)]
    ref = [JMetricsRecorder(2 + d) for d in range(shards)]
    for d in range(shards):
        _feed([mine[d], ref[d]], _random_ops(100 + d, 150))
    got = MetricsRecorder.aggregate(mine)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        JMetricsRecorder.aggregate(ref))
    if shards == 1:
        assert got == mine[0].snapshot()


def test_field_names_and_validation_match_the_reference():
    from repro.service.metrics import ServiceMetrics as JServiceMetrics
    assert ([f.name for f in dataclasses.fields(ServiceMetrics)]
            == [f.name for f in dataclasses.fields(JServiceMetrics)])
    with pytest.raises(ValueError, match="latency_window"):
        MetricsRecorder(lane_slots=1, latency_window=0)
    with pytest.raises(ValueError, match="at least one"):
        MetricsRecorder.aggregate([])
