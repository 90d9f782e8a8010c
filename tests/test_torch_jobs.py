"""The port's host substrate against the JAX package's.

Every table of ``all_jobs(seed)``, the LHS bootstrap, geometry buckets and
padded spaces, the padded device tables, the metrics and the pinned
Outcome diff: byte-equal to ``repro``'s, which the port copies rather than
imports.
"""

import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import space as jspace
from repro.jobs import synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import metrics as tmetrics
from repro_torch.core import space as tspace
from repro_torch.jobs import synthetic as tsynthetic

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_all_jobs_tables_match(seed):
    want, got = jsynthetic.all_jobs(seed), tsynthetic.all_jobs(seed)
    assert [j.name for j in want] == [j.name for j in got]
    for a, b in zip(want, got):
        for f in ("runtime", "unit_price", "cost", "feasible"):
            _same(getattr(a, f), getattr(b, f))
        for f in ("points", "points_raw", "thresholds"):
            _same(getattr(a.space, f), getattr(b.space, f))
        assert a.space.names == b.space.names
        assert (a.t_max, a.bootstrap_size(), a.budget(3.0), a.optimum_index,
                a.mean_cost) == (b.t_max, b.bootstrap_size(), b.budget(3.0),
                                 b.optimum_index, b.mean_cost)
        assert a.summary() == b.summary()
        ha, hb = a.host_view(), b.host_view()
        for x, y in zip(ha, hb):
            _same(x, y)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lhs_bootstrap_matches(seed):
    for a, b in zip(jsynthetic.all_jobs(0), tsynthetic.all_jobs(0)):
        n = a.bootstrap_size()
        _same(jspace.latin_hypercube_indices(a.space, n,
                                             np.random.default_rng(seed)),
              tspace.latin_hypercube_indices(b.space, n,
                                             np.random.default_rng(seed)))


def test_buckets_padding_and_device_view_match():
    want, got = jsynthetic.all_jobs(0), tsynthetic.all_jobs(0)
    jb = jspace.GeometryBucket.for_spaces([j.space for j in want])
    tb = tspace.GeometryBucket.for_spaces([j.space for j in got])
    assert tuple(jb.shape) == tuple(tb.shape)
    assert [tspace.next_pow2(n) for n in (1, 3, 64, 65)] == [
        jspace.next_pow2(n) for n in (1, 3, 64, 65)]
    for a, b in zip(want, got):
        pa, pb = a.space.pad_to(jb), b.space.pad_to(tb)
        for f in ("points", "thresholds", "valid"):
            _same(getattr(pa, f), getattr(pb, f))
        assert pa.geometry == pb.geometry
        va, vb = a.device_view(jb.m), b.device_view(tb.m, device="cpu")
        for x, y in zip(va, vb):
            _same(x, y.numpy())
        assert torch.isinf(vb.cost[a.space.n_points:]).all()


def test_convert_rebuilds_spaces_and_jobs():
    a = jsynthetic.scout_jobs(0)[2]
    sp = convert.space_from_numpy(a.space.names, a.space.points_raw,
                                  a.space.points, a.space.thresholds)
    job = convert.job_from_numpy(a.name, sp, a.runtime, a.unit_price,
                                 a.t_max)
    _same(job.cost, a.cost)
    assert job.optimum_index == a.optimum_index
    bucket = jspace.GeometryBucket(m=128, f=4, t=16)
    pa = a.space.pad_to(bucket)
    pb = convert.space_from_numpy(None, None, pa.points, pa.thresholds,
                                  valid=pa.valid, bucket=bucket.shape,
                                  native=sp)
    _same(pb.points, pb.native.pad_to(pb.bucket).points)
    assert pb.geometry == pa.geometry


def test_metrics_match():
    class O:
        def __init__(self, cno, nex, hit):
            self.cno, self.nex, self.found_optimum = cno, nex, hit
    outs = [O(1.0 + 0.1 * i, 10 + i, i % 3 == 0) for i in range(11)]
    assert tmetrics.cno_stats(outs) == jmetrics.cno_stats(outs)
    assert tmetrics.nex_stats(outs) == jmetrics.nex_stats(outs)
    for x, y in zip(tmetrics.cdf([3, 1, 2]), jmetrics.cdf([3, 1, 2])):
        _same(x, y)
