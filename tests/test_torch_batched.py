"""The port's batched selector and harness mechanics, on the CPU.

``select_next_batched`` at R slots is bitwise equal to R selections at R =
1, for slots that share one job, slots of several jobs on one space
(per-slot prices) and slots of several geometries padded to a bucket
(per-slot spaces), fused (the selector-step kernel's plain version on CPU
tensors) and unfused; the fused program makes one ``select_step`` call a
lookahead level for each job, whatever R.  The batched root fit under R
keys equals R single fits.  Then the harness's behaviour: buckets and
their rejections, more slots than runs, ``rnd``, the program-geometry
count, one ``select_step`` call a level a step, and ``_episode_segment``
driven in bounded segments (step quota, low-water mark, eviction) against
one unbounded drain.  The queues of ``tests/test_batched_harness.py``
against the JAX package are in ``tests/test_torch_batched_*.py``.
"""

import json

import numpy as np
import pytest
import torch

from repro_torch.core import (GeometryBucket, RunRequest, Settings,
                              episode_cache_size, lookahead, optimizer, prng,
                              run_many, run_many_batched, run_queue,
                              run_queue_batched, selector_cache_size, trees)
from repro_torch.jobs.synthetic import synthetic_job
from repro_torch.obs.forensics import diff_outcomes, outcome_to_dict

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

SMALL = dict(la=2, k_gh=2, n_trees=4, depth=3)


def _pinned(outcomes):
    return json.dumps([outcome_to_dict(o) for o in outcomes], sort_keys=True)


# --------------------------------------------------------------------------- #
# The selector
# --------------------------------------------------------------------------- #
def _slot_state(jobs, m, seed, timeout):
    """R slots' state, slot r on ``jobs[r]``: a few observed configs (the
    first censored with the timeout on), its own budget and key."""
    rng = np.random.default_rng(seed)
    r_dim = len(jobs)
    y = np.zeros((r_dim, m), np.float32)
    mask = np.zeros((r_dim, m), bool)
    cens = np.zeros((r_dim, m), bool)
    for r, job in enumerate(jobs):
        idx = rng.choice(job.space.n_points, 4 + r, replace=False)
        y[r, idx] = job.cost[idx]
        mask[r, idx] = True
        cens[r, idx[0]] = timeout
    beta = np.array([job.budget(3.0) * rng.uniform(0.3, 1.0)
                     for job in jobs], np.float32)
    keys = torch.stack([prng.PRNGKey(100 + r) for r in range(r_dim)])
    return (keys, torch.as_tensor(y), torch.as_tensor(mask),
            torch.as_tensor(beta), torch.as_tensor(cens) if timeout else None)


def _layout(name):
    """(slot jobs, space tensors, u, t_max, valid, job groups) of a layout."""
    if name == "shared":
        job = synthetic_job(0)
        pts, left, thr, u = lookahead.space_arrays(job.space, job.unit_price,
                                                   "cpu")
        return [job] * 4, (pts, left, thr), u, torch.tensor(
            float(np.float32(job.t_max))), None, 1
    if name == "per_slot_price":
        jobs = [synthetic_job(i % 2, name=f"syn{i % 2}") for i in range(4)]
        pts, left, thr, _ = lookahead.space_arrays(jobs[0].space,
                                                   jobs[0].unit_price, "cpu")
        u = torch.stack([torch.as_tensor(j.unit_price.astype(np.float32))
                         for j in jobs])
        t = torch.tensor([j.t_max for j in jobs], dtype=torch.float32)
        return jobs, (pts, left, thr), u, t, None, 2
    jobs = [synthetic_job(0, n_a=6, n_b=4), synthetic_job(1, n_a=5, n_b=3)]
    jobs = [jobs[0], jobs[1], jobs[1], jobs[0]]
    bucket = GeometryBucket.for_spaces([j.space for j in jobs])
    pts, left, thr, valid = optimizer._queue_spaces(jobs, bucket, "cpu")
    u = torch.stack([j.device_view(bucket.m, device="cpu").unit_price
                     for j in jobs])
    t = torch.tensor([j.t_max for j in jobs], dtype=torch.float32)
    return jobs, (pts, left, thr), u, t, valid, 2


@pytest.mark.parametrize("timeout", [False, True])
@pytest.mark.parametrize("fused", ["auto", "ref"])
@pytest.mark.parametrize("layout", ["shared", "per_slot_price",
                                    "per_slot_space"])
def test_slots_selected_together_equal_single_selections(layout, fused,
                                                         timeout,
                                                         monkeypatch):
    jobs, space, u, t_max, valid, n_groups = _layout(layout)
    m = u.shape[-1]
    s = Settings(**SMALL, timeout=timeout, fused_selector=fused)
    keys, y, mask, beta, cens = _slot_state(jobs, m, seed=len(layout),
                                            timeout=timeout)
    calls = []
    real = lookahead.select_step
    monkeypatch.setattr(lookahead, "select_step",
                        lambda *a, **k: calls.append(a[3].shape[0])
                        or real(*a, **k))
    got = lookahead.select_next_batched(keys, y, mask, beta, *space, u, t_max,
                                        s, cens, valid)
    if fused == "auto":
        # One call a lookahead level for each job's slots, whatever R.
        assert len(calls) == (1 + s.la) * n_groups
        m_k = m * s.k_gh
        assert sorted(calls) == sorted(
            [n * f for n in (len(jobs) // n_groups,) * n_groups
             for f in (1, m_k, m_k * s.k_gh)])
    else:
        assert calls == []
    for r in range(len(jobs)):
        one = lambda a: None if a is None else a[r:r + 1]
        per = lambda a, per_slot: a[r:r + 1] if per_slot else a
        want = lookahead.select_next_batched(
            keys[r:r + 1], y[r:r + 1], mask[r:r + 1], beta[r:r + 1],
            *(per(a, layout == "per_slot_space") for a in space),
            per(u, u.dim() == 2), per(t_max, t_max.dim() == 1), s, one(cens),
            None if valid is None else valid[r:r + 1])
        assert int(got[0][r]) == int(want[0][0])
        assert bool(got[1][r]) == bool(want[1][0])
        assert set(got[2]) == set(want[2])
        for k in want[2]:
            assert got[2][k][r].numpy().tobytes() == \
                want[2][k][0].numpy().tobytes(), (r, k)


def test_select_next_batched_checks_its_inputs():
    jobs, space, u, t_max, valid, _ = _layout("per_slot_space")
    s = Settings(**SMALL)
    keys, y, mask, beta, _ = _slot_state(jobs, u.shape[-1], 0, False)
    with pytest.raises(ValueError, match="t_max"):
        lookahead.select_next_batched(keys, y, mask, beta, *space, u,
                                      t_max[0], s, None, valid)
    with pytest.raises(ValueError, match="validity"):
        lookahead.select_next_batched(keys, y, mask, beta, *space, u, t_max,
                                      s, None, None)


def test_slot_price_rows():
    u = torch.arange(6.0).reshape(2, 3)
    t = torch.tensor([1.0, 2.0])
    assert lookahead.slot_price_rows(None, None, u[0], t[0])[2] is None
    job_ids = torch.tensor([0, 0, 1, 0])
    u_l, t_l, jid = lookahead.slot_price_rows(job_ids, torch.tensor([2, 1]),
                                              u, t)
    assert jid.tolist() == [1, 0]
    assert torch.equal(u_l, u[[1, 0]]) and t_l.tolist() == [2.0, 1.0]


def test_selector_cache_size_counts_direct_geometries():
    job = synthetic_job(0)
    s = Settings(policy="la0", la=0, k_gh=2, n_trees=3, depth=2)
    sel = lookahead.make_batch_selector(job.space, job.unit_price, job.t_max,
                                        s, device="cpu")
    before = selector_cache_size()
    for r_dim in (1, 2, 2):
        keys, y, mask, beta, _ = _slot_state([job] * r_dim,
                                             job.space.n_points, 1, False)
        sel(keys, y, mask, beta)
    assert selector_cache_size() - before == 2


def _root_inputs(r_dim, seed=0):
    job = synthetic_job(2)
    pts, left, thr, _ = lookahead.space_arrays(job.space, job.unit_price,
                                               "cpu")
    keys, y, mask, _, _ = _slot_state([job] * r_dim, job.space.n_points,
                                      seed, False)
    return keys, y, mask, pts, left, thr


@pytest.mark.parametrize("n_trees,depth", [(4, 3), (10, 4)])
def test_batched_root_fit_equals_single_fits(n_trees, depth):
    """R runs' root forests fit as one batch under R keys, each with the
    bits of its fit alone."""
    keys, y, mask, pts, left, thr = _root_inputs(5)
    kw = dict(n_trees=n_trees, depth=depth, node_sums="lanes")
    got = trees.fit_forest(keys, y, mask, pts, left, thr, program_states=1,
                           **kw)
    for r in range(keys.shape[0]):
        want = trees.fit_forest(keys[r], y[r], mask[r], pts, left, thr, **kw)
        for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
            assert a[r].numpy().tobytes() == b.numpy().tobytes()


def test_batched_children_fit_equals_each_runs_fit(monkeypatch):
    """R runs' speculative states (run after run) fit under their run's
    key schedule and product shape: each run's block equals its fit alone,
    and the chunked fit equals the whole one."""
    keys, y, mask, pts, left, thr = _root_inputs(3, seed=4)
    s = Settings(**SMALL)
    per = 6
    y_b = y.repeat_interleave(per, dim=0)
    m_b = mask.repeat_interleave(per, dim=0)
    got = lookahead._fit_batch_params(keys, y_b, m_b, pts, left, thr, s)
    for r in range(3):
        want = lookahead._fit_batch_params(keys[r], y_b[r * per:(r + 1) * per],
                                           m_b[r * per:(r + 1) * per], pts,
                                           left, thr, s)
        for a, b in zip(got, want):
            assert a[r * per:(r + 1) * per].numpy().tobytes() == \
                b.numpy().tobytes()
    monkeypatch.setattr(trees, "_FIT_CHUNK_ELEMS", 1)
    chunked = lookahead._fit_batch_params(keys, y_b, m_b, pts, left, thr, s)
    for a, b in zip(got, chunked):
        assert a.numpy().tobytes() == b.numpy().tobytes()


# --------------------------------------------------------------------------- #
# The harness's behaviour
# --------------------------------------------------------------------------- #
def test_explicit_bucket_accepted_and_validated():
    """A forced bucket pads even a single-geometry queue; a bucket narrower
    than a member geometry, and a bucket under lockstep, are refused."""
    job = synthetic_job(0)                       # [24, 2, 5]
    s = Settings(policy="la0", la=0, k_gh=2)
    seq = run_many(job, s, n_runs=3, seed=21, device="cpu")
    bat = run_many_batched(job, s, n_runs=3, seed=21, bucket=(32, 3, 6),
                           device="cpu")
    assert diff_outcomes(seq, bat) == []
    with pytest.raises(ValueError, match="bucket"):
        run_queue_batched([RunRequest(job, 1)], s, bucket=(8, 2, 5),
                          device="cpu")
    with pytest.raises(ValueError, match="compact"):
        run_many_batched(job, s, n_runs=2, scheduler="lockstep",
                         bucket=(32, 3, 6), device="cpu")
    with pytest.raises(ValueError, match="scheduler"):
        run_many_batched(job, s, n_runs=2, scheduler="nope", device="cpu")


@pytest.mark.parametrize("scheduler", ["compact", "lockstep"])
def test_more_slots_than_runs(scheduler):
    job = synthetic_job(2)
    s = Settings(policy="la0", la=0, k_gh=2)
    seq = run_many(job, s, n_runs=2, seed=3, device="cpu")
    bat = run_many_batched(job, s, n_runs=2, seed=3, lane_chunk=64,
                           scheduler=scheduler, device="cpu")
    assert diff_outcomes(seq, bat) == []


def test_rnd_falls_through_to_sequential():
    job = synthetic_job(2)
    s = Settings(policy="rnd")
    seq = run_many(job, s, n_runs=4, seed=9, device="cpu")
    bat = run_many_batched(job, s, n_runs=4, seed=9, device="cpu")
    assert _pinned(seq) == _pinned(bat)
    q = [RunRequest(job, 5), RunRequest(synthetic_job(1), 6, 2.0)]
    assert _pinned(run_queue(q, s, device="cpu")) == _pinned(
        run_queue_batched(q, s, device="cpu"))
    assert run_queue_batched([], s, device="cpu") == []


def test_episode_cache_size_grows_by_one_per_bucket():
    """A queue of three geometries padded into one bucket is one program;
    draining it again adds nothing, another bucket adds one."""
    jobs = [synthetic_job(0, n_a=6, n_b=4, name="g24"),
            synthetic_job(1, n_a=5, n_b=3, name="g15"),
            synthetic_job(2, n_a=4, n_b=8, name="g32")]
    s = Settings(policy="la0", la=0, k_gh=2)
    reqs = [RunRequest(jobs[r % 3], seed=800 + r) for r in range(4)]
    before = episode_cache_size()
    run_queue_batched(reqs, s, lane_slots=2, device="cpu")
    assert episode_cache_size() - before == 1
    run_queue_batched(reqs, s, lane_slots=2, device="cpu")
    assert episode_cache_size() - before == 1
    run_queue_batched(reqs, s, lane_slots=2, bucket=(48, 2, 8), device="cpu")
    assert episode_cache_size() - before == 2


@pytest.mark.parametrize("queue", ["single", "mixed"])
def test_one_select_step_call_a_level_a_job_a_step(queue, monkeypatch):
    """The fused harness selects all of a job's slots together: each step
    makes (1 + la) ``select_step`` calls for each job seated that step."""
    s = Settings(**SMALL)
    jobs = ([synthetic_job(3)] * 2 if queue == "single"
            else [synthetic_job(i, name=f"syn{i}") for i in range(2)])
    reqs = [RunRequest(jobs[r % 2], seed=40 + r, budget_b=1.5)
            for r in range(4)]
    seq = run_queue(reqs, s, device="cpu")
    calls, groups = [], []
    real_select, real_body = lookahead.select_step, optimizer._segment_body
    monkeypatch.setattr(lookahead, "select_step",
                        lambda *a, **k: calls.append(1) or real_select(*a,
                                                                       **k))

    def body(st, queue_, qtail, grp, *a):
        groups.append(len(grp))
        return real_body(st, queue_, qtail, grp, *a)
    monkeypatch.setattr(optimizer, "_segment_body", body)
    bat = run_queue_batched(reqs, s, lane_slots=3, device="cpu")
    assert diff_outcomes(seq, bat) == []
    assert len(calls) == (1 + s.la) * sum(groups)
    if queue == "single":
        assert set(groups) == {1}
    else:
        assert max(groups) == 2


def _segment_inputs(timeout, n_runs=5, l_dim=2):
    job = synthetic_job(1)
    s = Settings(policy="lynceus", la=1, k_gh=2, n_trees=4, depth=3,
                 timeout=timeout)
    reqs = [RunRequest(job, seed=60 + r, budget_b=2.0 + r % 3)
            for r in range(n_runs)]
    pts, left, thr, u = lookahead.space_arrays(job.space, job.unit_price,
                                               "cpu")
    queue = optimizer._init_run_states(reqs, s)
    queue.pop("budgets")
    queue = {k: torch.as_tensor(v) for k, v in queue.items()
             if timeout or k not in optimizer._CARRY_TIMEOUT_KEYS}
    cost, runtime, u, t_max, _ = optimizer._queue_tables([job], u, None,
                                                         "cpu")
    tables = (None, cost, runtime, pts, left, thr, None, u, t_max, s)
    return queue, tables, l_dim, n_runs


def _segment(carry, queue, n_runs, evict=None, low_water=0,
             quota=optimizer._STEPS_UNBOUNDED, tables=None):
    l_dim = carry["y"].shape[0]
    evict = torch.zeros(l_dim, dtype=torch.bool) if evict is None else evict
    return optimizer._episode_segment(carry, queue, n_runs, evict, low_water,
                                      quota, *tables)


def _merge(total, report):
    """Fold one segment's banked rows into the running report."""
    done = report["out_done"]
    for k, v in report.items():
        if k.startswith("out_"):
            total[k] = torch.where(
                done.reshape((-1,) + (1,) * (v.dim() - 1)), v, total[k])
    return total


@pytest.mark.parametrize("timeout", [False, True])
def test_bounded_segments_equal_one_drain(timeout):
    """Segments cut by a step quota, then by a low-water mark, resume from
    the carry and bank the same rows as one unbounded drain."""
    queue, tables, l_dim, n_runs = _segment_inputs(timeout)
    seed = lambda: optimizer._seed_carry_from_queue(queue, l_dim, tables[-1])
    _, whole = _segment(seed(), queue, n_runs, tables=tables)
    assert bool(whole["out_done"][l_dim:].all())
    carry, total, steps, segments = seed(), None, 0, 0
    while True:
        bounded = segments % 2 == 0
        carry, rep = _segment(carry, queue, n_runs, tables=tables,
                              quota=3 if bounded else
                              optimizer._STEPS_UNBOUNDED,
                              low_water=0 if bounded else 2)
        total = rep if total is None else _merge(total, rep)
        steps += rep["steps"]
        segments += 1
        if rep["steps"] == 0:
            break
        # The quota binds; the low-water mark ends a segment once fewer
        # than two rows are pending.
        assert rep["steps"] <= 3 or not bounded
        if not bounded:
            pending = n_runs - int(carry["qhead"])
            assert pending < 2 or not bool(carry["active"].any())
    assert segments > 3 and steps == whole["steps"]
    for k, v in whole.items():
        if k.startswith("out_"):
            assert v.numpy().tobytes() == total[k].numpy().tobytes(), k


def test_eviction_banks_the_partial_run_and_refills_its_seat():
    queue, tables, l_dim, n_runs = _segment_inputs(True)
    carry = optimizer._seed_carry_from_queue(queue, l_dim, tables[-1])
    carry, _ = _segment(carry, queue, n_runs, quota=2, tables=tables)
    assert bool(carry["active"].all())
    rid0 = int(carry["rid"][0])
    evict = torch.tensor([True] + [False] * (l_dim - 1))
    after, rep = _segment(carry, queue, n_runs, evict=evict, quota=1,
                          tables=tables)
    assert not bool(rep["out_done"][rid0])
    for out, field in (("out_beta", "beta"), ("out_nexp", "n_exp"),
                       ("out_expl", "explored"), ("out_cexpl", "cexpl"),
                       ("out_bexpl", "bexpl")):
        assert rep[out][rid0].numpy().tobytes() == \
            carry[field][0].numpy().tobytes(), out
    # The freed seat took the next pending queue row.
    assert int(after["rid"][0]) == l_dim + int(carry["qhead"])
    assert int(after["qhead"]) >= int(carry["qhead"]) + 1
    fresh = optimizer._fresh_slot_carry(l_dim, queue["y"].shape[1],
                                        tables[-1], device="cpu")
    assert (fresh["rid"] == -1).all() and not fresh["active"].any()
