"""The port's bagged-tree surrogate against ``repro.core.trees``.

``fit_forest``'s ``ForestParams`` and leaf assignment, bitwise, on the
synthetic, TensorFlow and Scout spaces over random (y, mask, key); the
batched fit over states against the reference's ``vmap``; prediction from
a JAX-fitted forest carried over with ``convert.forest_from_numpy``.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trees as jt
from repro.jobs.synthetic import scout_jobs, synthetic_job, tensorflow_jobs
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core import trees as tt

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

JOBS = {"synthetic": lambda: synthetic_job(0),
        "tf-cnn": lambda: tensorflow_jobs(0)[0],
        "scout": lambda: scout_jobs(0)[3]}
N_DRAWS = {"synthetic": 20, "tf-cnn": 12, "scout": 18}


def _draws(job, n, seed):
    rng = np.random.default_rng(seed)
    m = job.space.n_points
    for _ in range(n):
        y = (job.cost * rng.uniform(0.7, 1.3, m)).astype(np.float32)
        mask = rng.random(m) < rng.uniform(0.05, 0.9)
        yield int(rng.integers(0, 2**31)), y, mask


def _jax_fit(space, n_trees, depth):
    left = jt.make_left_table(space.points, space.thresholds)
    return jax.jit(lambda k, y, m: jt.fit_forest(
        k, y, m, jnp.asarray(space.points), left,
        jnp.asarray(space.thresholds), n_trees=n_trees, depth=depth))


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy()
    if want.dtype == np.int32 and got.dtype == np.int64:
        got = got.astype(np.int32)
    assert want.dtype == got.dtype and want.shape == got.shape
    assert want.tobytes() == got.tobytes()


@pytest.mark.parametrize("job_name", list(JOBS))
@pytest.mark.parametrize("n_trees,depth", [(10, 4), (3, 3)])
def test_fit_forest_matches_jax(job_name, n_trees, depth):
    job = JOBS[job_name]()
    sp = job.space
    fit = _jax_fit(sp, n_trees, depth)
    left = tt.make_left_table(sp.points, sp.thresholds)
    thr = torch.as_tensor(sp.thresholds)
    # A stable digest: builtin hash() of a str is salted per process.
    for seed, y, mask in _draws(job, N_DRAWS[job_name],
                                zlib.crc32(job_name.encode()) % 97):
        pj, aj = fit(jax.random.PRNGKey(seed), y, mask)
        pt, at = tt.fit_forest(prng.PRNGKey(seed), torch.as_tensor(y),
                               torch.as_tensor(mask), None, left, thr,
                               n_trees=n_trees, depth=depth)
        for a, b in zip(pj, pt):
            _same(a, b)
        _same(aj, at)


def test_batched_state_fit_matches_vmapped_reference():
    """States as a leading dim == the reference's vmap over state keys
    (``lookahead._fit_batch_exact``'s fold_in schedule)."""
    job = synthetic_job(2)
    sp = job.space
    draws = list(_draws(job, 6, 5))
    y = np.stack([d[1] for d in draws])
    mask = np.stack([d[2] for d in draws])
    left_j = jt.make_left_table(sp.points, sp.thresholds)
    key = jax.random.PRNGKey(9)
    keys = jax.vmap(jax.random.fold_in, (None, 0))(key, jnp.arange(6))
    pj, aj = jax.jit(jax.vmap(lambda k, a, b: jt.fit_forest(
        k, a, b, jnp.asarray(sp.points), left_j,
        jnp.asarray(sp.thresholds), n_trees=4, depth=3)))(keys, y, mask)
    tkeys = prng.fold_in(prng.PRNGKey(9)[None, :], torch.arange(6))
    pt, at = tt.fit_forest(tkeys, torch.as_tensor(y), torch.as_tensor(mask),
                           None, tt.make_left_table(sp.points, sp.thresholds),
                           torch.as_tensor(sp.thresholds), n_trees=4,
                           depth=3)
    for a, b in zip(pj, pt):
        _same(a, b)
    _same(aj, at)


@pytest.mark.parametrize("job_name", ["synthetic", "scout"])
def test_predict_and_mu_sigma_on_a_carried_jax_forest(job_name):
    job = JOBS[job_name]()
    sp = job.space
    fit = _jax_fit(sp, 10, 4)
    for seed, y, mask in _draws(job, 8, 11):
        pj, aj = fit(jax.random.PRNGKey(seed), y, mask)
        forest = convert.forest_from_numpy(*(np.asarray(a) for a in pj),
                                          device="cpu")
        xq = np.random.default_rng(seed % 1000).uniform(
            -0.1, 1.1, (50, sp.n_dims)).astype(np.float32)
        xq = np.concatenate([xq, sp.points])
        want = jax.jit(jt.predict_forest)(pj, xq)
        got = tt.predict_forest(forest, torch.as_tensor(xq))
        _same(want, got)
        floor = np.float32(0.013)
        for a, b in zip(jax.jit(jt.forest_mu_sigma)(want, floor),
                        tt.forest_mu_sigma(got, floor)):
            _same(a, b)
        # The fit-side assignment and the traversal agree (reference
        # contract that the fused kernel rests on).
        on_space = tt.predict_forest(forest, torch.as_tensor(sp.points))
        _same(np.take_along_axis(np.asarray(pj.leaf), np.asarray(aj), 1),
              on_space)


def test_fit_predict_mu_sigma_matches_jax():
    job = JOBS["scout"]()
    sp = job.space
    left_j = jt.make_left_table(sp.points, sp.thresholds)
    left_t = tt.make_left_table(sp.points, sp.thresholds)
    for seed, y, mask in _draws(job, 5, 3):
        want = jt.fit_predict_mu_sigma(
            jax.random.PRNGKey(seed), y, mask, jnp.asarray(sp.points),
            left_j, jnp.asarray(sp.thresholds), np.float32(0.02),
            n_trees=10, depth=4)
        got = tt.fit_predict_mu_sigma(
            prng.PRNGKey(seed), torch.as_tensor(y), torch.as_tensor(mask),
            None, left_t, torch.as_tensor(sp.thresholds), np.float32(0.02),
            n_trees=10, depth=4)
        for a, b in zip(want, got):
            _same(a, b)


def test_left_table_matches_jax():
    sp = JOBS["tf-cnn"]().space
    _same(jt.make_left_table(sp.points, sp.thresholds),
          tt.make_left_table(sp.points, sp.thresholds))
