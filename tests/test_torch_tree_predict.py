"""The port's forest-inference op against ``repro.kernels.tree_predict``.

On CPU tensors ``repro_torch.kernels.tree_predict`` runs its plain
version.  It is held, at the 1e-5 of ``tests/test_kernels.py``, against the
JAX package's ``tree_predict_ref`` and its Pallas kernel in interpret mode
(whose variance is one-pass), on forests that the JAX package fits and on
random forests with +inf (degenerate) thresholds; and against the port's
own fit, as the JAX test holds the kernel against ``repro.core.trees``.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's dispatch rules are checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trees as jt
from repro.core.space import DiscreteSpace
from repro.kernels.tree_predict.kernel import tree_predict_call
from repro.kernels.tree_predict.ref import tree_predict_ref
from repro_torch import convert
from repro_torch.core import prng
from repro_torch.core import trees as tt
from repro_torch.kernels import tree_predict
from repro_torch.kernels.tree_predict import kernel as tkernel

torch.set_num_threads(1)

ATOL = 1e-5


def _grid_space():
    return DiscreteSpace.from_grid({"a": list(range(5)),
                                    "b": [0.0, 2.0, 7.0],
                                    "c": list(range(6))})


def _jax_forest(space, seed, n_trees, depth, obs_share):
    rng = np.random.default_rng(seed)
    y = jnp.asarray(rng.normal(size=(space.n_points,)).astype(np.float32))
    mask = jnp.asarray(rng.random(space.n_points) < obs_share)
    left = jt.make_left_table(space.points, space.thresholds)
    fit = jax.jit(lambda k, y, m: jt.fit_forest(
        k, y, m, jnp.asarray(space.points), left,
        jnp.asarray(space.thresholds), n_trees=n_trees, depth=depth))
    params, _ = fit(jax.random.PRNGKey(depth), y, mask)
    return tuple(np.array(a) for a in params)


def _random_forest(seed, n_trees, depth, n_feat):
    rng = np.random.default_rng(seed)
    shape = (n_trees, depth, 2 ** (depth - 1))
    feat = rng.integers(0, n_feat, shape).astype(np.int32)
    thr = rng.uniform(0, 1, shape).astype(np.float32)
    thr[rng.random(shape) < 0.25] = np.inf
    leaf = rng.normal(size=(n_trees, 2 ** depth)).astype(np.float32)
    return feat, thr, leaf


def _hold(x, forest, bm):
    """The port's op on CPU tensors against the JAX ref and interpret."""
    got = tree_predict(torch.as_tensor(x), *map(torch.as_tensor, forest))
    jx = jnp.asarray(x)
    jf = tuple(jnp.asarray(a) for a in forest)
    for want in (tree_predict_ref(jx, *jf),
                 tree_predict_call(jx, *jf, bm=bm, interpret=True)):
        for a, b in zip(want, got):
            assert b.dtype == torch.float32 and b.shape == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                       rtol=0)


@pytest.mark.parametrize("depth,n_trees,bm", [(2, 4, 16), (4, 10, 32),
                                              (5, 7, 64)])
def test_fitted_forest_matches_jax_ref_and_interpret(depth, n_trees, bm):
    space = _grid_space()
    forest = _jax_forest(space, seed=depth, n_trees=n_trees, depth=depth,
                         obs_share=0.6)
    _hold(np.asarray(space.points), forest, bm)


@pytest.mark.parametrize("depth,n_trees,m_dim,bm", [(4, 10, 384, 128),
                                                    (3, 5, 77, 32)])
def test_random_forest_with_degenerate_splits(depth, n_trees, m_dim, bm):
    rng = np.random.default_rng(m_dim)
    x = rng.uniform(0, 1, (m_dim, 5)).astype(np.float32)
    _hold(x, _random_forest(depth + n_trees, n_trees, depth, 5), bm)


def test_consistent_with_the_ports_own_fit():
    """The op agrees with the port's own tabular predictions, as
    ``tests/test_kernels.py`` holds the kernel against ``repro.core.trees``."""
    space = DiscreteSpace.from_grid({"a": list(range(8)),
                                     "b": list(range(8))})
    rng = np.random.default_rng(11)
    y = rng.normal(size=(space.n_points,)).astype(np.float32)
    mask = rng.random(space.n_points) < 0.5
    tsp = convert.space_from_numpy(space.names, space.points_raw,
                                   space.points, space.thresholds)
    left = tt.make_left_table(tsp.points, tsp.thresholds)
    params, assign = tt.fit_forest(
        prng.PRNGKey(0), torch.as_tensor(y), torch.as_tensor(mask), None,
        left, torch.as_tensor(tsp.thresholds), n_trees=10, depth=4)
    preds = params.leaf.gather(-1, assign)
    mu_core, sig_core = tt.forest_mu_sigma(preds, 1e-6)
    x = torch.as_tensor(tsp.points)
    mu, sig = tree_predict(x, *params)
    np.testing.assert_allclose(mu.numpy(), mu_core.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(sig.numpy(), sig_core.numpy(), atol=ATOL,
                               rtol=0)
    _hold(tsp.points, tuple(a.numpy() for a in params), bm=32)


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    x = torch.rand(20, 3, generator=torch.Generator().manual_seed(0))
    forest = tuple(map(torch.as_tensor, _random_forest(1, 3, 3, 3)))
    before = tkernel.tree_predict_cuda.launches
    mu, sig = tree_predict(x, *forest, sigma_floor=0.01)
    assert float(sig.min()) >= 0.01 and mu.shape == (20,)
    assert tkernel.tree_predict_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tree_predict(x, *forest, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.tree_predict_cuda(x, *forest)
