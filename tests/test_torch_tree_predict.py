"""The port's forest-inference op against ``repro.kernels.tree_predict``.

On CPU tensors ``repro_torch.kernels.tree_predict`` runs its plain
version.  It is held, at the 1e-5 of ``tests/test_kernels.py``, against the
JAX package's ``tree_predict_ref`` and its Pallas kernel in interpret mode
(whose variance is one-pass), on forests that the JAX package fits and on
random forests with +inf (degenerate) thresholds; and against the port's
own fit, as the JAX test holds the kernel against ``repro.core.trees``.
The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's dispatch rules and launch plan are
checked, and its arithmetic in plain form: the heap descent (numpy) gives
the JAX reference's leaf values exactly, and the held predictions' mean
and two-pass deviation hold at 1e-5, also where the trees agree closely.
"""

import functools

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
from repro_torch.kernels.tree_predict.ref import tree_predict_held

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


@functools.lru_cache(maxsize=None)
def _fitted(depth, n_trees):
    """The grid space's points and a forest the JAX package fits there."""
    space = _grid_space()
    return np.asarray(space.points), _jax_forest(
        space, seed=depth, n_trees=n_trees, depth=depth, obs_share=0.6)


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
    _hold(*_fitted(depth, n_trees), bm)


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


# The redesigned kernel's arithmetic in plain PyTorch and numpy: the forest
# packed as a heap of (feature, threshold) nodes and descended once per
# (point, tree); the held predictions' mean and two-pass deviation
# (``ref.tree_predict_held``).
def _heap_descent(x, feat, thr, leaf):
    """[B, M] predictions as the kernel makes them: heap node k of level
    l = floor(log2(k + 1)) is node ``(k + 1 - 2^l) % W`` of that level, an
    infinite threshold is stored as +inf, and k goes to 2k + 1 + (x > t)."""
    n_trees, depth, width = feat.shape
    inner = 2 ** depth - 1
    hf = np.zeros((n_trees, inner), np.int64)
    ht = np.zeros((n_trees, inner), np.float32)
    for k in range(inner):
        lvl = (k + 1).bit_length() - 1
        node = (k + 1 - 2 ** lvl) % width
        hf[:, k] = feat[:, lvl, node]
        t = thr[:, lvl, node]
        ht[:, k] = np.where(np.isinf(t), np.inf, t)
    preds = np.zeros((n_trees, x.shape[0]), np.float32)
    for b in range(n_trees):
        k = np.zeros(x.shape[0], np.int64)
        for _ in range(depth):
            v = x[np.arange(x.shape[0]), hf[b, k]]
            k = 2 * k + 1 + (v > ht[b, k])
        preds[b] = leaf[b, k - inner]
    return preds


def _jax_preds(x, feat, thr, leaf):
    """The JAX reference's [B, M] leaf values (its mean of one tree)."""
    one = jax.jit(tree_predict_ref)
    return np.stack([np.asarray(one(
        jnp.asarray(x), jnp.asarray(feat[b:b + 1]), jnp.asarray(thr[b:b + 1]),
        jnp.asarray(leaf[b:b + 1]))[0]) for b in range(feat.shape[0])])


def _forest(name):
    """(x, forest) for ``name``: "fitted D B", or "random D B M" with
    +inf and -inf thresholds."""
    kind, *dims = name.split()
    if kind == "fitted":
        return _fitted(*map(int, dims))
    depth, n_trees, m_dim = map(int, dims)
    rng = np.random.default_rng(m_dim + depth)
    feat, thr, leaf = _random_forest(depth + n_trees, n_trees, depth, 5)
    thr[rng.random(thr.shape) < 0.1] = -np.inf       # also routes left
    return rng.uniform(0, 1, (m_dim, 5)).astype(np.float32), (feat, thr,
                                                               leaf)


@pytest.mark.parametrize("name", ["fitted 2 4", "fitted 4 10", "fitted 5 7",
                                  "random 4 10 384", "random 1 10 77",
                                  "random 3 5 77"])
def test_kernel_order_matches_jax_ref(name):
    x, forest = _forest(name)
    np.testing.assert_array_equal(_heap_descent(x, *forest),
                                  _jax_preds(x, *forest))
    got = tree_predict_held(torch.as_tensor(x),
                            *map(torch.as_tensor, forest))
    want = tree_predict_ref(jnp.asarray(x),
                            *(jnp.asarray(a) for a in forest))
    for a, b in zip(want, got):
        assert b.dtype == torch.float32 and b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL,
                                   rtol=0)


def test_kernel_order_keeps_the_spread_where_trees_agree():
    """Trees that agree to 1e-3 around 10: |mu| >> sigma, where a one-pass
    E[p^2] - mu^2 in float32 loses the spread; the held two-pass order
    keeps it within 1e-5 of the JAX reference."""
    rng = np.random.default_rng(12)
    feat, thr, _ = _random_forest(5, 10, 4, 5)
    leaf = (10 + 1e-3 * rng.normal(size=(10, 16))).astype(np.float32)
    x = rng.uniform(0, 1, (384, 5)).astype(np.float32)
    forest = (feat, thr, leaf)
    mu, sig = tree_predict_held(torch.as_tensor(x),
                                *map(torch.as_tensor, forest))
    jmu, jsig = tree_predict_ref(jnp.asarray(x),
                                 *(jnp.asarray(a) for a in forest))
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(sig.numpy(), np.asarray(jsig), atol=ATOL,
                               rtol=0)
    assert float(np.asarray(jsig).min()) > 1e-4
    # The case bites: the one-pass variance misses by more than ATOL.
    p = _heap_descent(x, *forest)
    acc = np.zeros(384, np.float32)
    acc2 = np.zeros(384, np.float32)
    for b in range(10):
        acc = acc + p[b]
        acc2 = acc2 + p[b] * p[b]
    m1 = acc / np.float32(10)
    one_pass = np.sqrt(np.maximum(acc2 / np.float32(10) - m1 * m1, 0))
    assert np.abs(one_pass - np.asarray(jsig)).max() > ATOL


# The launch plan (pure Python, no card), at tf-cnn's forest (B = 10 trees
# of depth 4 over F = 5 features) on an H100's 132 SMs.
TF_CNN = dict(n_feat=5, n_trees=10, depth=4)


@pytest.mark.parametrize("m_dim,grid,tile,threads", [
    (384, 48, 8, 96), (16, 2, 8, 96), (33_792, 264, 128, 256),
    (1 << 20, 1056, 256, 256)])
def test_plan_blocks(m_dim, grid, tile, threads):
    p = tkernel.plan(m_dim, **TF_CNN, sm_count=132)
    assert (p.grid, p.tile, p.threads) == (grid, tile, threads)
    # The tile's points all have a thread in the mean/deviation pass, and
    # the grid is at most the blocks the card holds at once.
    assert p.tile <= p.threads <= tkernel.MAX_THREADS
    assert p.threads % p.tile == 0 and p.threads % 32 == 0
    assert p.grid <= 132 * (2048 // p.threads)
    assert p.grid * p.tile >= m_dim or p.grid == 132 * (2048 // p.threads)


def test_plan_shared_bytes():
    """Counted here byte by byte from the kernel's layout, each region
    rounded up to 16 bytes."""
    p = tkernel.plan(384, **TF_CNN, sm_count=132)
    assert p.smem == (10 * 15 * 8          # heap: 15 nodes a tree, 8 bytes
                      + 10 * 16 * 4        # leaves [B, 2^D]
                      + 8 * 5 * 4          # the tile's rows [8, F]
                      + 8 * 10 * 4)        # predictions [B, 8]
    big = tkernel.plan(1 << 20, **TF_CNN, sm_count=132)
    assert big.smem == 1200 + 640 + 256 * 5 * 4 + 256 * 10 * 4


def test_plan_shrinks_the_tile_to_fit():
    p = tkernel.plan(1 << 20, n_feat=8192, n_trees=10, depth=4,
                     sm_count=132)
    assert p.tile < 256 and p.smem <= tkernel.SMEM_LIMIT
    assert p.smem == tkernel.smem_bytes(p.tile, 8192, 10, 4)


@pytest.mark.parametrize("shape,what", [
    (dict(n_trees=0), "trees"), (dict(n_feat=0), "features"),
    (dict(depth=-1), "depth"), (dict(depth=21), "depth"),
    (dict(n_trees=16, depth=14), "shared memory"),
    (dict(n_feat=60_000), "shared memory")])
def test_plan_refuses_a_forest_that_does_not_fit(shape, what):
    with pytest.raises(ValueError, match=what):
        tkernel.plan(384, **dict(TF_CNN, **shape), sm_count=132)
