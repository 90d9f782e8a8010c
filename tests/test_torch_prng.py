"""The port's threefry PRNG against live ``jax.random`` output, bit for bit.

Keys, splits, fold-ins and uniforms at the shapes the reference draws
(``optimizer.optimize``'s per-step split, ``lookahead``'s per-state and
``trees``'s per-point ``fold_in``, the ``[24, B]`` Knuth uniforms), plus
the bootstrap weights built on them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import trees as jtrees
from repro.core.optimizer import _per_run_seeds as j_seeds
from repro_torch.core import prng
from repro_torch.core import trees as ttrees
from repro_torch.core.optimizer import _per_run_seeds as t_seeds

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

RNG = np.random.default_rng(0)
SEEDS = [0, 1, 7, 2**31 - 1, 2**32 - 1, 2**40 + 3] + [
    int(s) for s in RNG.integers(0, 2**32, 10)]


def _keys(n=1000):
    """1,000 random raw keys, as the two uint32 words jax keys hold."""
    words = np.random.default_rng(1).integers(0, 2**32, (n, 2),
                                              dtype=np.uint64)
    return words.astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_matches_jax(seed):
    assert (np.asarray(jax.random.PRNGKey(seed)).astype(np.int64)
            == prng.PRNGKey(seed).numpy()).all()


def test_split_matches_jax_over_1000_keys():
    keys = _keys()
    want = np.asarray(jax.vmap(jax.random.split)(jnp.asarray(keys)))
    got = prng.split(torch.as_tensor(keys.astype(np.int64)))
    assert want.astype(np.int64).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("n", [1, 24, 1152])
def test_fold_in_matches_jax_over_1000_keys(n):
    keys = _keys()[: max(1, 1000 // n) * 4]
    data = jnp.arange(n)
    want = np.asarray(jax.vmap(lambda k: jax.vmap(
        jax.random.fold_in, (None, 0))(k, data))(jnp.asarray(keys)))
    got = prng.fold_in(torch.as_tensor(keys.astype(np.int64))[:, None, :],
                       torch.arange(n)[None, :])
    assert want.astype(np.int64).tobytes() == got.numpy().tobytes()


@pytest.mark.parametrize("shape", [(24, 10), (24, 3), (5,), (2, 3, 4)])
def test_uniform_matches_jax_over_1000_keys(shape):
    keys = _keys()
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, shape))(
        jnp.asarray(keys)))
    got = prng.uniform(torch.as_tensor(keys.astype(np.int64)), shape)
    assert want.dtype == np.float32
    assert want.tobytes() == got.numpy().tobytes()


def test_optimizer_key_chain_matches_jax():
    """``key, sub = split(key)`` as ``optimize`` advances it, for the seeds
    ``run_many`` derives (``seed*100003 + r``)."""
    assert j_seeds(3, 4) == t_seeds(3, 4)
    for seed in j_seeds(3, 4) + j_seeds(0, 2):
        kj, kt = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for _ in range(5):
            kj, sj = jax.random.split(kj)
            kt, st = prng.split(kt)
            assert (np.asarray(sj).astype(np.int64) == st.numpy()).all()


@pytest.mark.parametrize("n_trees,m", [(10, 384), (4, 24), (3, 69)])
def test_bootstrap_weights_match_jax(n_trees, m):
    """Pins the Knuth sampler's running product to XLA's blocked cumprod
    order (two blocks of 16) through the weights it decides."""
    for s in range(25):
        seed = int(RNG.integers(0, 2**31))
        want = np.asarray(jtrees.bootstrap_weights(jax.random.PRNGKey(seed),
                                                   n_trees, m))
        got = ttrees.bootstrap_weights(prng.PRNGKey(seed), n_trees, m)
        assert want.tobytes() == got.numpy().tobytes(), seed


def test_bootstrap_weights_batched_states_match_per_state():
    """A batch of state keys draws each state's weights as a lone key does,
    also when the bootstrap is drawn in chunks."""
    keys = prng.fold_in(prng.PRNGKey(5)[None, :], torch.arange(7))
    batched = ttrees.bootstrap_weights(keys, 3, 24)
    old = ttrees._BOOT_CHUNK_ELEMS
    try:
        ttrees._BOOT_CHUNK_ELEMS = 24 * 24 * 3 * 2      # two states a chunk
        chunked = ttrees.bootstrap_weights(keys, 3, 24)
    finally:
        ttrees._BOOT_CHUNK_ELEMS = old
    for i in range(7):
        one = ttrees.bootstrap_weights(keys[i], 3, 24)
        assert torch.equal(batched[i], one)
        assert torch.equal(chunked[i], one)
