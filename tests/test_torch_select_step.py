"""The port's fused selector step against ``repro.kernels.select_step``.

The plain PyTorch version (``repro_torch.kernels.select_step.ref``) must
equal, bitwise, both the JAX package's plain ``select_step_ref`` and its
Pallas kernel run in interpret mode, over both output modes, with and
without censoring, a validity mask and G-H nodes, and both score modes.
The inputs (random forests with +inf degenerate thresholds, ties and
unobserved rows) are made with numpy and handed to both packages.  The
CUDA kernel itself is held against this plain version on the card by
``chip_smoke.py``; here its wrapper's dispatch rules are checked.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.acquisition import gauss_hermite
from repro.kernels.select_step.ops import select_step as jax_select_step
from repro_torch.kernels.select_step import kernel as tkernel
from repro_torch.kernels.select_step import ops as tops
from repro_torch.kernels.select_step.ref import select_step_ref

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

T_MAX, FLOOR = np.float32(1.3), np.float32(0.05)


def _inputs(seed, s_dim=37, n_trees=3, depth=3, m_dim=20, n_feat=3):
    rng = np.random.default_rng(seed)
    width, n_leaves = 2 ** (depth - 1), 2 ** depth
    shape = (s_dim, n_trees, depth, width)
    feat = rng.integers(0, n_feat, shape).astype(np.int32)
    thr = rng.uniform(0, 1, shape).astype(np.float32)
    thr[rng.random(shape) < 0.2] = np.inf
    leaf = rng.uniform(0.5, 3, (s_dim, n_trees, n_leaves)).astype(np.float32)
    # Repeated leaf values make exact score ties, which break to the
    # lowest index.
    leaf[::3] = np.round(leaf[::3], 1)
    y = rng.uniform(0.5, 3, (s_dim, m_dim)).astype(np.float32)
    obs = rng.random((s_dim, m_dim)) < 0.3
    obs[-1] = True                                # a state with no candidate
    cens = rng.random((s_dim, m_dim)) < 0.1
    beta = rng.uniform(1, 10, s_dim).astype(np.float32)
    beta[1] = np.float32(0.01)                    # budget filter empties
    bf = rng.uniform(0.5, 3, s_dim).astype(np.float32)
    bf[::4] = np.inf                              # y* falls back
    pts = rng.uniform(0, 1, (m_dim, n_feat)).astype(np.float32)
    u = rng.uniform(0.5, 2, m_dim).astype(np.float32)
    valid = np.arange(m_dim) < m_dim - 4
    xi = gauss_hermite(3)[0]
    return dict(feat=feat, thr=thr, leaf=leaf, y=y, obs=obs, cens=cens,
                beta=beta, bf=bf, pts=pts, u=u, valid=valid, xi=xi)


def _args(d, conv, with_cens, with_valid):
    return ((conv(d["feat"]), conv(d["thr"]), conv(d["leaf"]), conv(d["y"]),
             conv(d["obs"]), conv(d["beta"]), conv(d["bf"]), conv(d["pts"]),
             conv(d["u"])),
            dict(xi=conv(d["xi"]),
                 cens=conv(d["cens"]) if with_cens else None,
                 valid=conv(d["valid"]) if with_valid else None))


@pytest.mark.parametrize("emit_full,want_nodes,with_cens,with_valid",
                         list(itertools.product([False, True], repeat=4)))
def test_plain_version_matches_jax_ref_and_interpret(emit_full, want_nodes,
                                                     with_cens, with_valid):
    d = _inputs(seed=int(emit_full) + 2 * int(want_nodes))
    jargs, jkw = _args(d, jnp.asarray, with_cens, with_valid)
    targs, tkw = _args(d, torch.as_tensor, with_cens, with_valid)
    # Each output mode meets both score modes across the matrix.
    score_mode = ("eic", "ratio")[int(with_cens) ^ int(want_nodes)]
    kw = dict(score_mode=score_mode, emit_full=emit_full,
              want_nodes=want_nodes)
    got = select_step_ref(*targs, T_MAX, FLOOR, tkw["xi"], cens=tkw["cens"],
                          valid=tkw["valid"], **kw)
    for force in ("ref", "interpret"):
        want = jax_select_step(*jargs, T_MAX, FLOOR, jkw["xi"], jkw["cens"],
                               jkw["valid"], force=force, **kw)
        # The root sweep also gives nodes_y, which the JAX op has not.
        assert len(want) + int(emit_full and want_nodes) == len(got)
        for i, (a, b) in enumerate(zip(want, got)):
            a = np.asarray(a)
            b = b.numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, (force, i)
            assert a.tobytes() == b.tobytes(), (force, i)
    if emit_full and want_nodes:
        # nodes_y contracts the forest mean's product into the node's
        # addition: it skips the mean's rounding (half an ulp of mu) and
        # rounds once, so it lies within that and an ulp of the node; a
        # censored sweep's mean is a select and takes no contraction.
        mu, nodes, nodes_y = (got[i].numpy() for i in (0, 7, 8))
        if with_cens:
            assert nodes_y.tobytes() == nodes.tobytes()
        else:
            assert (nodes_y != nodes).any()
            bound = np.spacing(np.abs(mu))[..., None] + np.spacing(
                np.abs(nodes))
            assert np.all(np.abs(nodes_y - nodes) <= bound)


def test_budget_off_matches_jax():
    d = _inputs(seed=7)
    jargs, jkw = _args(d, jnp.asarray, True, False)
    targs, tkw = _args(d, torch.as_tensor, True, False)
    want = jax_select_step(*jargs, T_MAX, FLOOR, jkw["xi"], jkw["cens"],
                           force="ref", use_budget=False, emit_full=True)
    got = select_step_ref(*targs, T_MAX, FLOOR, tkw["xi"], cens=tkw["cens"],
                          use_budget=False, emit_full=True)
    for a, b in zip(want, got):
        assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_cpu_tensors_take_the_plain_version():
    d = _inputs(seed=3)
    targs, tkw = _args(d, torch.as_tensor, True, True)
    before = tkernel.select_step_cuda.launches
    got = tops.select_step(*targs, T_MAX, FLOOR, **tkw, want_nodes=True)
    want = select_step_ref(*targs, T_MAX, FLOOR, **tkw, want_nodes=True)
    for a, b in zip(want, got):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert tkernel.select_step_cuda.launches == before


def test_kernel_demanded_on_cpu_tensors_raises():
    d = _inputs(seed=4)
    targs, tkw = _args(d, torch.as_tensor, False, False)
    with pytest.raises(ValueError, match="CUDA"):
        tops.select_step(*targs, T_MAX, FLOOR, **tkw, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.select_step_cuda(*targs, T_MAX, FLOOR, **tkw)
