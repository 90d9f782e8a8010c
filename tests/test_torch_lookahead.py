"""The port's selector (``repro_torch.core.lookahead``) against the JAX one.

(index, valid flag, every diagnostic) bitwise over policies lynceus / la0 /
bo, lookahead 0 / 1 / 2, exact and frozen refit, timeout on and off, on a
native space and on the same space padded by ``GeometryBucket(32, 3, 6)``:
the matrix of ``tests/test_kernels.py``'s fused-parity test.  The port runs
both its fused program (``fused_selector="auto"``: the selector-step
kernel's plain version on CPU tensors) and its unfused one (``"ref"``);
the JAX package runs its CPU program.  Spaces and jobs are built by the
JAX package and carried over with ``repro_torch.convert``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.core import Settings as JSettings
from repro.core import make_selector as jax_make_selector
from repro.core.space import DiscreteSpace, GeometryBucket
from repro.jobs.tables import JobTable
from repro_torch import convert
from repro_torch.core import Settings, make_batch_selector, make_selector
from repro_torch.core import prng

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

CASES = ([(p, 0, "exact") for p in ("bo", "la0", "lynceus")]
         + [("lynceus", la, refit) for la in (1, 2)
            for refit in ("exact", "frozen")])


def _job(seed=3):
    rng = np.random.default_rng(seed)
    space = DiscreteSpace.from_grid({"a": list(range(5)),
                                     "b": list(range(3))})
    runtime = rng.uniform(0.1, 1.0, space.n_points)
    price = rng.uniform(0.5, 2.0, space.n_points)
    return JobTable("j", space, runtime, price,
                    t_max=float(np.median(runtime)))


def _port_space(space):
    native = getattr(space, "native", None)
    if native is None:
        return convert.space_from_numpy(space.names, space.points_raw,
                                        space.points, space.thresholds)
    return convert.space_from_numpy(
        native.names, None, space.points, space.thresholds, valid=space.valid,
        bucket=tuple(space.bucket.shape), native=_port_space(native))


def _observations(job, m, seed, n=6):
    """Padded-width state: n observed configs, the first one censored (the
    draws of ``tests/test_kernels.py``'s ``_selector_obs``)."""
    rng = np.random.default_rng(seed)
    idx = rng.choice(job.space.n_points, n, replace=False)
    y = np.zeros(m, np.float32)
    mask = np.zeros(m, bool)
    cens = np.zeros(m, bool)
    y[idx] = job.cost[idx]
    mask[idx] = True
    cens[idx[0]] = True
    return y, mask, cens


def _as_numpy(out):
    idx, valid, diag = out
    return (int(idx), bool(valid),
            {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
             for k, v in diag.items()})


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("timeout", [False, True])
@pytest.mark.parametrize("policy,la,refit", CASES)
def test_selector_matches_jax(policy, la, refit, timeout, padded):
    job = _job()
    space = (job.space.pad_to(GeometryBucket(m=32, f=3, t=6)) if padded
             else job.space)
    m = space.n_points
    u = np.ones(m, np.float32)
    u[:job.space.n_points] = job.unit_price
    kw = dict(policy=policy, la=la, k_gh=2, n_trees=3, depth=3, refit=refit,
              timeout=timeout)
    jsel = jax_make_selector(space, u, job.t_max,
                             JSettings(**kw, fused_selector="ref"))
    tspace = _port_space(space)
    tsels = {mode: make_selector(tspace, u, job.t_max,
                                 Settings(**kw, fused_selector=mode),
                                 device="cpu")
             for mode in ("auto", "ref")}
    y, mask, cens = _observations(job, m, seed=3)
    beta = np.float32(job.budget(3.0))
    c = cens if timeout else None
    want = _as_numpy(jsel(jax.random.PRNGKey(7), y, mask, beta, cens=c))
    for mode, tsel in tsels.items():
        got = _as_numpy(tsel(prng.PRNGKey(7), y, mask, beta, c))
        assert got[:2] == want[:2], mode
        assert sorted(got[2]) == sorted(want[2]), mode
        for k, v in want[2].items():
            assert v.dtype == got[2][k].dtype, (mode, k)
            assert v.tobytes() == got[2][k].tobytes(), (mode, k)


def test_batch_selector_lanes_are_independent():
    """A slot's pick does not depend on the other slots of the batch."""
    job = _job(5)
    s = Settings(la=1, k_gh=2, n_trees=3, depth=3, timeout=True)
    sp = _port_space(job.space)
    batch = make_batch_selector(sp, job.unit_price, job.t_max, s,
                                device="cpu")
    one = make_selector(sp, job.unit_price, job.t_max, s, device="cpu")
    obs = [_observations(job, sp.n_points, seed) for seed in range(3)]
    keys = torch.stack([prng.PRNGKey(r) for r in range(3)])
    betas = np.float32([job.budget(b) for b in (2.0, 3.0, 4.0)])
    idx, valid, diag = batch(keys, np.stack([o[0] for o in obs]),
                             np.stack([o[1] for o in obs]), betas,
                             np.stack([o[2] for o in obs]))
    for r, (y, mask, cens) in enumerate(obs):
        i, v, d = one(prng.PRNGKey(r), y, mask, betas[r], cens)
        assert (int(i), bool(v)) == (int(idx[r]), bool(valid[r]))
        for k in d:
            assert d[k].numpy().tobytes() == diag[k][r].numpy().tobytes()
