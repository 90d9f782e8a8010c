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


# Inputs on which the port once differed from the JAX package (ROADMAP C2):
# (job seed, lookahead, padded, observation seed, factor on the first
# observed y, key, budget factor).  The first is the input that showed C2:
# the children's speculated y take the root node with the forest mean's
# product contracted, as the reference's compiled root computes it.  The
# second flushed EI's subnormal sum to -0.0, which max(., 0) must return
# as +0.0; the third is the C2 cause on a padded space.
PINNED = [(1, 2, False, 0, 0.6, 19, 3.0),
          (0, 1, False, 1, 0.6, 2, 2.0),
          (4, 2, True, 1, 0.6, 0, 2.0)]


def _check_input(jseed, la, padded, oseed, scale, key, bud):
    """One selection through JAX and both port paths: index, valid flag and
    every diagnostic bitwise."""
    job = _job(jseed)
    space = (job.space.pad_to(GeometryBucket(m=32, f=3, t=6)) if padded
             else job.space)
    m = space.n_points
    u = np.ones(m, np.float32)
    u[:job.space.n_points] = job.unit_price
    y, mask, _ = _observations(job, m, seed=oseed)
    y[np.flatnonzero(mask)[0]] *= np.float32(scale)
    beta = np.float32(job.budget(bud))
    kw = dict(policy="lynceus", la=la, k_gh=2, n_trees=3, depth=3)
    jsel = jax_make_selector(space, u, job.t_max,
                             JSettings(**kw, fused_selector="ref"))
    want = _as_numpy(jsel(jax.random.PRNGKey(key), y, mask, beta))
    tspace = _port_space(space)
    for mode in ("auto", "ref"):
        tsel = make_selector(tspace, u, job.t_max,
                             Settings(**kw, fused_selector=mode),
                             device="cpu")
        got = _as_numpy(tsel(prng.PRNGKey(key), y, mask, beta))
        assert got[:2] == want[:2], mode
        assert sorted(got[2]) == sorted(want[2]), mode
        for k, v in want[2].items():
            assert v.tobytes() == got[2][k].tobytes(), (mode, k)


@pytest.mark.parametrize("jseed,la,padded,oseed,scale,key,bud", PINNED)
def test_pinned_inputs_match_jax(jseed, la, padded, oseed, scale, key, bud):
    _check_input(jseed, la, padded, oseed, scale, key, bud)


# Inputs on which the root's reward or path-cost diagnostic differed from
# the JAX package's by one quantization step (ROADMAP C4), one per program
# shape and field where the survey found one (none for the reward of the
# native la = 2 program).  The reference's compiled program computes each
# diagnostic in a fusion of its own that contracts ei·cp into the reward's
# addition and the forest mean's product into the path cost's.
C4_REPAIRED = {
    "la1-native-path_cost": (4, 1, False, 1, 0.6, 31, 2.0),
    "la1-native-reward": (5, 1, False, 0, 1.0, 30, 2.0),
    "la1-padded-path_cost": (4, 1, True, 0, 0.6, 5, 2.0),
    "la1-padded-reward": (5, 1, True, 0, 1.0, 30, 2.0),
    "la2-native-path_cost": (0, 2, False, 0, 1.0, 30, 2.0),
    "la2-padded-path_cost": (5, 2, True, 0, 0.6, 20, 2.0),
    "la2-padded-reward": (3, 2, True, 1, 1.0, 5, 3.0),
    # ROADMAP C5: the root's reward in the contracted form is right once
    # the children's leaf means read the speculated node as the native
    # program's vector lanes round it (root 3 of 15: uncontracted).
    "la1-native-reward-b2": (3, 1, False, 2, 0.6, 32, 2.0),
    "la1-native-reward-b3": (3, 1, False, 2, 0.6, 32, 3.0),
}


@pytest.mark.parametrize("case", list(C4_REPAIRED))
def test_root_diagnostics_take_the_contracted_form(case):
    _check_input(*C4_REPAIRED[case])


# Surveyed inputs on which the children's fits differed from the JAX
# package's (ROADMAP C4), one for each site of the reference's compiled
# programs the port now follows; each fails with that site reverted.  The
# speculated node as each consumer rounds it (``lookahead._lookahead_tail``):
# the leaf means of a native program, uncontracted in the 8-wide vector
# lanes; the split search's node sums, contracted, for the children and
# carried to the grandchildren.  The node sums over the 32-point bucket of
# a padded program, a tree of halves, at the root level and below
# (``trees._fit_trees``).
C4_CHILDREN = {
    "la2-native-leaf-means-vector-lanes": (3, 2, False, 1, 1.0, 2, 2.0),
    "la2-native-split-sums-contracted-node": (0, 2, False, 1, 0.6, 5, 3.0),
    "la2-native-grandchildren-split-sums": (2, 2, False, 1, 0.6, 0, 2.0),
    "la1-padded-root-node-sum-halves": (2, 1, True, 1, 0.6, 6, 2.0),
    "la2-padded-root-node-sum-halves": (2, 2, True, 2, 0.6, 0, 3.0),
    "la1-padded-node-sums-halves": (2, 1, True, 2, 1.0, 6, 2.0),
    "la2-padded-node-sums-halves": (4, 2, True, 1, 1.0, 0, 2.0),
}


@pytest.mark.parametrize("case", list(C4_CHILDREN))
def test_children_fits_take_the_reference_forms(case):
    _check_input(*C4_CHILDREN[case])


def _survey_part(args):
    """Mismatching selections of one (job seed, la, padded) geometry."""
    jseed, la, padded = args
    job = _job(jseed)
    space = (job.space.pad_to(GeometryBucket(m=32, f=3, t=6)) if padded
             else job.space)
    m = space.n_points
    u = np.ones(m, np.float32)
    u[:job.space.n_points] = job.unit_price
    kw = dict(policy="lynceus", la=la, k_gh=2, n_trees=3, depth=3)
    jsel = jax_make_selector(space, u, job.t_max,
                             JSettings(**kw, fused_selector="ref"))
    tspace = _port_space(space)
    tsels = {mode: make_selector(tspace, u, job.t_max,
                                 Settings(**kw, fused_selector=mode),
                                 device="cpu") for mode in ("auto", "ref")}
    bad = []
    for oseed in range(3):
        for scale in (1.0, 0.6):
            y, mask, _ = _observations(job, m, seed=oseed)
            y[np.flatnonzero(mask)[0]] *= np.float32(scale)
            for key in range(8):
                for bud in (2.0, 3.0):
                    beta = np.float32(job.budget(bud))
                    want = _as_numpy(jsel(jax.random.PRNGKey(key), y, mask,
                                          beta))
                    for mode, tsel in tsels.items():
                        got = _as_numpy(tsel(prng.PRNGKey(key), y, mask,
                                             beta))
                        if got[:2] != want[:2] or any(
                                v.tobytes() != got[2][k].tobytes()
                                for k, v in want[2].items()):
                            bad.append((jseed, la, padded, oseed, scale, key,
                                        bud, mode))
    return bad


if __name__ == "__main__":
    # The selection survey behind ROADMAP C2/C4: 2,304 selections (jobs
    # 0-5, la 1 and 2, native and padded, 3 observation seeds, the first
    # observed y scaled by 1 and 0.6, keys 0-7, budgets 2 and 3), each
    # through both port paths against JAX; prints the mismatches.
    #   PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_lookahead.py
    import multiprocessing

    grid = [(j, la, p) for j in range(6) for la in (1, 2)
            for p in (False, True)]
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        found = [b for part in pool.map(_survey_part, grid) for b in part]
    by_mode = {m: {b[:7] for b in found if b[7] == m} for m in ("auto",
                                                                 "ref")}
    sels = by_mode["auto"] | by_mode["ref"]
    for b in sorted(found):
        print("mismatch", b)
    print(f"{len(sels)} of {len(grid) * 3 * 2 * 8 * 2} selections differ "
          f"from JAX ({sum(b[2] for b in sels)} padded); the port's two "
          f"paths disagree on {len(by_mode['auto'] ^ by_mode['ref'])}")
