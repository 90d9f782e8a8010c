"""The port's §4.4 extensions against ``repro.core.extensions``, bitwise.

The six public names on the inputs of ``tests/test_core_extensions.py``
(``cartesian_gh``, ``default_setup_cost``, ``ConstrainedJob``,
``multi_constraint_probs``, ``optimize_multi_constraint`` with the timeout
off and on, ``optimize_with_setup_costs``), each through the port on the
CPU and through the JAX package, one JAX run a case shared by the file's
tests; the golden file's entries for these cases equal that run.  The
standalone fit the loops call, ``trees.fit_predict_mu_sigma`` (the
reference's own jitted fit: point-order node sums), is pinned here at the
12-point space of those tests and at tf-cnn's 384 points.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import extensions as jext
from repro.core import trees as jt
from repro.jobs import tensorflow_jobs as jax_tensorflow_jobs
from repro_torch.core import extensions as text
from repro_torch.core import prng
from repro_torch.core import trees as tt
from test_torch_golden_extensions import (extension_job, golden_case,
                                          golden_cases, jax_api, port_api,
                                          run_case)

torch.set_num_threads(1)

SMALL = [c["name"] for c in golden_cases()
         if c["call"] in ("cartesian_gh", "default_setup_cost",
                          "optimize_multi_constraint",
                          "optimize_with_setup_costs")
         and not c["name"].startswith("tf-cnn/")]


@functools.lru_cache(maxsize=None)
def _jax_out(name):
    case = next(c for c in golden_cases() if c["name"] == name)
    return run_case(case, jax_api())


@pytest.mark.parametrize("name", SMALL)
def test_port_matches_jax_on_the_reference_tests_inputs(name):
    case = next(c for c in golden_cases() if c["name"] == name)
    assert run_case(case, port_api()) == _jax_out(name)


@pytest.mark.parametrize("name", SMALL)
def test_golden_entry_equals_fresh_jax_output(name):
    assert golden_case(name)["out"] == _jax_out(name)


def _jobs(case):
    """The case's job in both packages, and its metric arrays."""
    api_j, api_t = jax_api(), port_api()
    metrics = {k: np.asarray(v) for k, v in case["metrics"].items()}
    return (extension_job(case["job"], api_j),
            extension_job(case["job"], api_t), metrics)


@pytest.mark.parametrize("name", ["multi_constraint/joint_feasibility",
                                  "multi_constraint/timeout"])
def test_constrained_job_matches_jax(name):
    case = golden_case(name)
    jjob, tjob, metrics = _jobs(case)
    a = jext.ConstrainedJob(jjob, metrics, dict(case["thresholds"]))
    b = text.ConstrainedJob(tjob, metrics, dict(case["thresholds"]))
    assert a.feasible.tobytes() == b.feasible.tobytes()
    assert a.optimum_index == b.optimum_index
    assert [a.cno(i) for i in range(12)] == [b.cno(i) for i in range(12)]


def test_multi_constraint_probs_matches_jax():
    """Two metrics (the golden energy and its reverse) on random masks and
    keys: one forest a metric, each with its own fold-in key."""
    case = golden_case("multi_constraint/joint_feasibility")
    jjob, tjob, metrics = _jobs(case)
    energy = metrics["energy"].astype(np.float32)
    obs = [energy, energy[::-1].copy()]
    rng = np.random.default_rng(7)
    for _ in range(4):
        seed = int(rng.integers(0, 2**31))
        mask = rng.random(12) < 0.6
        mask[rng.integers(0, 12)] = True
        thr = [float(np.quantile(o, 0.5)) for o in obs]
        want = jext.multi_constraint_probs(jax.random.PRNGKey(seed), obs,
                                           mask, thr, jjob.space)
        got = text.multi_constraint_probs(prng.PRNGKey(seed), obs, mask, thr,
                                          tjob.space, device="cpu")
        assert np.asarray(want).tobytes() == got.numpy().tobytes()


def _fit_jobs():
    case = golden_case("multi_constraint/joint_feasibility")
    jjob, tjob, _ = _jobs(case)
    return {"grid12": (jjob, tjob),
            "tf-cnn": (jax_tensorflow_jobs(0)[0],
                       port_api().tensorflow_jobs(0)[0])}


@pytest.mark.parametrize("job_name", ["grid12", "tf-cnn"])
def test_fit_predict_mu_sigma_matches_jax(job_name):
    jjob, tjob = _fit_jobs()[job_name]
    sp = jjob.space
    m = sp.n_points
    left_j = jt.make_left_table(sp.points, sp.thresholds)
    left_t = tt.make_left_table(sp.points, sp.thresholds)
    rng = np.random.default_rng(zlib.crc32(job_name.encode()))
    for _ in range(4):
        seed = int(rng.integers(0, 2**31))
        y = (jjob.cost * rng.uniform(0.7, 1.3, m)).astype(np.float32)
        mask = rng.random(m) < rng.uniform(0.05, 0.9)
        floor = np.float32(1e-6 + 0.01 * float(y[mask].std()
                                                if mask.any() else 1.0))
        want = jt.fit_predict_mu_sigma(
            jax.random.PRNGKey(seed), jnp.asarray(y), jnp.asarray(mask),
            jnp.asarray(sp.points), left_j, jnp.asarray(sp.thresholds),
            jnp.float32(floor), n_trees=10, depth=4)
        got = tt.fit_predict_mu_sigma(
            prng.PRNGKey(seed), torch.as_tensor(y), torch.as_tensor(mask),
            None, left_t, torch.as_tensor(tjob.space.thresholds), floor,
            n_trees=10, depth=4)
        for a, b in zip(want, got):
            assert np.asarray(a).tobytes() == b.numpy().tobytes()


def test_extension_loops_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = golden_case("setup_cost/budget")
    _, tjob, _ = _jobs(dict(case, metrics={}))
    setup = text.default_setup_cost(tjob.space)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text.optimize_with_setup_costs(tjob, port_api().Settings(),
                                       setup_cost=setup)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        text.multi_constraint_probs(prng.PRNGKey(0), [], np.ones(12, bool),
                                    [], tjob.space)
