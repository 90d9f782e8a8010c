"""The golden extension outputs that ``chip_smoke.py`` holds the card against.

``src/repro_torch/testdata/golden_extensions.json`` holds, for each case,
its inputs and the JAX package's output on the CPU:

* the inputs of ``tests/test_core_extensions.py``'s six tests
  (``cartesian_gh``, ``default_setup_cost``, ``optimize_multi_constraint``
  timeout off and on, ``optimize_with_setup_costs``);
* ``tests/test_autotune_and_launch.py``'s two ``optimize_live`` calls
  (timeout off and on);
* the mock launch-config tuner, ``tune("mixtral-8x22b", "train_4k",
  "single", budget=1000, slo=1.5, mock=True, la=2)``;
* three loops at tf-cnn size (``tensorflow_jobs(0)[0]``, M = 384):
  ``optimize_multi_constraint`` under an energy constraint built as
  ``examples/multi_constraint.py`` builds it, timeout off (default
  settings) and on (``Settings(policy="la0", timeout=True)``), and
  ``optimize_with_setup_costs`` with ``default_setup_cost`` and
  ``Settings(policy="la0")``, all at b = 3.

The card cannot run the JAX package, so the smoke run compares its outputs
with this file (``chip_smoke.run_extension_case``, the runner used here
too).  The tests keep the file from going stale and check that the port's
CPU path reproduces it.  Each file shares one JAX run a setting: the
tests of ``test_torch_extensions.py`` hold the small extension cases'
golden outputs against their JAX runs, ``test_torch_live.py`` the
``optimize_live`` cases' and ``test_torch_autotune.py`` the tuner's.
Here the tf-cnn entries are held against a fresh JAX run only: the port's
CPU path takes some 23 s for the three, so the card (``chip_smoke.py``
phase extensions) is what holds the port against them.

Regenerate with ``PYTHONPATH=src python tests/test_torch_golden_extensions.py``.
"""

import json
import os
import pathlib
import sys
import types

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root, for the case runner)

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

GOLDEN = chip_smoke.GOLDEN_EXT
run_case = chip_smoke.run_extension_case
extension_job = chip_smoke.extension_job

_GRID12 = {"vm_type": [0, 1, 2], "cluster_vcpus": [8, 16, 32, 64]}
_GRID30 = {"a": list(range(6)), "b": list(range(5))}


def _grid_job(seed):
    """``tests/test_core_extensions.py:_job(seed)`` as case inputs."""
    rng = np.random.default_rng(seed)
    n = int(np.prod([len(v) for v in _GRID12.values()]))
    runtime = rng.uniform(0.1, 1.0, n)
    price = rng.uniform(0.5, 2.0, n)
    return {"name": "j", "grid": _GRID12, "runtime": runtime.tolist(),
            "unit_price": price.tolist(),
            "t_max": float(np.quantile(runtime, 0.7))}


def _energy(seed, n, q):
    energy = np.random.default_rng(seed).uniform(0.0, 10.0, n)
    return energy.tolist(), float(np.quantile(energy, q))


def _tf_cnn_energy():
    """``examples/multi_constraint.py``'s energy model on tf-cnn: cluster
    size x runtime x U(0.9, 1.1) x (1 + 0.2 vm_type), capped at its
    median."""
    from repro_torch.jobs.synthetic import tensorflow_jobs
    job = tensorflow_jobs(0)[0]
    rng = np.random.default_rng(0)
    raw = job.space.points_raw
    names = list(job.space.names)
    energy = (raw[:, names.index("cluster_vcpus")] * job.runtime
              * rng.uniform(0.9, 1.1, job.space.n_points)
              * (1.0 + 0.2 * raw[:, names.index("vm_type")]))
    return energy.tolist(), float(np.quantile(energy, 0.5))


def _live(seed, t_max, **timeout):
    """``tests/test_autotune_and_launch.py``'s optimize_live calls."""
    runtimes = np.random.default_rng(seed).uniform(0.2, 3.0, 30)
    return {"grid": _GRID30, "runtimes": runtimes.tolist(), "price": 0.5,
            "t_max": t_max,
            "settings": dict(policy="lynceus", la=1, k_gh=2, refit="frozen",
                             **timeout),
            "kwargs": {"budget": 6.0, "seed": 0}}


TF_CNN = {"tensorflow_jobs": 0, "index": 0}


def golden_cases() -> list[dict]:
    """Every case's name, call and inputs (no outputs)."""
    e1, t1 = _energy(1, 12, 0.6)
    e5, t5 = _energy(5, 12, 0.6)
    e_tf, t_tf = _tf_cnn_energy()
    return [
        {"name": "cartesian_gh/weights_normalized", "call": "cartesian_gh",
         "kwargs": {"mus": [1.0, 2.0], "sigmas": [0.5, 0.3], "k": 3}},
        {"name": "cartesian_gh/full", "call": "cartesian_gh",
         "kwargs": {"mus": [0.0] * 3, "sigmas": [1.0] * 3, "k": 3,
                    "prune": 0.0}},
        {"name": "cartesian_gh/pruned", "call": "cartesian_gh",
         "kwargs": {"mus": [0.0] * 3, "sigmas": [1.0] * 3, "k": 3,
                    "prune": 0.05}},
        {"name": "multi_constraint/joint_feasibility",
         "call": "optimize_multi_constraint", "job": _grid_job(0),
         "metrics": {"energy": e1}, "thresholds": {"energy": t1},
         "settings": None, "kwargs": {"budget_b": 4.0, "seed": 0}},
        {"name": "multi_constraint/timeout", "call":
         "optimize_multi_constraint", "job": _grid_job(2),
         "metrics": {"energy": e5}, "thresholds": {"energy": t5},
         "settings": dict(policy="la0", n_trees=10, depth=3, timeout=True,
                          timeout_tmax_mult=1.0),
         "kwargs": {"budget_b": 4.0, "seed": 0}},
        {"name": "setup_cost/model", "call": "default_setup_cost",
         "job": _grid_job(0), "kwargs": {"boot_fee": 0.01}},
        {"name": "setup_cost/budget", "call": "optimize_with_setup_costs",
         "job": _grid_job(0), "setup": {"boot_fee": 0.05},
         "settings": dict(policy="la0", n_trees=10, depth=3),
         "kwargs": {"budget_b": 4.0, "seed": 0}},
        {"name": "optimize_live/budget", "call": "optimize_live",
         **_live(0, 1.5)},
        {"name": "optimize_live/timeout", "call": "optimize_live",
         **_live(3, 1.0, timeout=True, timeout_tmax_mult=1.0)},
        {"name": "tune/mixtral-8x22b", "call": "tune",
         "args": ["mixtral-8x22b", "train_4k", "single"],
         "kwargs": {"budget": 1000.0, "slo": 1.5, "mock": True, "la": 2}},
        {"name": "tf-cnn/multi_constraint", "call":
         "optimize_multi_constraint", "job": TF_CNN,
         "metrics": {"energy": e_tf}, "thresholds": {"energy": t_tf},
         "settings": None, "kwargs": {"budget_b": 3.0, "seed": 0}},
        {"name": "tf-cnn/multi_constraint/la0_timeout", "call":
         "optimize_multi_constraint", "job": TF_CNN,
         "metrics": {"energy": e_tf}, "thresholds": {"energy": t_tf},
         "settings": dict(policy="la0", timeout=True),
         "kwargs": {"budget_b": 3.0, "seed": 0}},
        {"name": "tf-cnn/setup_costs/la0", "call":
         "optimize_with_setup_costs", "job": TF_CNN, "setup": {},
         "settings": dict(policy="la0"),
         "kwargs": {"budget_b": 3.0, "seed": 0}},
    ]


def jax_autotune():
    """``repro.launch.autotune``, imported after the JAX backend is up (the
    module sets ``XLA_FLAGS`` when imported, which would otherwise change
    the suite's device count) and with ``XLA_FLAGS`` restored."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import autotune
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return autotune


def jax_api():
    """The JAX package's names for :func:`run_case` (the twin of
    ``chip_smoke.extension_api``)."""
    from repro.core import Settings, extensions
    from repro.core.optimizer import optimize_live
    from repro.core.space import DiscreteSpace
    from repro.jobs import tensorflow_jobs
    from repro.jobs.tables import JobTable
    autotune = jax_autotune()
    return types.SimpleNamespace(
        Settings=Settings, ext=extensions, optimize_live=optimize_live,
        DiscreteSpace=DiscreteSpace, JobTable=JobTable,
        tensorflow_jobs=tensorflow_jobs, autotune=autotune, kw={})


def port_api():
    return chip_smoke.extension_api("cpu")


def golden() -> dict:
    return json.loads(GOLDEN.read_text())


def golden_case(name: str) -> dict:
    return next(c for c in golden()["cases"] if c["name"] == name)


def golden_payload() -> dict:
    api = jax_api()
    cases = [dict(c, out=run_case(c, api)) for c in golden_cases()]
    return json.loads(json.dumps({
        "source": "repro.core.extensions, repro.core.optimizer."
                  "optimize_live and repro.launch.autotune.tune on the CPU",
        "cases": cases}))


def _inputs(case):
    return {k: v for k, v in case.items() if k != "out"}


def test_golden_file_holds_the_reference_tests_inputs():
    want = json.loads(json.dumps(golden_cases()))
    assert [_inputs(c) for c in golden()["cases"]] == want


@pytest.mark.parametrize("name", [c["name"] for c in golden_cases()
                                  if c["name"].startswith("tf-cnn/")])
def test_tf_cnn_entries_equal_fresh_jax_outputs(name):
    case = golden_case(name)
    assert run_case(_inputs(case), jax_api()) == case["out"]


@pytest.mark.parametrize("name", [
    c["name"] for c in golden_cases()
    if not c["name"].startswith(("tf-cnn/", "tune/"))])
def test_port_cpu_reproduces_golden_entry(name):
    """The small entries through the port on the CPU, with the runner the
    card uses; the tuner's entry is held in ``test_torch_autotune.py``."""
    case = golden_case(name)
    assert run_case(_inputs(case), port_api()) == case["out"]


if __name__ == "__main__":
    GOLDEN.parent.mkdir(parents=True, exist_ok=True)
    GOLDEN.write_text(json.dumps(golden_payload(), indent=1) + "\n")
    print(f"wrote {GOLDEN}")
