"""The port's ``optimize_live`` and launch-config tuner plumbing against the
JAX package, on the CPU.

``optimize_live`` on ``tests/test_autotune_and_launch.py``'s two 30-point
calls (timeout off and on), bitwise against ``repro.core.optimizer.
optimize_live`` (one JAX run a call, shared with the golden file's check);
``build_space``, ``decode_point`` and ``mock_evaluator`` against
``repro.launch.autotune``; the command line with ``--mock --device cpu``;
the real evaluator, which needs ROADMAP A12, raising; and the card
required unless the CPU is asked for.  The tuner's selection loop at
budget 1000 is held in ``test_torch_autotune.py``.
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import Settings
from repro_torch.core.optimizer import optimize_live
from repro_torch.launch import autotune as tat
from test_torch_golden_extensions import (ROOT, golden_case, golden_cases,
                                          jax_api, jax_autotune, port_api,
                                          run_case)

torch.set_num_threads(1)

LIVE = [c["name"] for c in golden_cases() if c["call"] == "optimize_live"]


@functools.lru_cache(maxsize=None)
def _jax_out(name):
    case = next(c for c in golden_cases() if c["name"] == name)
    return run_case(case, jax_api())


@pytest.mark.parametrize("name", LIVE)
def test_optimize_live_matches_jax(name):
    case = next(c for c in golden_cases() if c["name"] == name)
    got = run_case(case, port_api())
    assert got == _jax_out(name)
    assert got["explored"] and got["costs"]


@pytest.mark.parametrize("name", LIVE)
def test_golden_entry_equals_fresh_jax_output(name):
    assert golden_case(name)["out"] == _jax_out(name)


def test_optimize_live_bills_pro_rata_in_the_reference_precisions():
    """The timeout case censors, and each censored probe's bill is the
    float64 ``c·τ/t`` rounded once into the float32 cost column."""
    out = _jax_out("optimize_live/timeout")
    assert out["censored"]
    assert out["spent"] == float(np.float32(6.0) - np.float32(
        6.0 - out["spent"]))


@pytest.mark.parametrize("is_moe", [False, True])
def test_build_space_and_decode_point_match_jax(is_moe):
    jat = jax_autotune()
    js, ts = jat.build_space(is_moe), tat.build_space(is_moe)
    assert js.names == ts.names
    for a in ("points_raw", "points", "thresholds"):
        assert getattr(js, a).tobytes() == getattr(ts, a).tobytes()
    assert [jat.decode_point(js, i, is_moe) for i in range(js.n_points)] \
        == [tat.decode_point(ts, i, is_moe) for i in range(ts.n_points)]


@pytest.mark.parametrize("is_moe,chips,seed", [(True, 256, 0),
                                                (False, 512, 3)])
def test_mock_evaluator_matches_jax_call_for_call(is_moe, chips, seed):
    """One normal drawn a call: the same order of calls gives the same
    (runtime, cost) sequence, repeats included."""
    jat = jax_autotune()
    js, ts = jat.build_space(is_moe), tat.build_space(is_moe)
    order = np.random.default_rng(seed).integers(0, js.n_points, 40)
    je = jat.mock_evaluator(js, is_moe, 100, chips, seed)
    te = tat.mock_evaluator(ts, is_moe, 100, chips, seed)
    assert [je(int(i)) for i in order] == [te(int(i)) for i in order]


def test_command_line_tunes_on_the_cpu_and_writes_its_file(tmp_path):
    """``--mock --device cpu`` at the reference test's budget (400: the
    bootstrap spends it) writes ``<out>/<arch>__<shape>__<mesh>.json``,
    equal to the tuner's output called in process, and prints its
    summary (the tuner against the JAX one: ``test_torch_autotune.py``)."""
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.autotune", "--arch",
         "mixtral-8x22b", "--budget", "400", "--slo", "1.5", "--mock",
         "--device", "cpu", "--out", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-2000:]
    written = json.loads(
        (tmp_path / "mixtral-8x22b__train_4k__single.json").read_text())
    want = tat.tune("mixtral-8x22b", "train_4k", "single", budget=400.0,
                    slo=1.5, mock=True, out_dir=None, log=lambda *a: None,
                    device="cpu")
    assert written == json.loads(json.dumps(want, default=str))
    summary = json.loads(out.stdout[out.stdout.index("{"):])
    assert summary["recommended"] == written["recommended"]
    assert summary["flags"] == written["flags"]


def test_tune_without_out_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tat.tune("mixtral-8x22b", "train_4k", "single", budget=400.0, slo=1.5,
             mock=True, out_dir=None, log=lambda *a: None, device="cpu")
    assert list(tmp_path.iterdir()) == []


def test_real_evaluator_raises_until_the_dry_run_is_ported():
    """The real evaluator returns a probe: one candidate's dry run (a
    subprocess on a fake world of 256) priced by its roofline step time;
    a candidate whose dry run fails bills 3600 s on 256 chips."""
    space = tat.build_space(False)
    logs = []
    step_s, cost = tat.real_evaluator("gemma-2b", "decode_32k", "single",
                                      space, False, 100, log=logs.append)(0)
    assert 0 < step_s < 3600.0 and np.isfinite(step_s)
    assert cost == pytest.approx(step_s * 100 * 256 * tat.PRICE_PER_CHIP_HOUR
                                 / 3600.0)
    assert "failed" not in logs[0]
    bad = tat.real_evaluator("no-such-arch", "decode_32k", "single", space,
                             False, 100, log=logs.append)(0)
    assert bad == (3600.0, 3600.0 * 100 * 256 * tat.PRICE_PER_CHIP_HOUR
                   / 3600.0)


def test_live_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = tat.build_space(False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        optimize_live(lambda i: (1.0, 1.0), space,
                      np.ones(space.n_points), 1.0, Settings(), budget=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tat.tune("mixtral-8x22b", "train_4k", "single", budget=400.0,
                 slo=1.5, mock=True, out_dir=None, log=lambda *a: None)
