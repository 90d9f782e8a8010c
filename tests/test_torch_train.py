"""The port's training step against ``repro.train.step`` on
gemma-2b-smoke, and the golden trajectory that ``chip_smoke.py`` holds
the card against.

Both packages start from one state: the weights drawn with numpy
(``convert.numpy_params``, seed 0), zero moments, step 0 (the port's via
``convert.train_state_from_numpy``), and take three steps of
``SyntheticLM``'s batches (B 4, S 16) through ``make_train_step`` (JAX's
jitted) with AdamW (lr 1e-3, 2 warmup steps).  Three settings:
microbatches 1 and 2 without compression, and 2 with int8 error-feedback
compression.  Held: each step's loss, gradient norm and learning rate at
rtol 2e-6 (float32 sums in two orders), and after three steps every
parameter at atol 5e-5 (a twentieth of the learning rate: Adam's first
step is about sign(g) lr, so an entry whose gradient sign differed would
be off by 2e-3) and every moment at atol 1e-7.  With compression an
int8 code may differ by one where the two gradients round to either side
of a half quantum (``residual``, the carried error, is then off by one
quantum, max|g + r| / 127): such entries, at most 1% of a leaf (7 of
2048 in one leaf on this input), may move their weight by up to 2 lr a
step and their moments by up to 5% of the leaf's largest, and the
carried errors keep their trace (at most 5% of a leaf's entries more than
1% of a quantum apart); every other entry is held as without
compression.

``src/repro_torch/testdata/golden_train.json`` holds the JAX package's
microbatch-1 trajectory (losses, gradient norms, learning rates, and
each parameter leaf's sum, sum of magnitudes and 16 sampled entries);
the tests keep it fresh and check that the port's CPU path reproduces it
within ``chip_smoke.GOLDEN_TRAIN_TOL``.  Regenerate it with
``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train.py``.
"""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root, for the golden runner)

torch.set_num_threads(1)

META = {"arch": "gemma-2b", "param_seed": 0, "data_seed": 0, "batch": 4,
        "seq": 16, "steps": 3, "attn_impl": "naive", "loss_chunks": 2,
        "microbatches": 1, "grad_compress": False,
        "opt": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 50}}
SETTINGS = [(1, False), (2, False), (2, True)]
METRIC_RTOL = 2e-6


def _jax_run(meta):
    """The JAX package's trajectory from the numpy state: per-step
    metrics and the final TrainState as numpy trees."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import RuntimeFlags, build_model
    from repro.optim.adamw import AdamWConfig, OptState
    from repro.train.step import TrainState, make_train_step
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config as port_config
    from repro_torch.models import build_model as port_model

    model = build_model(get_smoke_config(meta["arch"]))
    flags = RuntimeFlags(attn_impl=meta["attn_impl"],
                         loss_chunks=meta["loss_chunks"],
                         compute_dtype="float32",
                         microbatches=meta["microbatches"],
                         grad_compress=meta["grad_compress"])
    weights = convert.numpy_params(
        port_model(port_config(meta["arch"])).specs(), meta["param_seed"])
    params = jax.tree.map(jnp.asarray, weights)
    zeros = lambda: jax.tree.map(jnp.zeros_like, params)
    state = TrainState(params, OptState(zeros(), zeros(), jnp.int32(0)),
                       zeros() if meta["grad_compress"] else ())
    step = jax.jit(make_train_step(model, flags,
                                   AdamWConfig(**meta["opt"])))
    data = SyntheticLM(model.cfg, batch=meta["batch"], seq=meta["seq"],
                       seed=meta["data_seed"])
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(meta["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    return out, jax.tree.map(np.asarray, state)


def _port_run(meta):
    """The port's trajectory on the CPU from the same numpy state."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step

    model = build_model(get_smoke_config(meta["arch"]))
    weights = convert.numpy_params(model.specs(), meta["param_seed"])
    mu, nu = chip_smoke._zero_moments(weights)
    state = convert.train_state_from_numpy(
        weights, mu, nu, 0, chip_smoke._zero_moments(weights)[0]
        if meta["grad_compress"] else (), device="cpu")
    step = make_train_step(model, chip_smoke._train_flags(meta),
                           AdamWConfig(**meta["opt"]))
    data = SyntheticLM(model.cfg, batch=meta["batch"], seq=meta["seq"],
                       seed=meta["data_seed"], device="cpu")
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(meta["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    return out, state


def golden_from_jax(meta=META):
    metrics, state = _jax_run(meta)
    return {"meta": meta, **metrics,
            "params": chip_smoke.param_summary(state.params)}


@pytest.fixture(scope="module")
def jax_runs():
    return {s: _jax_run(dict(META, microbatches=s[0], grad_compress=s[1]))
            for s in SETTINGS}


@pytest.mark.parametrize("setting", SETTINGS,
                         ids=[f"mb{m}-{'int8' if c else 'f32'}"
                              for m, c in SETTINGS])
def test_trajectory_matches_jax(setting, jax_runs):
    from repro_torch.models.params import tree_leaves
    meta = dict(META, microbatches=setting[0], grad_compress=setting[1])
    want, jstate = jax_runs[setting]
    got, state = _port_run(meta)
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL,
                                   atol=0, err_msg=key)
    import jax
    assert int(state.opt.step) == int(jstate.opt.step) == META["steps"]
    trees = [(state.params, jstate.params, 5e-5),
             (state.opt.mu, jstate.opt.mu, 1e-7),
             (state.opt.nu, jstate.opt.nu, 1e-7)]
    if not meta["grad_compress"]:
        assert state.residual == () and jstate.residual == ()
        for got_t, want_t, atol in trees:
            for a, b in zip(tree_leaves(got_t), jax.tree.leaves(want_t)):
                np.testing.assert_allclose(a.numpy(), b, atol=atol, rtol=0)
        return
    # An int8 code may differ by one where the two float32 gradients round
    # to either side of a half quantum: that entry's carried error differs
    # by one quantum (twice the largest error), its gradient and first
    # moment by a quantum and a tenth of one, and Adam, which divides by
    # the gradient's scale, may move its weight by up to 2 lr a step.
    # Every other entry is held as without compression; such entries are
    # at most 1% of a leaf's weights and moments.  The carried errors hold
    # the flips' traces longer: at most 5% of a leaf's entries (33 of 2048
    # in ``wk`` on this input) more than 1% of a quantum apart, none more
    # than one quantum.
    far = 2 * META["opt"]["lr"] * META["steps"]
    for got_t, want_t, atol in trees:
        for a, b in zip(tree_leaves(got_t), jax.tree.leaves(want_t)):
            gap = np.abs(a.numpy() - b)
            limit = far if got_t is state.params else \
                0.05 * float(np.abs(b).max())
            assert (gap > atol).mean() <= 1e-2 and gap.max() <= limit, (
                (gap > atol).sum(), gap.max())
    for a, b in zip(tree_leaves(state.residual),
                    jax.tree.leaves(jstate.residual)):
        quantum = 2 * float(np.abs(b).max()) * 1.01 + 1e-12
        gap = np.abs(a.numpy() - b)
        assert gap.max() <= quantum and \
            (gap > 1e-2 * quantum).mean() <= 5e-2


def test_golden_file_is_fresh_and_the_port_reproduces_it(jax_runs):
    golden = json.loads(chip_smoke.GOLDEN_TRAIN.read_text())
    assert golden["meta"] == META
    metrics, state = jax_runs[(1, False)]
    fresh = {"meta": META, **metrics,
             "params": chip_smoke.param_summary(state.params)}
    gaps = chip_smoke.compare_golden_train(fresh, golden)
    assert all(g <= 1e-7 * max(lim, 1.0) for g, lim in gaps.values()), gaps
    port = chip_smoke.train_golden_run(META, torch.device("cpu"))
    gaps = chip_smoke.compare_golden_train(port, golden)
    assert all(g <= lim for g, lim in gaps.values()), gaps


def test_launcher_runs_on_cpu_and_refuses_what_is_not_ported(tmp_path,
                                                              capsys):
    """``launch.train`` trains gemma-2b-smoke on the CPU, checkpoints and
    resumes; ``--mesh 1x1`` trains as a world of one (gloo) and ``--remat
    full`` rematerialised, each to the same loss, bit for bit."""
    from repro_torch.launch import train
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "16", "--microbatches", "2", "--device", "cpu",
            "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    train.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["final_step"] == 4 and not out["preempted"]
    assert np.isfinite(out["final_loss"]) and out["device"] == "cpu"
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000004"
    train.main(argv[:4] + ["6"] + argv[5:])            # resumes at 4
    assert "[resume] restored checkpoint at step 4" in capsys.readouterr().out
    plain = argv[:-4] + ["--ckpt", "none"]
    train.main(plain)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    train.main(plain + ["--remat", "full"])
    remat = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert remat["final_loss"] == want["final_loss"]
    train.main(plain + ["--mesh", "1x1"])
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["mesh"] == "1x1" and want["mesh"] is None
    assert got["final_loss"] == want["final_loss"]


if __name__ == "__main__":
    chip_smoke.GOLDEN_TRAIN.write_text(json.dumps(golden_from_jax(),
                                                  indent=1) + "\n")
    print(f"wrote {chip_smoke.GOLDEN_TRAIN}")
