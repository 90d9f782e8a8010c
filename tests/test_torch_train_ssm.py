"""Training the hybrid (Zamba2) and ssm (xLSTM) families: the port's
``Model.loss`` and every parameter's gradient against
``jax.value_and_grad`` of the reference's, the launcher on the CPU, and
the golden trajectories that ``chip_smoke.py`` holds the card against.

zamba2-smoke (5 Mamba2 blocks, the shared attention after blocks 2 and 4,
one tail block, chunk 16) and xlstm-125m-smoke (mLSTM, sLSTM, mLSTM;
chunk 16): weights drawn with numpy (``convert.numpy_params``), the
batch from ``make_batch`` (B 2, S 40: the scans' last chunk is partial),
float32, the loss in 2 chunks.  The loss and ``ce`` at rtol 1e-6, each
gradient leaf within 3e-5 of its largest magnitude: at these shapes each
package's float32 gradients of zamba2-smoke lie up to 1.35e-5 of a leaf's
largest from a float64 evaluation of the same loss (its ``a_log`` and
``dt_bias`` leaves, through the scans' decays; plain autograd through
the plain scan lies as far), so two correct evaluations may lie 2.7e-5
apart (1.9e-5 measured; xlstm-125m-smoke's 4.7e-6).  On the CPU the
scan's gradient is the plain backward through
``kernels.ssm_scan.ops.LinearScan`` and the shared attention's through
``FlashAttention``.

``src/repro_torch/testdata/golden_train_ssm.json`` holds the JAX
package's 3-step trajectory of each config (losses, gradient norms,
learning rates, and each parameter leaf's sum, sum of magnitudes and 16
sampled entries); the tests keep it fresh and check that the port's CPU
path reproduces it within ``chip_smoke.GOLDEN_TRAIN_SSM_TOL``.  Regenerate it
with ``PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_train_ssm.py``.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root, for the golden runner)
from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import RuntimeFlags as JaxFlags  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as ARCHS_ALL  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.data.pipeline import make_batch  # noqa: E402
from repro_torch.models import RuntimeFlags, build_model  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_unflatten  # noqa: E402

torch.set_num_threads(1)

ARCHS = ("zamba2-7b", "xlstm-125m")
FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=2,
                     compute_dtype="float32")
JFLAGS = JaxFlags(attn_impl="naive", loss_chunks=2, compute_dtype="float32")
LOSS_RTOL, GRAD_REL = 1e-6, 3e-5


def golden_meta(arch):
    """The golden trajectory's settings (``chip_smoke.train_golden_run``)."""
    return {"arch": arch, "param_seed": 0, "data_seed": 0, "batch": 4,
            "seq": 40, "steps": 3, "attn_impl": "naive", "loss_chunks": 2,
            "microbatches": 1, "grad_compress": False,
            "opt": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 50}}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    cfg, jm = get_smoke_config(arch), jax_build(jax_smoke_config(arch))
    model = build_model(cfg)
    weights = convert.numpy_params(model.specs(), len(arch))
    batch = make_batch(cfg, "train", 2, 40, seed=3, step=0)
    (jloss, jmet), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jm.loss(p, b, JFLAGS), has_aux=True))(
        jax.tree.map(jnp.asarray, weights), jax.tree.map(jnp.asarray, batch))
    leaves = [p.requires_grad_(True) for p in
              tree_leaves(convert.tree_from_numpy(weights, "cpu"))]
    loss, met = model.loss(tree_unflatten(weights, leaves),
                           convert.tree_from_numpy(batch, "cpu"), FLAGS)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert set(met) == set(jmet) == {"ce"}
    for got, want in ((loss, jloss), (met["ce"], jmet["ce"])):
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=LOSS_RTOL)
    jleaves = jax.tree.leaves(jgrads)
    assert len(grads) == len(jleaves)
    for g, w in zip(grads, jleaves):
        w = np.asarray(w)
        assert g is not None and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


def test_float64_witness_keeps_float64():
    """``chip_smoke._step0_f64``, the float64 witness of xlstm-125m's step
    0, on xlstm-125m-smoke: its gradient along a seeded direction over the
    mLSTM projections and gates equals the loss's central difference in
    float64 (step 1e-7, small enough that no clamp's kink lies within it:
    at 1e-5 some do; a float32 rounding anywhere on the path would move
    the difference by about 1), and each of those gradients lies within
    GRAD_REL of its largest magnitude from JAX's float32 gradient."""
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.ssm_scan.ref import linear_scan_ref
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xl_mod
    from repro_torch.models.layers import wide
    from repro_torch.models.params import tree_map

    arch = "xlstm-125m"
    assert wide(torch.zeros(1, dtype=torch.float64)).dtype == torch.float64
    assert wide(torch.zeros(1, dtype=torch.bfloat16)).dtype == torch.float32
    cfg, jm = get_smoke_config(arch), jax_build(jax_smoke_config(arch))
    model = build_model(cfg)
    weights = convert.numpy_params(model.specs(), 11)
    batch = make_batch(cfg, "train", 2, 40, seed=5, step=0)
    tbatch = convert.tree_from_numpy(batch, "cpu")
    params = convert.tree_from_numpy(weights, "cpu")
    keys = chip_smoke.SCAN_GRAD_KEYS
    loss64, grads = chip_smoke._step0_f64(model, FLAGS, params, tbatch,
                                          keys)
    assert grads and all(g.dtype == torch.float64 for g in grads.values())
    gen = np.random.default_rng(11)
    dirs = {name: torch.from_numpy(gen.standard_normal(tuple(g.shape)))
            for name, g in grads.items()}
    flags64 = RuntimeFlags(attn_impl="naive", loss_chunks=2,
                           compute_dtype="float64")

    def loss_at(step):
        p64 = tree_map(lambda t: t.double(),
                       convert.tree_from_numpy(weights, "cpu"))
        for name, d in dirs.items():
            i, key = name.split("/")
            p64["blocks"][int(i)][key] = p64["blocks"][int(i)][key] + step * d
        return float(model.loss(p64, tbatch, flags64)[0])

    ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = \
        linear_scan_ref
    try:
        with torch.no_grad():
            assert loss_at(0.0) == loss64
            eps = 1e-7
            diff = (loss_at(eps) - loss_at(-eps)) / (2 * eps)
    finally:
        ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = \
            linear_scan
    along = sum(float((g * dirs[n]).sum()) for n, g in grads.items())
    np.testing.assert_allclose(diff, along, rtol=1e-6)
    jgrads = jax.jit(jax.grad(lambda p, b: jm.loss(p, b, JFLAGS)[0]))(
        jax.tree.map(jnp.asarray, weights), jax.tree.map(jnp.asarray, batch))
    for name, g in grads.items():
        i, key = name.split("/")
        w = np.asarray(jgrads["blocks"][int(i)][key])
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=GRAD_REL * float(np.abs(w).max()))


def test_loss_refuses_remat():
    """Every arch's smoke loss under ``remat="full"`` equals its "none"
    loss (the checkpointed layers compute the same forward)."""
    for arch in ARCHS_ALL:
        cfg = get_smoke_config(arch)
        model = build_model(cfg)
        params = convert.tree_from_numpy(
            convert.numpy_params(model.specs(), 1), "cpu")
        batch = convert.tree_from_numpy(
            make_batch(cfg, "train", 2, 16, seed=1, step=0), "cpu")
        losses = [model.loss(params, batch, dataclasses.replace(
            FLAGS, remat=remat))[0] for remat in ("none", "full")]
        assert torch.equal(*losses), arch


def _jax_golden(arch):
    """The JAX package's trajectory from the numpy state, in the golden
    file's form."""
    from repro.data.pipeline import SyntheticLM
    from repro.optim.adamw import AdamWConfig, OptState
    from repro.train.step import TrainState, make_train_step

    meta = golden_meta(arch)
    model = jax_build(jax_smoke_config(arch))
    flags = JaxFlags(attn_impl=meta["attn_impl"],
                     loss_chunks=meta["loss_chunks"], compute_dtype="float32",
                     microbatches=meta["microbatches"])
    weights = convert.numpy_params(
        build_model(get_smoke_config(arch)).specs(), meta["param_seed"])
    params = jax.tree.map(jnp.asarray, weights)
    zeros = lambda: jax.tree.map(jnp.zeros_like, params)
    state = TrainState(params, OptState(zeros(), zeros(), jnp.int32(0)), ())
    step = jax.jit(make_train_step(model, flags,
                                   AdamWConfig(**meta["opt"])))
    data = SyntheticLM(model.cfg, batch=meta["batch"], seq=meta["seq"],
                       seed=meta["data_seed"])
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(meta["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    return {"meta": meta, **out,
            "params": chip_smoke.param_summary(
                jax.tree.map(np.asarray, state.params))}


def golden_from_jax():
    return {"runs": {arch: _jax_golden(arch) for arch in ARCHS}}


@pytest.mark.parametrize("arch", ARCHS)
def test_golden_file_is_fresh_and_the_port_reproduces_it(arch):
    golden = json.loads(chip_smoke.GOLDEN_TRAIN_SSM.read_text())["runs"]
    want = golden[arch]
    assert want["meta"] == golden_meta(arch)
    gaps = chip_smoke.compare_golden_train(_jax_golden(arch), want)
    assert all(g <= 1e-7 * max(lim, 1.0) for g, lim in gaps.values()), gaps
    port = chip_smoke.train_golden_run(want["meta"], torch.device("cpu"))
    gaps = chip_smoke.compare_golden_train(port, want,
                                           chip_smoke.GOLDEN_TRAIN_SSM_TOL)
    assert all(g <= lim for g, lim in gaps.values()), gaps


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_on_cpu(arch, capsys):
    """``launch.train`` trains each smoke config on the CPU; ``--layers``
    cuts the depth, and the run prints the cut."""
    from repro_torch.launch import train
    argv = ["--arch", arch, "--smoke", "--steps", "2", "--batch", "2",
            "--seq", "24", "--microbatches", "2", "--device", "cpu",
            "--ckpt", "none"]
    train.main(argv + ["--layers", "2"])
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["final_step"] == 2 and not out["preempted"]
    assert np.isfinite(out["final_loss"]) and out["device"] == "cpu"
    assert out["layers"] == 2
    assert out["reduced"] == {"n_layers": [get_smoke_config(arch).n_layers,
                                           2]}
    train.main(argv)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["layers"] == get_smoke_config(arch).n_layers
    assert out["reduced"] is None and np.isfinite(out["final_loss"])


if __name__ == "__main__":
    chip_smoke.GOLDEN_TRAIN_SSM.write_text(
        json.dumps(golden_from_jax(), indent=1) + "\n")
    print(f"wrote {chip_smoke.GOLDEN_TRAIN_SSM}")
