"""The hybrid and ssm families' sharded training step against the JAX
package's, and the rest of the zoo's sharded loss against its unsharded
one.

One world of 4 spawned gloo ranks, a (2, 2) ("data", "model") mesh:

* zamba2-smoke and xlstm-125m-smoke (B 4, S 16, float32, from one numpy
  state): step 0's loss and every gradient, and 3 AdamW steps, held
  against the reference's ``jax.value_and_grad`` and its train step,
  each jitted with ``state_shardings`` on the suite's 4 CPU devices (a
  mesh of Auto axes: see ``test_torch_train_sharded._jax_sharded_run``);
* mixtral-8x22b, deepseek-v3-671b, qwen2-vl-2b and hubert-xlarge smoke:
  the sharded loss against the port's unsharded loss (no JAX run), rtol
  2e-6;
* zamba2-smoke served under (2, 2) (greedy prefill, 4 decode tokens; the
  Mamba2 states, conv states and the shared attention's caches
  DTensors): the unsharded tokens.

Step 0: the loss at rtol 1e-6 and each gradient leaf within 3e-5 of its
largest magnitude (``tests/test_torch_train_ssm.py``'s tolerance), and a
float64 witness of each arch's step-0 gradient (the port's loss in
float64 with the plain scan and attention under autograd): both packages'
sharded gradients lie within ``F64_REL`` of a leaf's largest from it
(measured: zamba2-smoke 1.75e-5 the port's, 1.45e-5 JAX's; xlstm-125m
7.3e-6 and 5.2e-6).

The trajectories: xlstm-125m-smoke at ``tests/test_torch_train.py``'s
tolerances (loss and gradient norm rtol 2e-6, parameters atol 5e-5,
moments atol 1e-7).  zamba2-smoke's gradient norm, parameters and first
moments need looser ones (``ZAMBA_TRAJ_TOL``): both packages' step-0
gradients lie as close to the float64 witness as each other (the witness
check above), and AdamW turns a gradient entry within float32's noise of
zero into a first update of either sign, ±lr.  After 3 steps the two
packages' sharded runs lie 3.1e-5 apart in the gradient norm, 9.0e-5 in
a parameter and 1.07e-6 in a first moment (2.9e-8 in a second, within
1e-7), and the port's own sharded and unsharded runs 1.2e-4 apart in the
gradient norm.  The tolerances are four times the gaps between the
packages.
"""

import dataclasses

import numpy as np
import pytest
import torch

from test_torch_train_sharded import (META, _flags, _hold, _jax_sharded_run,
                                      _serve, _setup, _trajectory)
from torch_world import jax_free, spawn_world

SSM_ARCHS = ("zamba2-7b", "xlstm-125m")
LOSS_ARCHS = ("mixtral-8x22b", "deepseek-v3-671b", "qwen2-vl-2b",
              "hubert-xlarge")
LOSS_RTOL, GRAD_REL, F64_REL = 1e-6, 3e-5, 2.5e-5
ZAMBA_TRAJ_TOL = {"grad_norm": 1.25e-4, "params": 3.6e-4, "mu": 4.3e-6,
                  "nu": 1e-7}


def _step0(mesh, arch):
    """Step 0's loss and every gradient (full tensors) on ``mesh``."""
    from repro_torch.shard import make_rules
    from repro_torch.train.step import full, loss_and_grads, mesh_context
    model, flags, state, data, _ = _setup(mesh, 1, False, arch)
    with mesh_context(mesh, make_rules()):
        loss, _, grads = loss_and_grads(model, flags, state.params, data(0))
        return full((loss, grads))


def _zoo_losses(mesh, rank):
    """{arch: (sharded loss, unsharded loss on rank 0)}."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import make_batch
    from repro_torch.models import build_model
    from repro_torch.shard import make_rules
    from repro_torch.train import step as st
    rules, flags, out = make_rules(), _flags(1, False), {}
    for arch in LOSS_ARCHS:
        model = build_model(get_smoke_config(arch))
        params = convert.tree_from_numpy(
            convert.numpy_params(model.specs(), META["param_seed"]), "cpu")
        host = make_batch(model.cfg, "train", META["batch"], META["seq"],
                          seed=META["data_seed"], step=0)
        batch = convert.tree_from_numpy(host, "cpu")
        with st.mesh_context(mesh, rules), torch.no_grad():
            loss, _ = model.loss(
                st.distribute(params, st.state_shardings(
                    model, flags, mesh, rules).params),
                st.distribute(batch, st.batch_shardings(batch, mesh, rules)),
                flags)
        loss = float(loss.full_tensor())
        with torch.no_grad():
            want = float(model.loss(params, batch, flags)[0]) \
                if rank == 0 else None
        out[arch] = (loss, want)
    return out


def _world(rank, out):
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {}
    for arch in SSM_ARCHS:
        res[f"{arch} step0"] = _step0(mesh, arch)
        res[arch] = _trajectory(mesh, 1, False, arch)[:2]
    res["zoo"] = _zoo_losses(mesh, rank)
    res["serve"] = _serve(mesh, "zamba2-7b")
    if rank == 0:
        torch.save(res, f"{out}/results.pt")


def _jax_step0(arch):
    """The reference's step-0 loss and gradients, ``value_and_grad``
    jitted with ``state_shardings``' parameter shardings on (2, 2)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import RuntimeFlags, build_model
    from repro.shard.api import activation_ctx, make_rules
    from repro.train.step import state_shardings
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config as port_config
    from repro_torch.models import build_model as port_model

    model = build_model(get_smoke_config(arch))
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=META["loss_chunks"],
                         compute_dtype="float32")
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    rules = make_rules()
    p_sh = state_shardings(model, flags, mesh, rules).params
    w = convert.numpy_params(port_model(port_config(arch)).specs(),
                             META["param_seed"])
    params = jax.device_put(jax.tree.map(jnp.asarray, w), p_sh)

    def loss(p, b):
        with activation_ctx(mesh, rules):
            return model.loss(p, b, flags)[0]

    batch = SyntheticLM(model.cfg, batch=META["batch"], seq=META["seq"],
                        seed=META["data_seed"])(0)
    value, grads = jax.jit(jax.value_and_grad(loss),
                           in_shardings=(p_sh, None))(params, batch)
    return float(value), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _attention64(q, k, v, *, scale=None, causal=True, window=None,
                 softcap=None, **_):
    """Attention in float64 (q [B, H, S, D], k and v [B, KH, T, D])."""
    rep = q.shape[1] // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    sc = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    s, t = q.shape[2], k.shape[2]
    qp = torch.arange(s)[:, None]
    kp = torch.arange(t)[None, :]
    ok = torch.ones((s, t), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window is not None:
        ok &= kp > qp - window
    sc = torch.where(ok, sc, float("-inf"))
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(sc, -1), v)


def _witness64(arch):
    """The port's step-0 gradient in float64: the parameters cast,
    compute_dtype float64, the plain scan and attention under autograd."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.ssm_scan.ops import linear_scan
    from repro_torch.kernels.ssm_scan.ref import linear_scan_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models import xlstm as xl_mod
    from repro_torch.models.params import tree_leaves, tree_unflatten
    model = build_model(get_smoke_config(arch))
    w = convert.numpy_params(model.specs(), META["param_seed"])
    leaves = [t.double().requires_grad_(True) for t in
              tree_leaves(convert.tree_from_numpy(w, "cpu"))]
    flags = dataclasses.replace(_flags(1, False), compute_dtype="float64")
    batch = SyntheticLM(model.cfg, batch=META["batch"], seq=META["seq"],
                        seed=META["data_seed"], device="cpu")(0)
    flash = attn_mod.flash_attention
    ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = \
        linear_scan_ref
    attn_mod.flash_attention = _attention64
    try:
        loss, _ = model.loss(tree_unflatten(w, leaves), batch, flags)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    finally:
        ssm_mod.chunked_linear_scan = xl_mod.chunked_linear_scan = \
            linear_scan
        attn_mod.flash_attention = flash
    return float(loss.detach()), [
        np.zeros(t.shape) if g is None else g.numpy()
        for t, g in zip(leaves, grads)]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawned world's results, with JAX's runs and the float64
    witnesses (made while the world runs)."""
    out = tmp_path_factory.mktemp("train_sharded_ssm")
    ranks = spawn_world(_world, 4, out, join=False)
    ref = {arch: {"step0": _jax_step0(arch),
                  "traj": _jax_sharded_run((2, 2), 1, False, arch),
                  "f64": _witness64(arch)} for arch in SSM_ARCHS}
    while not ranks.join():
        pass
    assert jax_free(out, 4)
    return torch.load(out / "results.pt", weights_only=False), ref


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_step0_gradients_match_jax_sharded(arch, world):
    from repro_torch.models.params import tree_leaves
    res, ref = world
    loss, grads = res[f"{arch} step0"]
    jloss, jgrads = ref[arch]["step0"]
    wloss, wgrads = ref[arch]["f64"]
    np.testing.assert_allclose(float(loss), jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), wloss, rtol=LOSS_RTOL)
    grads = [g.numpy() for g in tree_leaves(grads)]
    assert len(grads) == len(jgrads) == len(wgrads)
    for g, j, w in zip(grads, jgrads, wgrads):
        top = float(np.abs(w).max())
        np.testing.assert_allclose(g, j, rtol=0, atol=GRAD_REL * max(
            float(np.abs(j).max()), 1e-30))
        # Both packages' sharded gradients are float32 evaluations of the
        # witness's.
        assert np.abs(g - w).max() <= F64_REL * top
        assert np.abs(j - w).max() <= F64_REL * top


def test_xlstm_trajectory_matches_jax_sharded(world):
    res, ref = world
    got, state = res["xlstm-125m"]
    want, jstate = ref["xlstm-125m"]["traj"]
    _hold(got, state, want, jstate, False)


def test_zamba_trajectory_matches_jax_sharded(world):
    import jax
    from repro_torch.models.params import tree_leaves
    res, ref = world
    got, state = res["zamba2-7b"]
    want, jstate = ref["zamba2-7b"]["traj"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-6)
    np.testing.assert_allclose(got["lr"], want["lr"], rtol=2e-6)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=ZAMBA_TRAJ_TOL["grad_norm"])
    for name, got_t, want_t in (("params", state.params, jstate.params),
                                ("mu", state.opt.mu, jstate.opt.mu),
                                ("nu", state.opt.nu, jstate.opt.nu)):
        for a, b in zip(tree_leaves(got_t), jax.tree.leaves(want_t)):
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=ZAMBA_TRAJ_TOL[name])


@pytest.mark.parametrize("arch", LOSS_ARCHS)
def test_zoo_sharded_loss_matches_unsharded(arch, world):
    got, want = world[0]["zoo"][arch]
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_zamba_sharded_serving_gives_the_unsharded_tokens(world):
    got, want = world[0]["serve"]
    assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got, want))
