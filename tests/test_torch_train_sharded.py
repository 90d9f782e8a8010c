"""The port's sharded training and serving step (``train.step`` with a
``DeviceMesh``) against the JAX package's sharded step on gemma-2b-smoke.

One world of 4 spawned gloo ranks runs every setting of the file:

* (2, 2) with 2 microbatches and int8 compression, 3 steps, twice (the
  two runs bitwise equal), and (4, 1) with one microbatch, 3 steps: each
  held against the JAX step jitted with ``state_shardings`` on the
  suite's 4 CPU devices as ``src/repro/launch/train.py:57-64`` builds it,
  from one numpy state, at the tolerances of ``tests/test_torch_train.py``
  (loss and gradient norm rtol 2e-6, parameters atol 5e-5, moments 1e-7;
  an int8 code that rounds to the other side of a half quantum as there);
* (2, 2) as above under ``remat="full"``: bitwise the run without;
* (1, 1) on each rank alone: bitwise the unsharded step.

Rank 0 writes full tensors (``train.step.full``) for the parent to
compare; no rank imports jax.  The JAX runs are made while the world
runs.  Sharded serving, kill-and-restart and the elastic restore are in
``tests/test_torch_train_sharded_infra.py``.
"""

import numpy as np
import pytest
import torch

from torch_world import jax_free, single_rank_mesh, spawn_world

META = {"arch": "gemma-2b", "param_seed": 0, "data_seed": 0, "batch": 4,
        "seq": 16, "steps": 3, "loss_chunks": 2,
        "opt": {"lr": 1e-3, "warmup_steps": 2, "total_steps": 50}}
# (name, mesh shape, microbatches, grad_compress)
SETTINGS = [("2x2-mb2-int8", (2, 2), 2, True), ("4x1", (4, 1), 1, False)]
METRIC_RTOL = 2e-6


def _flags(mb, compress, remat="none"):
    from repro_torch.models import RuntimeFlags
    return RuntimeFlags(attn_impl="naive", loss_chunks=META["loss_chunks"],
                        compute_dtype="float32", microbatches=mb,
                        grad_compress=compress, remat=remat)


def _numpy_state(specs, compress):
    from repro_torch import convert
    from repro_torch.models.params import tree_map
    w = convert.numpy_params(specs, META["param_seed"])
    zeros = tree_map(np.zeros_like, w)
    return w, zeros, (zeros if compress else ())


def _setup(mesh, mb, compress, arch=META["arch"], remat="none"):
    """(model, flags, sharded state, sharded data, step) on ``mesh``."""
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM, make_batch
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.shard import make_rules
    from repro_torch.train import step as st
    model = build_model(get_smoke_config(arch))
    flags = _flags(mb, compress, remat)
    rules = make_rules()
    w, zeros, res = _numpy_state(model.specs(), compress)
    state = st.distribute(
        convert.train_state_from_numpy(w, zeros, zeros, 0, res,
                                       device="cpu"),
        st.state_shardings(model, flags, mesh, rules))
    host0 = make_batch(model.cfg, "train", META["batch"], META["seq"],
                       seed=META["data_seed"], step=0)
    data = SyntheticLM(model.cfg, batch=META["batch"], seq=META["seq"],
                       seed=META["data_seed"], device="cpu",
                       shardings=st.batch_shardings(host0, mesh, rules))
    step = st.make_train_step(model, flags, AdamWConfig(**META["opt"]),
                              mesh, rules)
    return model, flags, state, data, step


def _trajectory(mesh, mb, compress, arch=META["arch"], remat="none"):
    """3 steps: (per-step loss, grad norm, lr; the final state as full
    tensors; the final sharded state)."""
    from repro_torch.train.step import full
    _, _, state, data, step = _setup(mesh, mb, compress, arch, remat)
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(META["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    return out, full(state), state


def _unsharded(mb, compress, arch=META["arch"]):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import make_train_step
    model = build_model(get_smoke_config(arch))
    w, zeros, res = _numpy_state(model.specs(), compress)
    state = convert.train_state_from_numpy(w, zeros, zeros, 0, res,
                                           device="cpu")
    step = make_train_step(model, _flags(mb, compress),
                           AdamWConfig(**META["opt"]))
    data = SyntheticLM(model.cfg, batch=META["batch"], seq=META["seq"],
                       seed=META["data_seed"], device="cpu")
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(META["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    return out, state


def _tokens(prefill, decode, params, batch):
    """Greedy prefill of 16 tokens into a 24-slot cache, then 4 decode
    tokens; every token as a full tensor."""
    from repro_torch.train.step import full
    tok, caches = prefill(params, batch, 24)
    out = [tok]
    for i in range(4):
        tok, caches = decode(params, caches, tok, META["seq"] + i)
        out.append(tok)
    return full(out)


def _serve(mesh, arch):
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import build_model
    from repro_torch.shard import make_rules
    from repro_torch.train import step as st
    model = build_model(get_smoke_config(arch))
    flags, rules = _flags(1, False), make_rules()
    params = convert.tree_from_numpy(
        convert.numpy_params(model.specs(), META["param_seed"]), "cpu")
    batch = {"tokens": SyntheticLM(model.cfg, batch=META["batch"],
                                   seq=META["seq"], seed=1,
                                   device="cpu")(0)["tokens"]}
    with torch.no_grad():
        got = _tokens(*st.make_serve_step(model, flags, mesh, rules),
                      st.distribute(params, st.state_shardings(
                          model, flags, mesh, rules).params),
                      st.distribute(batch, st.batch_shardings(batch, mesh,
                                                              rules)))
        want = _tokens(*st.make_serve_step(model, flags), params, batch)
    return got, want


def _world(rank, out):
    from repro_torch.launch.mesh import make_mesh
    res = {}
    mesh22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    mesh41 = make_mesh((4, 1), ("data", "model"), device="cpu")
    res["2x2-mb2-int8"] = _trajectory(mesh22, 2, True)[:2]
    res["2x2-mb2-int8 again"] = _trajectory(mesh22, 2, True)[:2]
    res["2x2-mb2-int8 remat"] = _trajectory(mesh22, 2, True,
                                            remat="full")[:2]
    res["4x1"] = _trajectory(mesh41, 1, False)[:2]
    one = _trajectory(single_rank_mesh(), 2, True)[:2]
    if rank == 0:
        res["1x1"] = one
        res["unsharded"] = _unsharded(2, True)
        torch.save(res, f"{out}/results.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The spawned world's results, and JAX's sharded runs (made while the
    world runs)."""
    out = tmp_path_factory.mktemp("train_sharded")
    ranks = spawn_world(_world, 4, out, join=False)
    jax_runs = {name: _jax_sharded_run(shape, mb, compress)
                for name, shape, mb, compress in SETTINGS}
    while not ranks.join():
        pass
    assert jax_free(out, 4)
    res = torch.load(out / "results.pt", weights_only=False)
    return res, jax_runs


def _jax_sharded_run(shape, mb, compress, arch=META["arch"]):
    """The JAX package's trajectory from the numpy state, its step jitted
    with ``state_shardings`` on a ("data", "model") mesh of ``shape``.
    The mesh's axes are Auto, the kind ``repro.launch.mesh.make_mesh``
    made when the reference was written: this JAX's ``jax.make_mesh``
    makes Explicit axes by default, on which the reference's ``constrain``
    (``with_sharding_constraint``) and its embedding gather raise."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config
    from repro.data.pipeline import SyntheticLM
    from repro.models import RuntimeFlags, build_model
    from repro.optim.adamw import AdamWConfig, OptState
    from repro.shard.api import make_rules
    from repro.train.step import TrainState, make_train_step, state_shardings
    from repro_torch.configs import get_smoke_config as port_config
    from repro_torch.models import build_model as port_model

    model = build_model(get_smoke_config(arch))
    flags = RuntimeFlags(attn_impl="naive", loss_chunks=META["loss_chunks"],
                         compute_dtype="float32", microbatches=mb,
                         grad_compress=compress)
    mesh = jax.make_mesh(shape, ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2,
                         devices=jax.devices()[:int(np.prod(shape))])
    rules = make_rules()
    st_sh = state_shardings(model, flags, mesh, rules)
    w, zeros, res = _numpy_state(port_model(port_config(arch)).specs(),
                                 compress)
    to_jax = lambda t: jax.tree.map(jnp.asarray, t)
    state = TrainState(to_jax(w), OptState(to_jax(zeros), to_jax(zeros),
                                           jnp.int32(0)), to_jax(res))
    state = jax.device_put(state, st_sh)
    step = jax.jit(make_train_step(model, flags, AdamWConfig(**META["opt"]),
                                   mesh, rules),
                   in_shardings=(st_sh, None), out_shardings=(st_sh, None))
    data = SyntheticLM(model.cfg, batch=META["batch"], seq=META["seq"],
                       seed=META["data_seed"])
    out = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(META["steps"]):
        state, metrics = step(state, data(i))
        for key in out:
            out[key].append(float(metrics[key]))
    return out, jax.tree.map(np.asarray, state)


def _hold(got, state, want, jstate, compress):
    """``tests/test_torch_train.py``'s comparison of two trajectories."""
    import jax
    from repro_torch.models.params import tree_leaves
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(got[key], want[key], rtol=METRIC_RTOL,
                                   atol=0, err_msg=key)
    assert int(state.opt.step) == int(jstate.opt.step) == META["steps"]
    trees = [(state.params, jstate.params, 5e-5),
             (state.opt.mu, jstate.opt.mu, 1e-7),
             (state.opt.nu, jstate.opt.nu, 1e-7)]
    if not compress:
        assert state.residual == () and jstate.residual == ()
        for got_t, want_t, atol in trees:
            for a, b in zip(tree_leaves(got_t), jax.tree.leaves(want_t)):
                np.testing.assert_allclose(a.numpy(), b, atol=atol, rtol=0)
        return
    # An int8 code may differ by one where the two gradients round to
    # either side of a half quantum (see tests/test_torch_train.py).
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


def _bitwise(a, b) -> bool:
    from repro_torch.models.params import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


@pytest.mark.parametrize("name,shape,mb,compress", SETTINGS,
                         ids=[s[0] for s in SETTINGS])
def test_sharded_trajectory_matches_jax_sharded(name, shape, mb, compress,
                                                world):
    res, jax_runs = world
    want, jstate = jax_runs[name]
    got, state = res[name]
    _hold(got, state, want, jstate, compress)


def test_two_runs_of_one_mesh_are_bitwise_equal(world):
    got, state = world[0]["2x2-mb2-int8"]
    again, state2 = world[0]["2x2-mb2-int8 again"]
    assert got == again and _bitwise(state, state2)


def test_remat_full_on_the_mesh_is_bitwise_the_step_without(world):
    """``remat="full"`` on (2, 2): the layers' recomputation runs in the
    backward under the step's activation rules, and the trajectory is
    bitwise the one without remat (so held to JAX's sharded step too)."""
    got, state = world[0]["2x2-mb2-int8 remat"]
    want, state0 = world[0]["2x2-mb2-int8"]
    assert got == want and _bitwise(state, state0)


def test_mesh_of_one_is_bitwise_the_unsharded_step(world):
    got, state = world[0]["1x1"]
    want, ustate = world[0]["unsharded"]
    assert got == want and _bitwise(state, ustate)
