"""Sharded serving, kill-and-restart and the elastic restore of the
port's training state on gemma-2b-smoke, in one world of 4 spawned gloo
ranks:

* greedy prefill and 4 decode tokens under a (2, 2) mesh
  (``make_serve_step(model, flags, mesh, rules)``, the ring caches
  DTensors): the unsharded tokens (zamba2-smoke's in
  ``tests/test_torch_train_sharded_ssm.py``);
* a kill-and-restart cycle under (2, 2) through ``run_training`` with
  ``state_shardings`` (2 microbatches, int8 compression): bitwise the
  unbroken run;
* the elastic restore: a state trained a step under (2, 2), saved
  (``CheckpointManager.save`` gathers it, rank 0 writes), restored under
  (4, 1) (``restore(..., shardings)``): the same full tensors, on
  (4, 1)'s placements.

No rank imports jax.
"""

import pytest
import torch

from test_torch_train_sharded import (META, _bitwise, _flags, _serve,
                                      _setup)
from torch_world import jax_free, spawn_world



def _restart(mesh, out):
    """run_training under ``mesh``: 4 steps unbroken, and 4 steps killed
    at step 3 and resumed from its step-2 checkpoint."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.runtime.fault_tolerance import RunConfig, run_training
    from repro_torch.shard import make_rules
    from repro_torch.train.step import full, state_shardings
    cfg = dict(total_steps=4, checkpoint_every=2, log_every=100)
    quiet = lambda *a: None

    def fresh():
        model, flags, state, data, step = _setup(mesh, 2, True)
        return state, data, step, state_shardings(model, flags, mesh,
                                                  make_rules())

    state, data, step, sh = fresh()
    whole = run_training(step, state, data,
                         CheckpointManager(f"{out}/whole", keep=3),
                         RunConfig(**cfg), state_shardings=sh, log=quiet)
    ckpt = CheckpointManager(f"{out}/broken", keep=3)
    state, data, step, sh = fresh()
    try:
        run_training(step, state, data, ckpt,
                     RunConfig(**cfg, fail_at_step=3), state_shardings=sh,
                     log=quiet)
        raise AssertionError("the injected failure did not happen")
    except RuntimeError as exc:
        if "injected failure" not in str(exc):
            raise
    ckpt.wait()
    dist.barrier()                  # rank 0's step-2 checkpoint is down
    state, data, step, sh = fresh()
    resumed = run_training(step, state, data, ckpt, RunConfig(**cfg),
                           state_shardings=sh, log=quiet)
    return full(whole["state"]), full(resumed["state"])


def _elastic(state, out):
    """Save ``state`` (sharded on (2, 2)), restore it under (4, 1)."""
    import torch.distributed as dist
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models.params import tree_leaves
    from repro_torch.shard import make_rules
    from repro_torch.train.step import full, state_shardings
    ckpt = CheckpointManager(f"{out}/elastic", async_write=False)
    ckpt.save(3, state)
    dist.barrier()
    mesh = make_mesh((4, 1), ("data", "model"), device="cpu")
    model = build_model(get_smoke_config(META["arch"]))
    sh = state_shardings(model, _flags(2, True), mesh, make_rules())
    restored = ckpt.restore(3, state, sh)
    placed = all(tuple(r.placements) == s.placements and r.device_mesh is mesh
                 for r, s in zip(tree_leaves(restored), tree_leaves(sh))
                 if isinstance(r, torch.Tensor) and r.dim())
    return full(restored), placed


def _world(rank, out):
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.step import full
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    res = {"serve": _serve(mesh, META["arch"]),
           "restart": _restart(mesh, out)}
    _, _, state, data, step = _setup(mesh, 2, True)
    state, _ = step(state, data(0))
    res["trained"] = full(state)
    res["elastic"] = _elastic(state, out)
    if rank == 0:
        torch.save(res, f"{out}/results.pt")


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_sharded_infra")
    spawn_world(_world, 4, out)
    assert jax_free(out, 4)
    return torch.load(out / "results.pt", weights_only=False)


def test_sharded_serving_gives_the_unsharded_tokens(world):
    got, want = world["serve"]
    assert len(got) == 5 and all(torch.equal(a, b) for a, b in zip(got, want))


def test_kill_and_restart_under_a_mesh_is_bitwise(world):
    whole, resumed = world["restart"]
    assert _bitwise(whole, resumed)


def test_elastic_restore_onto_another_mesh(world):
    restored, placed = world["elastic"]
    assert placed and _bitwise(restored, world["trained"])
