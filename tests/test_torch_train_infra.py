"""The port's training substrate, case for case with
``tests/test_train_infra.py`` (its sharding-rule cases wait for the mesh
slice): the optimizer, microbatching, compression, checkpoints, the
fault-tolerant loop and the data pipeline, all on the CPU.  A
checkpoint the JAX package writes is read back by the port's manager
(one on-disk layout).
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import Prefetcher, SyntheticLM, make_batch
from repro_torch.distributed.compression import (compress_with_feedback,
                                                 dequantize, quantize)
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models.params import tree_leaves
from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                     clip_by_global_norm, global_norm,
                                     init_opt, warmup_cosine)
from repro_torch.runtime.fault_tolerance import (RunConfig,
                                                 StragglerWatchdog,
                                                 run_training)
from repro_torch.train.step import (abstract_state, make_train_state,
                                    make_train_step)

torch.set_num_threads(1)

FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=2,
                     compute_dtype="float32")


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
def test_adamw_reduces_quadratic():
    cfg = AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                      weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.3
    assert int(state.step) == 150 and state.step.dtype == torch.int32


def test_warmup_cosine_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_frac=0.1)
    lrs = [float(warmup_cosine(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in range(0, 101, 10)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(1.0)
    assert lrs[-1] == pytest.approx(0.1, abs=1e-3)
    assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))


def test_grad_clip_via_global_norm():
    cfg = AdamWConfig(clip_norm=1.0)
    g = {"a": torch.full((4,), 100.0)}
    params = {"a": torch.zeros((4,))}
    _, _, metrics = apply_updates(params, g, init_opt(params), cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(200.0)
    assert torch.allclose(clipped["a"], torch.full((4,), 0.5))
    assert float(global_norm({"x": torch.ones(9), "y": [torch.ones(16)]})) \
        == pytest.approx(5.0)


def test_inplace_update_gives_the_same_numbers():
    rng = np.random.default_rng(0)
    p = {"a": torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32)),
         "b": [torch.as_tensor(rng.normal(size=7).astype(np.float32))]}
    g = {"a": torch.as_tensor(rng.normal(size=(5, 3)).astype(np.float32)),
         "b": [torch.as_tensor(rng.normal(size=7).astype(np.float32))]}
    cfg = AdamWConfig(lr=0.01, warmup_steps=0)
    want = apply_updates(p, g, init_opt(p), cfg)
    copy = {"a": p["a"].clone(), "b": [p["b"][0].clone()]}
    state = init_opt(copy)
    got = apply_updates(copy, g, state, cfg, inplace=True)
    assert got[0]["a"] is copy["a"] and got[1].mu["a"] is state.mu["a"]
    for a, b in zip(tree_leaves(got[:2]), tree_leaves(want[:2])):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------- #
# microbatching and compression
# --------------------------------------------------------------------------- #
def _tiny_setup(**flag_over):
    cfg = get_smoke_config("deepseek-7b")
    model = build_model(cfg)
    flags = dataclasses.replace(FLAGS, **flag_over)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = make_train_state(model, torch.Generator().manual_seed(0), opt,
                             flags, device="cpu")
    step = make_train_step(model, flags, opt)
    data = SyntheticLM(cfg, batch=4, seq=16, seed=0, device="cpu")
    return state, step, data


def test_microbatch_equivalence():
    """mb=2 must produce (nearly) the same update as mb=1."""
    s1, step1, data = _tiny_setup(microbatches=1)
    s2, step2, _ = _tiny_setup(microbatches=2)
    b = data(0)
    s1, m1 = step1(s1, b)
    s2, m2 = step2(s2, b)
    assert set(m1) == {"loss", "grad_norm", "lr", "ce", "aux"}
    assert set(m2) == {"loss", "grad_norm", "lr"}
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), abs=1e-4)
    for a, c in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), atol=1e-4)


def test_quantize_dequantize_error_bound():
    rng = np.random.default_rng(0)
    x = torch.as_tensor((rng.normal(size=(256,)) * 7.0).astype(np.float32))
    q, s = quantize(x)
    assert q.dtype == torch.int8 and int(q.abs().max()) == 127
    err = (dequantize(q, s) - x).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-6
    # Half to even, as jnp.round: 2.5 quanta round to 2, 3.5 to 4.
    q, s = quantize(torch.tensor([127.0, 2.5, 3.5, -2.5]))
    assert q.tolist() == [127, 2, 4, -2] and float(s) == 1.0


def test_error_feedback_carries_residual():
    """Telescoping invariant: sum of emitted = N*g - r_N with |r_N| <= s/2,
    i.e. components below one quantum are never silently dropped forever."""
    g = {"w": torch.tensor([1e-4, 2e-4, 1.0])}
    r = {"w": torch.zeros(3)}
    total = torch.zeros(3)
    n = 50
    for _ in range(n):
        deq, r = compress_with_feedback(g, r)
        total = total + deq["w"]
    scale_bound = float(g["w"].abs().max() * 1.01) / 127.0
    err = (total - n * g["w"]).abs()
    assert bool((err <= scale_bound / 2 + 1e-6).all())
    q, s = quantize(g["w"])
    assert float(dequantize(q, s)[0]) == 0.0


def test_grad_compress_still_converges():
    state, step, data = _tiny_setup(grad_compress=True)
    assert len(tree_leaves(state.residual)) == len(tree_leaves(state.params))
    losses = []
    for i in range(15):
        state, m = step(state, data(i))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_abstract_state_allocates_nothing():
    model = build_model(get_smoke_config("gemma-2b"))
    st = abstract_state(model, dataclasses.replace(FLAGS,
                                                   grad_compress=True))
    leaves = tree_leaves(st)
    assert all(t.device.type == "meta" for t in leaves)
    assert st.params["embed"]["tokens"].dtype == torch.bfloat16
    assert st.opt.mu["embed"]["tokens"].dtype == torch.float32
    assert len(leaves) == 4 * len(tree_leaves(st.params)) + 1


# --------------------------------------------------------------------------- #
# checkpointing + fault tolerance
# --------------------------------------------------------------------------- #
def test_checkpoint_roundtrip_and_retention(tmp_path):
    ckpt = CheckpointManager(tmp_path, keep=2, async_write=False)
    state = {"a": torch.arange(5.0), "b": {"c": torch.ones((2, 2))}}
    for s in (1, 2, 3):
        ckpt.save(s, {k: (v * s if torch.is_tensor(v) else
                          {"c": v["c"] * s}) for k, v in state.items()})
    assert ckpt.all_steps() == [2, 3]                # pruned to keep=2
    restored = ckpt.restore(3, state)
    np.testing.assert_allclose(restored["a"].numpy(), np.arange(5.0) * 3)
    assert restored["b"]["c"].dtype == torch.float32
    assert not list(tmp_path.glob("*.tmp"))          # atomic


def test_port_reads_a_jax_checkpoint(tmp_path):
    """One layout: a TrainState-shaped tree the JAX manager wrote, read
    back by the port's manager into the port's TrainState."""
    import jax.numpy as jnp

    from repro.checkpoint.manager import CheckpointManager as JaxManager
    from repro.optim.adamw import OptState as JaxOpt
    from repro.train.step import TrainState as JaxState
    params = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": {"z": np.ones(4, np.float32)}}
    jstate = JaxState({k: jnp.asarray(v) if k == "w" else
                       {"z": jnp.asarray(v["z"])} for k, v in params.items()},
                      JaxOpt({"w": jnp.ones((2, 3)), "b": {"z": jnp.zeros(4)}},
                             {"w": jnp.zeros((2, 3)),
                              "b": {"z": jnp.ones(4)}}, jnp.int32(7)), ())
    JaxManager(tmp_path, async_write=False).save(7, jstate)
    like = convert.train_state_from_numpy(
        params, params, params, 0, device="cpu")
    mine = CheckpointManager(tmp_path)
    step, got = mine.restore_latest(like)
    assert step == 7 and int(got.opt.step) == 7
    assert torch.equal(got.params["w"], torch.as_tensor(params["w"]))
    assert torch.equal(got.opt.nu["b"]["z"], torch.ones(4))
    CheckpointManager(tmp_path / "port", async_write=False).save(7, got)
    import json
    names = lambda d: json.loads((d / "step_00000007" / "manifest.json")
                                 .read_text())["names"]
    assert names(tmp_path / "port") == names(tmp_path)


def test_restart_bit_exact(tmp_path):
    state, step, data = _tiny_setup()
    ckpt = CheckpointManager(tmp_path / "a", keep=3, async_write=False)
    out = run_training(step, state, data, ckpt,
                       RunConfig(total_steps=12, checkpoint_every=5,
                                 log_every=100, fail_at_step=None),
                       log=lambda *a: None)
    state2, step2, _ = _tiny_setup()
    ckpt2 = CheckpointManager(tmp_path / "b", keep=3, async_write=False)
    with pytest.raises(RuntimeError):
        run_training(step2, state2, data, ckpt2,
                     RunConfig(total_steps=12, checkpoint_every=5,
                               log_every=100, fail_at_step=9),
                     log=lambda *a: None)
    out2 = run_training(step2, state2, data, ckpt2,
                        RunConfig(total_steps=12, checkpoint_every=5,
                                  log_every=100), log=lambda *a: None)
    assert len(out2["step_times"]) == 12 - 5
    for a, b in zip(tree_leaves(out["state"]), tree_leaves(out2["state"])):
        assert torch.equal(a, b)


def test_straggler_watchdog():
    w = StragglerWatchdog(factor=2.0)
    assert not w.observe(1, 1.0)
    assert not w.observe(2, 1.1)
    assert w.observe(3, 5.0)                        # 5x the EMA
    assert len(w.stragglers) == 1


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #
def test_batches_deterministic_in_seed_step():
    cfg = get_smoke_config("gemma-2b")
    src = SyntheticLM(cfg, batch=4, seq=16, seed=1, device="cpu")
    a, b = src(7), src(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(a["tokens"], src(8)["tokens"])
    host = make_batch(cfg, "train", 4, 16, seed=1, step=7)
    assert np.array_equal(a["targets"].numpy(), host["targets"])


def test_vlm_batch_has_mrope_positions():
    cfg = get_smoke_config("qwen2-vl-2b")
    b = SyntheticLM(cfg, batch=2, seq=16, device="cpu")(0)
    assert tuple(b["positions"].shape) == (3, 2, 16)
    assert b["vision_embeds"].shape[1] == cfg.n_vision_tokens


def test_prefetcher_yields_in_order():
    cfg = get_smoke_config("gemma-2b")
    src = SyntheticLM(cfg, batch=2, seq=8, seed=0, device="cpu")
    pf = Prefetcher(src, start_step=3, depth=2)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [3, 4, 5, 6]
    assert torch.equal(got[1][1]["tokens"], src(4)["tokens"])


def test_synthetic_lm_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticLM(get_smoke_config("gemma-2b"), batch=2, seq=8)
