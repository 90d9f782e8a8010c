"""The port's xLSTM serving path against ``repro.models`` on
xlstm-125m-smoke.

The weights come from the JAX package's own init
(``model.init(PRNGKey(0))``) and go to the port through
``convert.tree_from_numpy`` (a list of per-block dicts); inputs are made
with numpy.  ``mlstm_block`` (through the ``ssm_scan`` op's plain version
on the CPU), ``mlstm_decode``, ``slstm_block`` (a Python loop over time),
``slstm_decode`` and the whole ``xlstm_prefill`` / ``xlstm_decode_step``
are held against JAX in float32 at atol 2e-4, the repo's own tolerance
between a decode step and the parallel forward
(``tests/test_models_smoke.py:97``), and the states at that atol plus
rtol 1e-5 (the mLSTM's matrix memory is a sum over the whole prompt,
summed in another order), as ``tests/test_torch_zamba.py`` states them.
The prompt (37 tokens) is two chunks of 16 and a ragged tail.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro.models import xlstm as jx
from repro_torch import convert
from repro_torch.configs import PORTED, get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models import xlstm as tx
from repro_torch.models.params import spec_leaves
from repro_torch.models.xlstm_model import block_kinds

torch.set_num_threads(1)

ATOL = 2e-4
STATE_RTOL = 1e-5
CFG = get_smoke_config("xlstm-125m")
JCFG = jax_smoke_config("xlstm-125m")
FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                     compute_dtype="float32")
JFLAGS = JaxFlags(attn_impl="naive", loss_chunks=1, compute_dtype="float32")
PROMPT = 37                      # 2 chunks of 16 and a ragged tail of 5
# The JAX blocks under jit (run eagerly, each op compiles on first use).
J_MLSTM, J_MLSTM_DECODE, J_SLSTM, J_SLSTM_DECODE = (
    jax.jit(fn, static_argnums=(2,)) for fn in (
        jx.mlstm_block, jx.mlstm_decode, jx.slstm_block, jx.slstm_decode))


@pytest.fixture(scope="module")
def models():
    jm = jax_build(JCFG)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tp = convert.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    jm = dataclasses.replace(
        jm, prefill=jax.jit(jm.prefill, static_argnums=(2, 3)),
        decode=jax.jit(jm.decode, static_argnums=(4,)))
    return jm, jp, build_model(CFG), tp


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _close_tree(got, want):
    gl, gdef = jax.tree.flatten(jax.tree.map(np.asarray, got))
    wl, wdef = jax.tree.flatten(want)
    assert gdef == wdef
    for g, w in zip(gl, wl):
        _close(g, w, rtol=STATE_RTOL)


def test_configs_specs_and_counts_match_jax():
    for full in (True, False):
        ours = get_config("xlstm-125m") if full else CFG
        ref = jax_get_config("xlstm-125m") if full else JCFG
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        jleaves = jax.tree_util.tree_flatten_with_path(
            jax_build(ref).specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
        tleaves = spec_leaves(build_model(ours).specs())
        key = lambda k: k.key if hasattr(k, "key") else k.idx
        assert [tuple(key(k) for k in p) for p, _ in jleaves] == \
            [p for p, _ in tleaves]
        for (_, a), (_, b) in zip(jleaves, tleaves):
            assert (a.shape, a.axes, a.init, a.std) == \
                (b.shape, b.axes, b.init, b.std)
    assert block_kinds(get_config("xlstm-125m")) == [
        "slstm" if i in (1, 7) else "mlstm" for i in range(12)]
    # The sLSTM's MLP width: -(-8d // 3 // 64)·64 = 2048 at d = 768.
    assert tx.slstm_specs(get_config("xlstm-125m"))["mlp"]["up"].shape == \
        (768, 2048)
    assert build_model(get_config("xlstm-125m")).n_params() == 200_167_760


@pytest.mark.parametrize("arch", PORTED)
def test_count_params_matches_jax(arch):
    assert build_model(get_config(arch)).n_params() == \
        jax_build(jax_get_config(arch)).n_params()


def test_tree_round_trips_and_numpy_params_match(models):
    """The JAX init's tree (a list of dicts) comes back as the same tree;
    ``numpy_params`` visits the leaves in ``jax.tree`` order, so both
    packages get the same arrays."""
    jm, jp, tm, tp = models
    assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == 3
    back = jax.tree.map(lambda t: t.numpy(), tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    w = convert.numpy_params(tm.specs(), 3)
    assert jax.tree.structure(w) == jax.tree.structure(jp)
    for (path, s), a in zip(spec_leaves(tm.specs()), jax.tree.leaves(w)):
        assert a.shape == s.shape and a.dtype == np.float32, path
    # The states: mLSTM dicts and sLSTM 4-tuples, kept as they are.
    shapes = tm.cache_shapes(2, 0)
    t = convert.tree_from_numpy(jax.tree.map(np.zeros, shapes,
                                             is_leaf=lambda x: isinstance(
                                                 x, tuple) and isinstance(
                                                 x[0], int)), "cpu")
    assert isinstance(t[1], tuple) and len(t[1]) == 4
    assert tuple(t[0]["c"].shape) == (2, 2, 64, 65)


@pytest.mark.parametrize("split", [None, 20])
def test_mlstm_block_and_decode_match_jax(models, split):
    """Block 0 over the prompt at once, or over its first 20 rows and then
    the rest from the carried state; then one decode step."""
    _, jp, _, tp = models
    x = np.random.default_rng(1).normal(
        size=(2, PROMPT, CFG.d_model)).astype(np.float32)
    p, jpb = tp["blocks"][0], jp["blocks"][0]

    def run(block, params, arr, cfg, conv):
        if split is None:
            return block(params, conv(arr), cfg)
        y0, st = block(params, conv(arr[:, :split]), cfg)
        y1, st = block(params, conv(arr[:, split:]), cfg, st)
        cat = torch.cat if conv is torch.as_tensor else jnp.concatenate
        return cat([y0, y1], 1), st

    ty, tst = run(tx.mlstm_block, p, x, CFG, torch.as_tensor)
    jy, jst = run(J_MLSTM, jpb, x, JCFG, jnp.asarray)
    _close(ty, jy)
    _close_tree(tst, jst)
    assert tuple(tst["c"].shape) == (2, 2, 64, 65)
    x1 = x[:, :1] * 0.5
    ty, tst2 = tx.mlstm_decode(p, torch.as_tensor(x1), CFG, tst)
    jy, jst2 = J_MLSTM_DECODE(jpb, jnp.asarray(x1), JCFG, jst)
    _close(ty, jy)
    _close_tree(tst2, jst2)


def test_slstm_block_and_decode_match_jax(models):
    """Block 1 (sLSTM): the loop over time from m = -inf (the first step's
    forget weight is 0, not NaN), then from the carried state, then one
    decode step."""
    _, jp, _, tp = models
    assert block_kinds(CFG)[1] == "slstm"
    x = np.random.default_rng(2).normal(
        size=(2, PROMPT, CFG.d_model)).astype(np.float32)
    p, jpb = tp["blocks"][1], jp["blocks"][1]
    ty, tst = tx.slstm_block(p, torch.as_tensor(x[:, :20]), CFG)
    jy, jst = J_SLSTM(jpb, jnp.asarray(x[:, :20]), JCFG)
    assert all(torch.isfinite(s).all() for s in tst)
    _close(ty, jy)
    _close_tree(tst, jst)
    ty, tst = tx.slstm_block(p, torch.as_tensor(x[:, 20:]), CFG, tst)
    jy, jst = J_SLSTM(jpb, jnp.asarray(x[:, 20:]), JCFG, jst)
    _close(ty, jy)
    _close_tree(tst, jst)
    ty, tst = tx.slstm_decode(p, torch.as_tensor(x[:, :1]), CFG, tst)
    jy, jst = J_SLSTM_DECODE(jpb, jnp.asarray(x[:, :1]), JCFG, jst)
    _close(ty, jy)
    _close_tree(tst, jst)


def test_prefill_and_decode_steps_match_jax(models):
    """``xlstm_prefill`` on a ragged prompt, then three teacher-forced
    ``xlstm_decode_step``s: logits and every block's state carried over."""
    jm, jp, tm, tp = models
    toks = np.random.default_rng(3).integers(0, CFG.vocab,
                                             size=(2, PROMPT + 3))
    tl, tst = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :PROMPT])},
                         FLAGS, 0)
    jl, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                         JFLAGS, 0)
    assert tl.shape == (2, 1, CFG.vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    _close_tree(tst, jst)
    for i in range(3):
        pos = PROMPT + i
        tl, tst = tm.decode(tp, tst, torch.as_tensor(toks[:, pos:pos + 1]),
                            pos, FLAGS)
        jl, jst = jm.decode(jp, jst, jnp.asarray(toks[:, pos:pos + 1]),
                            jnp.int32(pos), JFLAGS)
        _close(tl, jl)
        _close_tree(tst, jst)


def test_serve_cli_on_cpu(capsys):
    """``launch.serve`` serves the smoke arch on the CPU."""
    serve.main(["--arch", "xlstm-125m", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"arch": "xlstm-125m-smoke"' in out and '"generated": 4' in out
