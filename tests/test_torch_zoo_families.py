"""The rest of the model zoo against ``repro.models``: the MoE family
(Mixtral-8x22B; DeepSeek-V3 with MLA and a dense prefix stack), the VLM
family (Qwen2-VL, M-RoPE) and the audio family (HuBERT, an encoder), on
their smoke configs.

The weights are drawn with numpy (``convert.numpy_params``) and go to both
packages, as do the batches (``make_batch``, held bitwise against the
reference's for the audio and VLM families).  The prefill's logits and
ring caches, the router loss of ``hidden_forward`` and teacher-forced
decode steps are held against JAX (under jit) in float32 at atol 2e-4,
the repo's tolerance between a decode step and the parallel forward
(``tests/test_models_smoke.py:97``), the caches at that atol plus rtol
1e-5.  The prompt (21 tokens) is longer than mixtral-smoke's window of 16,
so its ring rolls over in the prefill and in decode, as in
``tests/test_models_smoke.py:112``.  HuBERT's prefill gives the logits of
every frame and no cache.  ``layernorm`` and ``mrope`` (with its
``ValueError``) are held against the reference's.
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import RuntimeFlags as JaxFlags
from repro.models import build_model as jax_build
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.data.pipeline import make_batch
from repro_torch.launch import serve
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttf

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (the repo root: the prompt's inputs)

torch.set_num_threads(1)

ATOL = 2e-4
CACHE_RTOL = 1e-5
ARCHS = ("mixtral-8x22b", "deepseek-v3-671b", "qwen2-vl-2b", "hubert-xlarge")
FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                     compute_dtype="float32")
JFLAGS = JaxFlags(attn_impl="naive", loss_chunks=1, compute_dtype="float32")
PROMPT, STEPS = 21, 4


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def test_layernorm_and_mrope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    p = {"w": (0.1 * rng.normal(size=(16,))).astype(np.float32),
         "b": (0.1 * rng.normal(size=(16,))).astype(np.float32)}
    _close(tlayers.layernorm(convert.tree_from_numpy(p, "cpu"),
                             torch.as_tensor(x), 1e-6),
           jlayers.layernorm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                             1e-6), 1e-6)
    pos = rng.integers(0, 50, size=(3, 2, 9))
    for sections, theta in (((2, 3, 3), 10000.0), ((4, 2, 2), 1e6)):
        _close(tlayers.mrope(torch.as_tensor(x), torch.as_tensor(pos),
                             sections, theta),
               jlayers.mrope(jnp.asarray(x), jnp.asarray(pos), sections,
                             theta), 1e-5)
    # Equal ids in the three sections are plain RoPE.
    same = np.broadcast_to(pos[:1], pos.shape).copy()
    _close(tlayers.mrope(torch.as_tensor(x), torch.as_tensor(same),
                         (2, 3, 3)),
           tlayers.rope(torch.as_tensor(x), torch.as_tensor(pos[0])), 0)
    with pytest.raises(ValueError, match="sections"):
        tlayers.mrope(torch.as_tensor(x), torch.as_tensor(pos), (2, 3, 2))


@pytest.mark.parametrize("arch,b,s,seed,step", [
    ("qwen2-vl-2b", 2, 25, 0, 0), ("qwen2-vl-2b", 3, 40, 7, 3),
    ("hubert-xlarge", 2, 25, 0, 0), ("hubert-xlarge", 4, 33, 5, 1)])
def test_make_batch_matches_jax_bitwise(arch, b, s, seed, step):
    ours = make_batch(get_smoke_config(arch), "serve", b, s, seed=seed,
                      step=step)
    ref = jax_make_batch(jax_smoke_config(arch), "serve", b, s, seed=seed,
                         step=step)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and \
            ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_caches_and_decode_match_jax(arch):
    """The prefill's logits and ring caches, ``hidden_forward`` with the
    router loss, then teacher-forced decode steps (logits, and the caches
    they update in place)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jm, tm = jax_build(jcfg), build_model(cfg)
    weights = convert.numpy_params(tm.specs(), len(arch))
    jp = jax.tree.map(jnp.asarray, weights)
    tp = convert.tree_from_numpy(weights, "cpu")
    batch = make_batch(cfg, "serve", 2, PROMPT + STEPS, seed=len(arch),
                       step=0)
    pre = chip_smoke.prompt_batch(batch, PROMPT)
    tpre = convert.tree_from_numpy(pre, "cpu")
    jpre = jax.tree.map(jnp.asarray, pre)
    cache_len = PROMPT + STEPS
    tl, tc = tm.prefill(tp, tpre, FLAGS, cache_len)
    jl, jc = jax.jit(jm.prefill, static_argnums=(2, 3))(jp, jpre, JFLAGS,
                                                        cache_len)
    assert tl.dtype == torch.float32
    _close(tl, jl)
    th, taux = ttf.hidden_forward(tp, cfg, FLAGS, tpre)
    jh, jaux = jax.jit(jtf.hidden_forward, static_argnums=(1, 2))(
        jp, jcfg, JFLAGS, jpre)
    _close(th, jh)
    _close(taux, jaux, 1e-5)
    if cfg.is_encoder:
        assert tl.shape == (2, PROMPT, cfg.vocab) and tc == jc == {}
        with pytest.raises(ValueError, match="encoder"):
            tm.decode(tp, tc, torch.zeros((2, 1), dtype=torch.int64),
                      PROMPT, FLAGS)
        return
    assert tl.shape == (2, 1, cfg.vocab)
    assert tm.cache_shapes(2, cache_len) == jm.cache_shapes(2, cache_len)
    if cfg.is_moe:
        assert float(taux) > 0
    if cfg.window is not None:                      # mixtral: the ring
        assert cfg.window < PROMPT and \
            tc["layers"]["k"].shape[2] == cfg.window

    def caches(got, want):
        assert jax.tree.structure(jax.tree.map(np.asarray, want)) == \
            jax.tree.structure(jax.tree.map(lambda t: t.numpy(), got))
        for stack in want:
            for name in want[stack]:
                assert tuple(got[stack][name].shape) == \
                    want[stack][name].shape
                _close(got[stack][name], want[stack][name], rtol=CACHE_RTOL)

    caches(tc, jc)
    decode = jax.jit(jm.decode, static_argnums=(4,))
    toks = batch["tokens"]
    for i in range(STEPS):
        pos = PROMPT + i
        tl, tc = tm.decode(tp, tc, torch.as_tensor(toks[:, pos:pos + 1]),
                           pos, FLAGS)
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                        jnp.int32(pos), JFLAGS)
        _close(tl, jl)
    caches(tc, jc)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen2-vl-2b"])
def test_serve_cli_on_cpu(arch, capsys):
    """``launch.serve`` serves the smoke config on the CPU with its
    family's whole batch (Qwen2-VL's vision prefix and M-RoPE ids), past
    mixtral-smoke's window."""
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert f'"arch": "{get_smoke_config(arch).name}"' in out
    assert '"generated": 4' in out


def test_serve_refuses_an_encoder():
    with pytest.raises(SystemExit, match="encoder"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


def test_moe_flag_einsum_serves_the_same_logits():
    """``moe_impl="einsum"`` is the reference's comparison dispatch: the
    port computes the gather form for it, the same logits."""
    cfg = dataclasses.replace(get_smoke_config("mixtral-8x22b"),
                              capacity_factor=0.5)
    tm = build_model(cfg)
    tp = convert.tree_from_numpy(convert.numpy_params(tm.specs(), 3), "cpu")
    toks = torch.as_tensor(make_batch(cfg, "serve", 2, PROMPT, seed=3,
                                      step=0)["tokens"])
    a, _ = tm.prefill(tp, {"tokens": toks}, FLAGS, PROMPT)
    b, _ = tm.prefill(tp, {"tokens": toks},
                      dataclasses.replace(FLAGS, moe_impl="einsum"), PROMPT)
    assert torch.equal(a, b)
