"""The port's dense transformer serving path against ``repro.models`` on
the four dense smoke configs (gemma2-9b, gemma-2b, deepseek-7b,
granite-3-2b).

The weights are drawn with numpy (``convert.numpy_params``) and go to
both packages, as are the inputs (the JAX side under jit).  ``hidden_forward``, ``transformer_prefill`` (through the
``flash_attention`` op's plain version on the CPU), its ring caches and
teacher-forced
``transformer_decode`` steps (through ``decode_attention``'s plain version,
with Gemma2's softcap) are held against JAX in float32 at atol 2e-4, the
repo's own tolerance between a decode step and the parallel forward
(``tests/test_models_smoke.py:97``), and the caches at that atol plus rtol
1e-5.  The prompt (21 tokens) is longer than gemma2-9b-smoke's
``alt_window`` of 8, so its local layers' window masks in the prefill and
in decode.  The decode op's plain version with a softcap is held against
the JAX ``attend`` over a ring cache.
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
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import transformer as jtf
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels import decode_attention
from repro_torch.launch import serve
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.models.params import spec_leaves

torch.set_num_threads(1)

ATOL = 2e-4
CACHE_RTOL = 1e-5
DENSE = ("gemma2-9b", "gemma-2b", "deepseek-7b", "granite-3-2b")
# build_model(get_config(arch)).n_params() of the JAX package.
N_PARAMS = {"gemma2-9b": 9_241_705_984, "gemma-2b": 2_506_172_416,
            "deepseek-7b": 6_910_365_696, "granite-3-2b": 2_533_531_648}
FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                     compute_dtype="float32")
JFLAGS = JaxFlags(attn_impl="naive", loss_chunks=1, compute_dtype="float32")
PROMPT, STEPS = 21, 4


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("arch", DENSE)
def test_configs_and_specs_match_jax(arch):
    for full in (True, False):
        ours = get_config(arch) if full else get_smoke_config(arch)
        ref = jax_get_config(arch) if full else jax_smoke_config(arch)
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        jleaves = jax.tree_util.tree_flatten_with_path(
            jax_build(ref).specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
        tleaves = spec_leaves(build_model(ours).specs())
        assert [tuple(k.key for k in p) for p, _ in jleaves] == \
            [p for p, _ in tleaves]
        for (_, a), (_, b) in zip(jleaves, tleaves):
            assert (a.shape, a.axes, a.init, a.std) == \
                (b.shape, b.axes, b.init, b.std)
    assert build_model(get_config(arch)).n_params() == N_PARAMS[arch]


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_caches_and_decode_match_jax(arch):
    """The prefill's last logits and ring caches, then teacher-forced
    decode steps (logits, and the caches they update in place)."""
    cfg, jcfg = get_smoke_config(arch), jax_smoke_config(arch)
    jm, tm = jax_build(jcfg), build_model(cfg)
    weights = convert.numpy_params(tm.specs(), len(arch))
    jp = jax.tree.map(jnp.asarray, weights)
    tp = convert.tree_from_numpy(weights, "cpu")
    toks = np.random.default_rng(len(arch)).integers(
        0, cfg.vocab, size=(2, PROMPT + STEPS))
    cache_len = PROMPT + STEPS
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :PROMPT])},
                        FLAGS, cache_len)
    jl, jc = jax.jit(jm.prefill, static_argnums=(2, 3))(
        jp, {"tokens": jnp.asarray(toks[:, :PROMPT])}, JFLAGS, cache_len)
    assert tl.shape == (2, 1, cfg.vocab) and tl.dtype == torch.float32
    assert tm.cache_shapes(2, cache_len) == jm.cache_shapes(2, cache_len)
    _close(tl, jl)
    th, _ = ttf.hidden_forward(tp, cfg, FLAGS, {
        "tokens": torch.as_tensor(toks[:, :PROMPT])})
    jh, _ = jax.jit(jtf.hidden_forward, static_argnums=(1, 2))(
        jp, jcfg, JFLAGS, {"tokens": jnp.asarray(toks[:, :PROMPT])})
    _close(th, jh)

    def caches(got, want):
        assert set(got["layers"]) == set(want["layers"]) == {"k", "v"}
        for name in ("k", "v"):
            assert tuple(got["layers"][name].shape) == \
                want["layers"][name].shape
            _close(got["layers"][name], want["layers"][name],
                   rtol=CACHE_RTOL)

    caches(tc, jc)
    decode = jax.jit(jm.decode, static_argnums=(4,))
    for i in range(STEPS):
        pos = PROMPT + i
        tl, tc = tm.decode(tp, tc, torch.as_tensor(toks[:, pos:pos + 1]),
                           pos, FLAGS)
        jl, jc = decode(jp, jc, jnp.asarray(toks[:, pos:pos + 1]),
                        jnp.int32(pos), JFLAGS)
        _close(tl, jl)
    caches(tc, jc)


@pytest.mark.parametrize("t,pos,window", [
    (16, 12, None),       # filling: the slots past pos are empty
    (16, 40, None),       # the ring has rolled over
    (32, 40, 8),          # a local layer's window inside the ring
])
def test_softcapped_decode_matches_jax_attend(t, pos, window):
    """``attend`` over a ring cache with Gemma2's softcap (50), through the
    ``decode_attention`` op's plain version, against the JAX ``attend``
    over the same ring (its slot positions and validity)."""
    rng = np.random.default_rng(t + pos)
    q = (3 * rng.normal(size=(2, 1, 4, 16))).astype(np.float32)
    k = (3 * rng.normal(size=(2, t, 2, 16))).astype(np.float32)
    v = rng.normal(size=(2, t, 2, 16)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=50.0, scale=0.25)
    got = tattn.attend(*map(torch.as_tensor, (q, k, v)), pos=pos, **kw)
    k_pos, k_valid = jattn.cache_slot_positions(jnp.int32(pos), t)
    want = jattn.attend(*map(jnp.asarray, (q, k, v)), q_pos0=pos,
                        k_pos=k_pos, k_valid=k_valid, impl="naive", **kw)
    _close(got, want, 1e-5)
    # The softcap changes the answer: these scores reach past 50.
    nocap = decode_attention(torch.as_tensor(q[:, 0]),
                             torch.as_tensor(k).transpose(1, 2),
                             torch.as_tensor(v).transpose(1, 2), pos,
                             scale=0.25, window=window)
    assert (nocap - got[:, 0]).abs().max() > 1e-3


@pytest.mark.parametrize("change", [
    dict(mla=True, q_lora=32, kv_lora=16, rope_dim=8, nope_dim=8,
         v_head_dim=16),
    dict(n_experts=4, top_k=2, moe_d_ff=96),
    dict(mrope_sections=(4, 2, 2)),
    dict(family="audio", frontend_dim=24)])
def test_unported_paths_raise(change):
    """The four paths that the dense transformer refused before the rest
    of the zoo was ported (MLA, MoE, M-RoPE, the audio family), each on
    gemma2-9b-smoke (windowed, softcapped, post-norm): they build, and
    their prefill logits and ring caches equal the JAX package's."""
    cfg = dataclasses.replace(get_smoke_config("gemma2-9b"), **change)
    jcfg = dataclasses.replace(jax_smoke_config("gemma2-9b"), **change)
    jm, tm = jax_build(jcfg), build_model(cfg)
    weights = convert.numpy_params(tm.specs(), 5)
    rng = np.random.default_rng(5)
    if cfg.family == "audio":
        batch = {"features": rng.normal(size=(2, PROMPT, 24)).astype(
                     np.float32),
                 "mask": rng.random((2, PROMPT)) < 0.3}
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab, size=(2, PROMPT))}
    if cfg.mrope_sections:
        batch["positions"] = rng.integers(0, PROMPT, size=(3, 2, PROMPT))
    cache_len = PROMPT + STEPS
    tl, tc = tm.prefill(convert.tree_from_numpy(weights, "cpu"),
                        convert.tree_from_numpy(batch, "cpu"), FLAGS,
                        cache_len)
    jl, jc = jax.jit(jm.prefill, static_argnums=(2, 3))(
        jax.tree.map(jnp.asarray, weights),
        jax.tree.map(jnp.asarray, batch), JFLAGS, cache_len)
    assert tl.shape == (2, 1, cfg.vocab)
    _close(tl, jl)
    assert set(tc["layers"]) == set(jc["layers"])
    for name, want in jc["layers"].items():
        assert tuple(tc["layers"][name].shape) == want.shape
        _close(tc["layers"][name], want, rtol=CACHE_RTOL)


def test_serve_cli_on_cpu(capsys):
    """``launch.serve`` serves gemma2-9b-smoke on the CPU past its local
    window (the softcapped decode over the ring)."""
    serve.main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu",
                "--batch", "2", "--prompt-len", "20", "--gen", "4"])
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"arch": "gemma2-9b-smoke"' in out and '"generated": 4' in out
