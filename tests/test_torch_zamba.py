"""The port's Zamba2 serving path against ``repro.models`` on zamba2-smoke.

The weights come from the JAX package's own init
(``model.init(PRNGKey(0))``) and go to the port through
``convert.tree_from_numpy``; inputs are made with numpy.  Blocks
(``rmsnorm``, ``rope``, ``causal_conv1d``, ``mamba2_block``,
``mamba2_decode``, ``attend`` in prefill and over a ring cache,
``ring_place``) and the whole ``zamba_prefill`` / ``zamba_decode`` are
held against JAX in float32 at atol 2e-4: the repo's own tolerance between
a decode step and the parallel forward (``tests/test_models_smoke.py:97``),
which covers two summation orders of the same float32 model, as here.  The
caches are held at that atol plus rtol 1e-5 (some 80 float32 ulps): the
SSM states are sums over the whole prompt, summed in another order, and
grow past 100 on these weights, where 2e-4 is about 13 ulps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.data.pipeline import make_batch as jax_make_batch
from repro.models import RuntimeFlags as JaxFlags
from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models.transformer import _ring_place as jax_ring_place
from repro_torch import convert
from repro_torch.configs import (ARCHS, PORTED, get_config,
                                 get_smoke_config)
from repro_torch.data.pipeline import make_batch
from repro_torch.launch.serve import generate
from repro_torch.models import RuntimeFlags, build_model
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models.params import spec_leaves

torch.set_num_threads(1)

ATOL = 2e-4
CACHE_RTOL = 1e-5
CFG = get_smoke_config("zamba2-7b")
JCFG = jax_smoke_config("zamba2-7b")
FLAGS = RuntimeFlags(attn_impl="naive", loss_chunks=1,
                     compute_dtype="float32")
JFLAGS = JaxFlags(attn_impl="naive", loss_chunks=1, compute_dtype="float32")
PROMPT = 37                      # 2 chunks of 16 and a padded tail of 5


@pytest.fixture(scope="module")
def models():
    jm = jax_build(JCFG)
    jp = jm.init(jax.random.PRNGKey(0), jnp.float32)
    tp = convert.tree_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    # Compiled once: the eager reference retraces its layer scans per call.
    jm = dataclasses.replace(
        jm, prefill=jax.jit(jm.prefill, static_argnums=(2, 3)),
        decode=jax.jit(jm.decode, static_argnums=(4,)))
    return jm, jp, build_model(CFG), tp


def _close(got, want, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol)


def _close_caches(got, want):
    assert set(got) == set(want)
    for name in got:
        _close(got[name], want[name], rtol=CACHE_RTOL)


def _layer(tree, i):
    return {k: v[i] for k, v in tree["mamba"].items()}


def test_configs_and_specs_match_jax():
    for full in (True, False):
        ours = get_config("zamba2-7b") if full else CFG
        ref = jax_get_config("zamba2-7b") if full else JCFG
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        jm = jax_build(ref)
        tm = build_model(ours)
        jleaves = jax.tree_util.tree_flatten_with_path(
            jm.specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
        tleaves = spec_leaves(tm.specs())
        assert [tuple(k.key for k in p) for p, _ in jleaves] == \
            [p for p, _ in tleaves]
        for (_, a), (_, b) in zip(jleaves, tleaves):
            assert (a.shape, a.axes, a.init, a.std) == \
                (b.shape, b.axes, b.init, b.std)
        assert tm.n_params() == jm.n_params()
    assert build_model(get_config("zamba2-7b")).n_params() == 6_750_249_552
    # Every arch of the reference is ported: its configs and spec trees
    # equal the JAX package's.
    assert PORTED == ARCHS
    for arch in ARCHS:
        for ours, ref in ((get_config(arch), jax_get_config(arch)),
                          (get_smoke_config(arch), jax_smoke_config(arch))):
            assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
            jleaves = jax.tree_util.tree_flatten_with_path(
                jax_build(ref).specs(), is_leaf=lambda x: hasattr(x, "axes"))[0]
            tleaves = spec_leaves(build_model(ours).specs())
            key = lambda k: k.key if hasattr(k, "key") else k.idx
            assert [tuple(map(key, p)) for p, _ in jleaves] == \
                [p for p, _ in tleaves], arch
            for (_, a), (_, b) in zip(jleaves, tleaves):
                assert (a.shape, a.axes, a.init, a.std) == \
                    (b.shape, b.axes, b.init, b.std), arch


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 4, 16)).astype(np.float32)
    w = (0.1 * rng.normal(size=(16,))).astype(np.float32)
    _close(tlayers.rmsnorm(torch.as_tensor(w), torch.as_tensor(x), 1e-6),
           jlayers.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-6), 1e-6)
    pos = np.arange(3, 12)[None, :].repeat(2, 0)
    _close(tlayers.rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0),
           jlayers.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), 1e-5)
    cw = rng.normal(size=(6, 4)).astype(np.float32)
    cx = rng.normal(size=(2, 7, 6)).astype(np.float32)
    cs = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for state in (None, cs):
        ty, tst = tlayers.causal_conv1d(
            torch.as_tensor(cw), torch.as_tensor(cx),
            None if state is None else torch.as_tensor(state))
        jy, jst = jlayers.causal_conv1d(
            jnp.asarray(cw), jnp.asarray(cx),
            None if state is None else jnp.asarray(state))
        _close(ty, jy, 1e-6)
        _close(tst, jst, 0)


def test_mamba2_block_and_decode_match_jax(models):
    _, jp, _, tp = models
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, PROMPT, CFG.d_model)).astype(np.float32)
    for i in (0, CFG.n_layers - 1):
        ty, tst = tssm.mamba2_block(_layer(tp, i), torch.as_tensor(x), CFG)
        jy, jst = jssm.mamba2_block(_layer(jp, i), jnp.asarray(x), JCFG)
        _close(ty, jy)
        _close_caches(tst, jst)
        x1 = x[:, :1] * 0.5
        ty, tst2 = tssm.mamba2_decode(_layer(tp, i), torch.as_tensor(x1),
                                      CFG, tst)
        jy, jst2 = jssm.mamba2_decode(_layer(jp, i), jnp.asarray(x1), JCFG,
                                      jst)
        _close(ty, jy)
        _close_caches(tst2, jst2)


@pytest.mark.parametrize("pos", [5, 13, 30])   # filling, full, rolled over
def test_attend_and_ring_cache_match_jax(pos):
    rng = np.random.default_rng(pos)
    b, s, h, kh, d, t = 2, 14, 4, 2, 16, 14
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kh, d)).astype(np.float32)
    _close(tattn.attend(*map(torch.as_tensor, (q, k, v)), causal=True),
           jattn.attend(*map(jnp.asarray, (q, k, v)), causal=True,
                        impl="naive"), 2e-5)
    for s_len in (9, 14, 20):
        kk = rng.normal(size=(b, s_len, kh, d)).astype(np.float32)
        _close(tattn.ring_place(torch.as_tensor(kk), s_len, t),
               jax_ring_place(jnp.asarray(kk), s_len, t), 0)
    # One token at ``pos`` against a ring cache of T slots.
    ck, cv = (rng.normal(size=(b, t, kh, d)).astype(np.float32)
              for _ in range(2))
    q1, k1, v1 = (rng.normal(size=(b, 1, n, d)).astype(np.float32)
                  for n in (h, kh, kh))
    tk, tv = tattn.write_kv(torch.as_tensor(ck.copy()),
                            torch.as_tensor(cv.copy()), torch.as_tensor(k1),
                            torch.as_tensor(v1), pos)
    jk, jv = jattn.write_kv(jnp.asarray(ck), jnp.asarray(cv),
                            jnp.asarray(k1), jnp.asarray(v1), pos)
    _close(tk, jk, 0)
    _close(tv, jv, 0)
    k_pos, k_valid = jattn.cache_slot_positions(jnp.int32(pos), t)
    tp_, tvalid = tattn.cache_slot_positions(pos, t)
    np.testing.assert_array_equal(tp_.numpy(), np.asarray(k_pos))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(k_valid))
    for window in (None, 6):
        got = tattn.attend(torch.as_tensor(q1), tk, tv, causal=True,
                           window=window, pos=pos)
        want = jattn.attend(jnp.asarray(q1), jk, jv, causal=True,
                            window=window, q_pos0=pos, k_pos=k_pos,
                            k_valid=k_valid, impl="naive")
        _close(got, want, 2e-5)


def test_prefill_and_decode_match_jax(models):
    """Logits and every cache after the prefill of a ragged prompt, then
    three decode steps fed the same tokens."""
    jm, jp, tm, tp = models
    rng = np.random.default_rng(2)
    toks = rng.integers(0, CFG.vocab, (2, PROMPT + 3)).astype(np.int32)
    cache_len = PROMPT + 8
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :PROMPT])},
                        JFLAGS, cache_len)
    tl, tc = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :PROMPT])},
                        FLAGS, cache_len)
    assert set(tc) == set(jc) == {"conv", "ssm", "attn_k", "attn_v"}
    assert {k: tuple(v.shape) for k, v in tc.items()} == \
        tm.cache_shapes(2, cache_len)
    _close(tl, jl)
    _close_caches(tc, jc)
    # The reference's own caches, converted, give its next logits.
    tok = toks[:, PROMPT:PROMPT + 1]
    cl, _ = tm.decode(tp, convert.tree_from_numpy(
        jax.tree.map(np.asarray, jc), "cpu"), torch.as_tensor(tok), PROMPT,
        FLAGS)
    _close(cl, jm.decode(jp, jc, jnp.asarray(tok), jnp.int32(PROMPT),
                         JFLAGS)[0])
    for step in range(3):
        pos = PROMPT + step
        tok = toks[:, pos:pos + 1]
        jl, jc = jm.decode(jp, jc, jnp.asarray(tok), jnp.int32(pos), JFLAGS)
        tl, tc = tm.decode(tp, tc, torch.as_tensor(tok), pos, FLAGS)
        _close(tl, jl)
        _close_caches(tc, jc)


def test_decode_matches_parallel_forward(models):
    """The port on its own: a decode step after a prefill of S - 1 tokens
    gives the logits of the prefill of all S (test_models_smoke.py:81)."""
    _, _, tm, tp = models
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, CFG.vocab, (2, 24)))
    _, caches = tm.prefill(tp, {"tokens": toks[:, :23]}, FLAGS, 32)
    ld, _ = tm.decode(tp, caches, toks[:, 23:24], 23, FLAGS)
    lf, _ = tm.prefill(tp, {"tokens": toks}, FLAGS, 32)
    _close(ld[:, 0], lf[:, 0])


def test_make_batch_matches_jax():
    for cfg, jcfg in ((CFG, JCFG), (get_config("zamba2-7b"),
                                    jax_get_config("zamba2-7b"))):
        for seed, step in ((0, 0), (3, 7)):
            ours = make_batch(cfg, "serve", 4, 50, seed=seed, step=step)
            ref = jax_make_batch(jcfg, "serve", 4, 50, seed=seed, step=step)
            assert set(ours) == set(ref)
            for k in ours:
                np.testing.assert_array_equal(ours[k], np.asarray(ref[k]))


def test_generate_gives_the_reference_greedy_tokens(models):
    """``generate`` on the CPU against the reference's greedy loop: equal
    tokens at every step up to the first whose top-2 logit margin in the
    reference is under 1e-3 (there a last-bit difference may pick the
    other token, and the continuations part)."""
    jm, jp, tm, tp = models
    gen = 6
    batch = make_batch(CFG, "serve", 2, PROMPT, seed=0, step=0)
    toks, tps, prefill_s = generate(
        tm, tp, FLAGS, {"tokens": torch.as_tensor(batch["tokens"])}, PROMPT,
        gen, PROMPT + gen)
    assert toks.shape == (2, gen) and tps > 0 and prefill_s > 0
    logits, caches = jm.prefill(jp, {"tokens": jnp.asarray(batch["tokens"])},
                                JFLAGS, PROMPT + gen)
    ok = np.ones(2, bool)
    compared = 0
    for i in range(gen):
        lg = np.asarray(logits[:, 0])
        top2 = np.sort(lg, axis=-1)[:, -2:]
        ok &= (top2[:, 1] - top2[:, 0]) > 1e-3
        want = lg.argmax(-1)
        np.testing.assert_array_equal(toks[ok, i].numpy(), want[ok])
        compared += int(ok.sum())
        if i + 1 < gen:
            logits, caches = jm.decode(jp, caches, jnp.asarray(want[:, None]),
                                       jnp.int32(PROMPT + i), JFLAGS)
    assert compared >= gen        # the check compared real tokens
