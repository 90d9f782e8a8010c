"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against ``repro.models.mla`` on DeepSeek-V3's smoke config (4 heads, q/k
width nope 16 + rope 8 = 24, v 16, kv_lora 16).

One layer's weights are drawn with numpy (``convert.numpy_params``) and go
to both packages with the same inputs; the JAX side runs under jit.
``mla_train`` goes through ``attend`` and the ``flash_attention`` op's
plain version with v zero-padded from 16 to 24; it is held at atol 1e-5 in
float32.  ``mla_decode`` writes the token's latent rows into the ring
caches in place and attends in latent space; it is held against the JAX
function (which returns updated copies) at atol 1e-5, on a filling ring
and on one that has rolled over, caches included.  ``cache_slot_positions``
with its ``device`` argument equals the JAX function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import mla as tmla

torch.set_num_threads(1)

ATOL = 1e-5
CFG = get_smoke_config("deepseek-v3-671b")
JCFG = jax_smoke_config("deepseek-v3-671b")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _weights(seed):
    w = convert.numpy_params(tmla.mla_specs(CFG, 1), seed)
    return jax.tree.map(lambda a: a[0], w)              # layer 0


_jtrain = jax.jit(lambda p, x, pos: jmla.mla_train(p, x, JCFG, pos,
                                                   impl="naive"))
_jdecode = jax.jit(lambda p, x, c, pos: jmla.mla_decode(p, x, JCFG, c, pos))


def test_mla_train_and_cache_rows_match_jax():
    w = _weights(1)
    x = np.random.default_rng(1).normal(size=(2, 13, CFG.d_model)).astype(
        np.float32)
    pos = np.arange(13)[None, :]
    rows = {}
    got = tmla.mla_train(convert.tree_from_numpy(w, "cpu"),
                         torch.as_tensor(x), CFG, torch.as_tensor(pos),
                         on_cache=rows.update)
    jw = jax.tree.map(jnp.asarray, w)
    want = _jtrain(jw, jnp.asarray(x), jnp.asarray(pos))
    assert got.shape == (2, 13, CFG.d_model)
    _close(got, want)
    # The cache rows the prefill keeps are the reference's latent.
    _, _, c_kv, k_pe = jmla._latent(jw, jnp.asarray(x), JCFG,
                                    jnp.asarray(pos))
    _close(rows["c_kv"], c_kv)
    _close(rows["k_pe"], k_pe[:, :, 0, :])
    for b, t in ((2, 7), (3, 64)):
        assert tmla.mla_cache_shape(CFG, b, t) == \
            jmla.mla_cache_shape(JCFG, b, t)


@pytest.mark.parametrize("t,pos", [(16, 9), (8, 21)])
def test_mla_decode_matches_jax(t, pos):
    """One token at ``pos`` against c_kv/k_pe rings of ``t`` slots:
    filling (slots past pos empty) and rolled over (pos >= t)."""
    w = _weights(2)
    rng = np.random.default_rng(t + pos)
    x = rng.normal(size=(2, 1, CFG.d_model)).astype(np.float32)
    cache = {k: rng.normal(size=s).astype(np.float32)
             for k, s in tmla.mla_cache_shape(CFG, 2, t).items()}
    tc = convert.tree_from_numpy(cache, "cpu")
    got, tc = tmla.mla_decode(convert.tree_from_numpy(w, "cpu"),
                              torch.as_tensor(x), CFG, tc, pos)
    want, jc = _jdecode(jax.tree.map(jnp.asarray, w), jnp.asarray(x),
                        jax.tree.map(jnp.asarray, cache), jnp.int32(pos))
    assert got.shape == (2, 1, CFG.d_model)
    _close(got, want)
    for k in ("c_kv", "k_pe"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("pos,t", [(5, 16), (40, 16), (-1, 8)])
def test_cache_slot_positions_match_jax(pos, t):
    want_p, want_v = jattn.cache_slot_positions(jnp.int32(pos), t)
    for dev in (None, "cpu", torch.device("cpu")):
        p, v = tattn.cache_slot_positions(pos, t, device=dev)
        assert p.device.type == "cpu"
        np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))
        np.testing.assert_array_equal(v.numpy(), np.asarray(want_v))
    # A tensor position keeps its device by default.
    p, _ = tattn.cache_slot_positions(torch.tensor(pos), t)
    np.testing.assert_array_equal(p.numpy(), np.asarray(want_p))
