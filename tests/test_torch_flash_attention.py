"""The port's prefill attention op against ``repro.kernels.flash_attention``.

On CPU tensors ``repro_torch.kernels.flash_attention`` runs its plain
version.  It is held against the JAX package's ``attention_ref`` and its
Pallas kernel in interpret mode, over the shapes, masks and tolerances of
``tests/test_kernels.py`` (2e-5 in float32, 5e-2 in bfloat16): GQA, MQA,
MHA, cross lengths, causal, sliding window, softcap and non-causal.  The
inputs are made with numpy and rounded to bfloat16 identically on both
sides.  The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's dispatch rules are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_call
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import kernel as tkernel

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _inputs(shape_q, shape_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape_q).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32),
            rng.normal(size=shape_kv).astype(np.float32))


def _f32(a):
    return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("b,h,kh,s,t,d", [
    (2, 4, 2, 128, 128, 64),
    (1, 4, 1, 64, 128, 32),      # MQA, cross lengths
    (1, 6, 6, 128, 128, 16),     # MHA, odd head count
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("causal,window,softcap", [
    (True, None, None), (True, 32, None), (True, None, 30.0),
    (False, None, None),
])
def test_matches_jax_ref_and_interpret(b, h, kh, s, t, d, dtype, causal,
                                       window, softcap):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs((b, h, s, d), (b, kh, t, d), seed=s + t + d + h)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = flash_attention(*(torch.as_tensor(a).to(tdt) for a in arrs), **kw)
    assert got.dtype == tdt and got.shape == (b, h, s, d)
    j = tuple(jnp.asarray(a, jdt) for a in arrs)
    for want in (attention_ref(*j, **kw),
                 flash_attention_call(*j, bq=64, bk=64, interpret=True,
                                      **kw)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_gemma2_local_layer_shape():
    """gemma2-9b's head layout (H = 16, KH = 8, D = 256) with its local
    window and softcap, cut to S = T = 64 and window 24 so the window
    binds."""
    arrs = _inputs((1, 16, 64, 256), (1, 8, 64, 256), seed=9)
    kw = dict(causal=True, window=24, softcap=50.0, scale=256 ** -0.5)
    got = flash_attention(*map(torch.as_tensor, arrs), **kw)
    want = attention_ref(*map(jnp.asarray, arrs), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), **_tol("float32"))


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    q, k, v = map(torch.as_tensor, _inputs((1, 2, 8, 16), (1, 1, 8, 16), 0))
    before = tkernel.flash_attention_cuda.launches
    out = flash_attention(q, k, v, bq=4, bk=4)
    assert out.shape == q.shape
    assert tkernel.flash_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention(q, k, v, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.flash_attention_cuda(q, k, v)
