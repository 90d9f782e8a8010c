"""The port's prefill attention op against ``repro.kernels.flash_attention``.

On CPU tensors ``repro_torch.kernels.flash_attention`` runs its plain
version.  It is held against the JAX package's ``attention_ref`` and its
Pallas kernel in interpret mode, over the shapes, masks and tolerances of
``tests/test_kernels.py`` (2e-5 in float32, 5e-2 in bfloat16): GQA, MQA,
MHA, cross lengths, causal, sliding window, softcap and non-causal.  The
inputs are made with numpy and rounded to bfloat16 identically on both
sides.  The CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's dispatch rules are checked, and the
arithmetic of its bfloat16 tensor-core kernel, written out in plain
PyTorch, against the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_call
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels import flash_attention
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.ref import NEG, attention_ref \
    as torch_attention_ref

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


# chip_smoke.py's bfloat16 tolerance (atol, rtol) of a kernel against the
# plain version on the card.
BF16_TOL = (1e-3, 1e-2)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _tiled_bf16_p(q, k, v, *, keys, causal, split):
    """The tensor-core kernel's arithmetic for one head: 64-key tiles (48
    at D = 256), an online softmax in float32 from -0.7·f32max, l summed
    from the float32 p, and P·V taking p in bf16: rounded once, or
    (``split``) as a bf16 head plus a bf16 remainder, each product exact in
    float32."""
    s_len, d = q.shape
    t_len = k.shape[0]
    m = torch.full((s_len,), NEG)
    l = torch.zeros(s_len)
    acc = torch.zeros(s_len, d)
    rows = torch.arange(s_len)[:, None]
    for k0 in range(0, t_len, keys):
        cols = torch.arange(k0, min(t_len, k0 + keys))[None, :]
        sc = (q @ k[k0:k0 + keys].T) * d ** -0.5
        if causal:
            sc = torch.where(cols <= rows, sc, NEG)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[:, None])
        l = l * alpha + p.sum(-1)
        hi = _bf16(p)
        pv = hi @ v[k0:k0 + keys]
        if split:
            pv = pv + _bf16(p - hi) @ v[k0:k0 + keys]
        acc = acc * alpha[:, None] + pv
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[:, None]).to(torch.bfloat16)


def _outside_bf16_tol(got, want):
    atol, rtol = BF16_TOL
    diff = (got.double() - want.double()).abs()
    return int((diff > atol + rtol * want.double().abs()).sum())


@pytest.mark.parametrize("causal", [False, True])
def test_bf16_p_split_in_two_parts_stays_within_bf16_tol(causal):
    """gemma2-like statistics: D = 256, scale 1/16, 320 keys, bf16 inputs.
    P taken as two bf16 parts keeps every output within the card's bf16
    tolerance of the plain version; rounded once, it does so for the
    non-causal rows, but the first causal rows (few live keys) drift a bf16
    ulp of p·v outside it, which is why the kernel splits P."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.as_tensor(rng.normal(size=(n, 256)).astype(np.float32))
               .to(torch.bfloat16) for n in (320, 320, 320))
    want = torch_attention_ref(q[None, None], k[None, None], v[None, None],
                               scale=256 ** -0.5, causal=causal)[0, 0]
    args = tuple(x.to(torch.float32) for x in (q, k, v))
    two = _tiled_bf16_p(*args, keys=48, causal=causal, split=True)
    assert _outside_bf16_tol(two, want) == 0
    one = _tiled_bf16_p(*args, keys=48, causal=causal, split=False)
    assert (_outside_bf16_tol(one, want) > 0) == causal
