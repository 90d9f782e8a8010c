"""The port's decode attention op against ``repro.kernels.decode_attention``.

On CPU tensors ``repro_torch.kernels.decode_attention`` runs its plain
version.  It is held against the JAX package's ``decode_attention_ref`` and
its Pallas kernel in interpret mode, over the shapes and tolerances of
``tests/test_kernels.py`` (2e-5 in float32, 5e-2 in bfloat16): a cache
with empty slots past ``pos``, ring rollover (pos > T) and a sliding
window; and with ``pos`` given as an int32 tensor.  The CUDA kernel is held
against the plain version on the card by ``chip_smoke.py``; here its
wrapper's dispatch rules are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention_call
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels import decode_attention
from repro_torch.kernels.decode_attention import kernel as tkernel

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2, rtol=5e-2) if name == "bfloat16" else \
        dict(atol=2e-5, rtol=2e-5)


def _inputs(b, h, kh, t, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, d)).astype(np.float32),
            rng.normal(size=(b, kh, t, d)).astype(np.float32),
            rng.normal(size=(b, kh, t, d)).astype(np.float32))


def _f32(a):
    return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("b,h,kh,t,d,pos,window", [
    (2, 4, 2, 256, 64, 100, None),
    (1, 8, 1, 512, 32, 900, None),    # ring rollover (pos > t)
    (2, 4, 4, 256, 64, 300, 64),      # sliding window
    (1, 16, 8, 128, 256, 300, 128),   # gemma2-9b heads, window = T
])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("pos_as", ["int", "tensor"])
def test_matches_jax_ref_and_interpret(b, h, kh, t, d, pos, window, dtype,
                                       pos_as):
    jdt, tdt = DTYPES[dtype]
    arrs = _inputs(b, h, kh, t, d, seed=t + d + pos)
    tpos = pos if pos_as == "int" else torch.tensor(pos, dtype=torch.int32)
    got = decode_attention(*(torch.as_tensor(a).to(tdt) for a in arrs),
                           tpos, window=window)
    assert got.dtype == tdt and got.shape == (b, h, d)
    j = tuple(jnp.asarray(a, jdt) for a in arrs)
    for want in (decode_attention_ref(*j, pos, window=window),
                 decode_attention_call(*j, pos, window=window, bk=128,
                                       interpret=True)):
        np.testing.assert_allclose(_f32(got), _f32(want), **_tol(dtype))


def test_ring_positions_use_floor_modulo():
    """Slots past ``pos`` in a cache that has not rolled over are empty:
    the answer equals attention over slots 0..pos alone."""
    q, k, v = map(torch.as_tensor, _inputs(1, 2, 1, 64, 16, seed=3))
    got = decode_attention(q, k, v, 20)
    want = decode_attention(q, k[:, :, :21], v[:, :, :21], 20)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-6, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    q, k, v = map(torch.as_tensor, _inputs(1, 2, 1, 32, 16, seed=0))
    before = tkernel.decode_attention_cuda.launches
    out = decode_attention(q, k, v, 40, bk=8)
    assert out.shape == q.shape
    assert tkernel.decode_attention_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention(q, k, v, 40, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.decode_attention_cuda(q, k, v, 40)
