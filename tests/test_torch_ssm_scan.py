"""The port's chunked SSD scan against ``repro.kernels.ssm_scan`` and
``repro.models.ssm.chunked_linear_scan``.

On CPU tensors ``repro_torch.kernels.ssm_scan`` and
``repro_torch.models.ssm.chunked_linear_scan`` run the plain version.  It
is held against the JAX package's ``ssm_scan_ref`` and its Pallas kernel
in interpret mode at the shapes and tolerances of ``tests/test_kernels.py``
(1e-4 in float32, 5e-2 in bfloat16, rtol 5e-2), and against JAX's
``chunked_linear_scan`` (y and the final state) where the Pallas kernel
cannot go: a length that is not a multiple of the chunk, an initial
state.  The inputs are made with numpy and rounded to bfloat16 identically
on both sides.  The CUDA kernel is held against the plain version on the
card by ``chip_smoke.py``; here its dispatch rules are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.kernels.ssm_scan.kernel import ssm_scan_call
from repro.kernels.ssm_scan.ref import ssm_scan_ref
from repro.models.ssm import chunked_linear_scan as jax_scan
from repro_torch.kernels import ssm_scan
from repro_torch.kernels.ssm_scan import kernel as tkernel
from repro_torch.kernels.ssm_scan import ref as tref
from repro_torch.models.ssm import chunked_linear_scan

torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(atol=5e-2 if name == "bfloat16" else 1e-4, rtol=5e-2)


def _inputs(b, l, h, n, p, seed):
    """k, v, q, log_decay, gate as numpy float32 (test_kernels.py's
    distributions: log-decay in [-0.5, -0.01], gate in [0, 1])."""
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(b, l, h, n)) * 0.3).astype(np.float32),
            rng.normal(size=(b, l, h, p)).astype(np.float32),
            (rng.normal(size=(b, l, h, n)) * 0.3).astype(np.float32),
            -rng.uniform(0.01, 0.5, (b, l, h)).astype(np.float32),
            rng.uniform(0, 1, (b, l, h)).astype(np.float32))


def _both(arrs, dtype):
    """The same inputs for JAX and the port: k, v, q in ``dtype``, the
    log-decay and gate in float32."""
    jdt, tdt = DTYPES[dtype]
    j = [jnp.asarray(a, jdt) for a in arrs[:3]] + [jnp.asarray(a)
                                                    for a in arrs[3:]]
    t = [torch.as_tensor(a).to(tdt) for a in arrs[:3]] + [
        torch.as_tensor(a) for a in arrs[3:]]
    return j, t


def _np(a):
    return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("b,l,h,n,p,chunk", [
    (2, 128, 3, 16, 8, 32), (1, 64, 2, 8, 8, 64), (1, 96, 1, 4, 16, 16),
])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_jax_ref_and_interpret(b, l, h, n, p, chunk, dtype):
    arrs = _inputs(b, l, h, n, p, seed=l + n + p)
    j, t = _both(arrs, dtype)
    got = ssm_scan(*t, chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (b, l, h, p)
    forced = ssm_scan(*t, chunk=chunk, force="ref")
    np.testing.assert_array_equal(got.numpy(), forced.numpy())
    y, s = chunked_linear_scan(*t, chunk=chunk)
    np.testing.assert_array_equal(y.numpy(), got.numpy())
    for want in (ssm_scan_ref(*j, chunk=chunk),
                 ssm_scan_call(*j, chunk=chunk, interpret=True)):
        np.testing.assert_allclose(_np(got), _np(want), **_tol(dtype))
    want_y, want_s = jax_scan(*j, chunk=chunk)
    np.testing.assert_allclose(_np(s), _np(want_s), **_tol(dtype))
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol(dtype))


def _sequential(k, v, q, ld, g, s0=None):
    """The recurrence one step at a time in float64: the definition."""
    b, l, h, n = k.shape
    p = v.shape[-1]
    s = np.zeros((b, h, n, p)) if s0 is None else s0.astype(np.float64)
    y = np.zeros((b, l, h, p))
    for t in range(l):
        s = (s * np.exp(ld[:, t])[..., None, None]
             + g[:, t][..., None, None] * k[:, t][..., :, None]
             * v[:, t][..., None, :])
        y[:, t] = np.einsum("bhn,bhnp->bhp", q[:, t], s)
    return y, s


@pytest.mark.parametrize("l,chunk", [(23, 16), (40, 16), (1, 4)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_length_pads_like_the_reference(l, chunk, dtype):
    """L not a multiple of the chunk (where the Pallas kernel raises): y
    and the final state equal JAX's padded scan and the recurrence."""
    arrs = _inputs(2, l, 3, 8, 4, seed=l)
    j, t = _both(arrs, dtype)
    y, s = chunked_linear_scan(*t, chunk=chunk)
    assert y.shape == (2, l, 3, 4) and s.shape == (2, 3, 8, 4)
    want_y, want_s = jax_scan(*j, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol(dtype))
    np.testing.assert_allclose(_np(s), _np(want_s), **_tol(dtype))
    if dtype == "float32":
        seq_y, seq_s = _sequential(*arrs)
        np.testing.assert_allclose(_np(y), seq_y, atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(_np(s), seq_s, atol=1e-4, rtol=1e-4)


def test_head_stride_zero_k_and_q():
    """Mamba2's B and C broadcast over the heads (stride 0) give what the
    same values copied per head give."""
    k, v, q, ld, g = _inputs(2, 40, 5, 8, 8, seed=3)
    kb = torch.as_tensor(k[:, :, :1]).expand(2, 40, 5, 8)
    qb = torch.as_tensor(q[:, :, :1]).expand(2, 40, 5, 8)
    assert kb.stride(2) == 0 and qb.stride(2) == 0
    args = (torch.as_tensor(v), qb, torch.as_tensor(ld), torch.as_tensor(g))
    y, s = chunked_linear_scan(kb, *args, chunk=16)
    yc, sc = chunked_linear_scan(kb.contiguous(), args[0],
                                 qb.contiguous(), *args[2:], chunk=16)
    np.testing.assert_array_equal(y.numpy(), yc.numpy())
    np.testing.assert_array_equal(s.numpy(), sc.numpy())
    want_y, want_s = jax_scan(jnp.broadcast_to(jnp.asarray(k[:, :, :1]),
                                               (2, 40, 5, 8)),
                              jnp.asarray(v),
                              jnp.broadcast_to(jnp.asarray(q[:, :, :1]),
                                               (2, 40, 5, 8)),
                              jnp.asarray(ld), jnp.asarray(g), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=5e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-4,
                               rtol=5e-2)


def test_initial_state_and_chunk_longer_than_length():
    arrs = _inputs(1, 30, 2, 8, 8, seed=4)
    s0 = np.random.default_rng(5).normal(size=(1, 2, 8, 8)).astype(
        np.float32)
    y, s = chunked_linear_scan(*map(torch.as_tensor, arrs), chunk=16,
                               initial_state=torch.as_tensor(s0))
    want_y, want_s = jax_scan(*map(jnp.asarray, arrs), chunk=16,
                              initial_state=jnp.asarray(s0))
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=1e-4,
                               rtol=5e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=1e-4,
                               rtol=5e-2)
    # chunk 256 over L = 30: one padded chunk, the function of chunk 30.
    t = [torch.as_tensor(a) for a in arrs]
    np.testing.assert_allclose(ssm_scan(*t).numpy(),
                               ssm_scan(*t, chunk=30).numpy(), atol=1e-5,
                               rtol=1e-5)


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    t = [torch.as_tensor(a) for a in _inputs(1, 8, 2, 4, 4, seed=0)]
    before = tkernel.ssm_scan_cuda.launches
    assert ssm_scan(*t, chunk=4).shape == (1, 8, 2, 4)
    assert tkernel.ssm_scan_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        ssm_scan(*t, chunk=4, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.ssm_scan_cuda(*t, chunk=4)


def test_cuda_tensors_without_a_card_raise_and_never_fall_back(monkeypatch):
    """CUDA tensors (fake ones: this machine has no card) go to the kernel,
    whose build or launch raises; the plain version is never called."""
    def no_fallback(*a, **k):
        raise AssertionError("the plain version ran for CUDA tensors")
    monkeypatch.setattr(tref, "linear_scan_ref", no_fallback)
    arrs = _inputs(1, 8, 2, 4, 4, seed=0)
    with FakeTensorMode():
        t = [torch.empty(a.shape, device="cuda") for a in arrs]
        for call in (lambda: ssm_scan(*t, chunk=4),
                     lambda: chunked_linear_scan(*t, chunk=4)):
            with pytest.raises(RuntimeError, match="nvcc"):
                call()
    assert tkernel.ssm_scan_cuda.launches == 0
