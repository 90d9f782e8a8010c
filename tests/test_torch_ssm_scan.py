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


# --------------------------------------------------------------------------- #
# The redesigned kernel's arithmetic, in plain PyTorch on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("l,chunk,s0", [(300, 128, True), (200, 64, False)])
def test_three_phase_model_matches_jax(l, chunk, s0, dtype):
    """The kernel's decomposition (chunk states, state passing, chunk scan;
    ``ref.three_phase_scan_ref`` in float64) equals JAX's
    ``chunked_linear_scan`` at N = 192 and P = 193, over a ragged L with
    and without an initial state."""
    arrs = _inputs(1, l, 2, 192, 193, seed=l + chunk)
    j, t = _both(arrs, dtype)
    init = (np.random.default_rng(chunk).normal(size=(1, 2, 192, 193))
            .astype(np.float32) if s0 else None)
    kw = dict(chunk=chunk)
    y, s = tref.three_phase_scan_ref(
        *t, **kw, initial_state=None if init is None else torch.as_tensor(
            init))
    assert y.dtype == s.dtype == torch.float64
    assert y.shape == (1, l, 2, 193) and s.shape == (1, 2, 192, 193)
    want_y, want_s = jax_scan(*j, **kw, initial_state=None if init is None
                              else jnp.asarray(init))
    np.testing.assert_allclose(y.numpy(), _np(want_y), **_tol(dtype))
    np.testing.assert_allclose(s.numpy(), _np(want_s), **_tol(dtype))
    # The float64 plain version is the same function to float64 rounding.
    ey, es = tref.linear_scan_ref(
        *(x.double() for x in t), **kw, initial_state=None if init is None
        else torch.as_tensor(init).double())
    np.testing.assert_allclose(y.numpy(), ey.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(s.numpy(), es.numpy(), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("s0", [False, True])
def test_xlstm_widths_match_jax(s0):
    """``chunked_linear_scan`` at xlstm-125m's mLSTM widths (N = hd = 384,
    P = hd + 1 = 385: ``repro.models.xlstm._mdims``), over a ragged L of
    two chunks and a part, with and without an initial state, against the
    JAX ``chunked_linear_scan`` (y and the final state)."""
    arrs = _inputs(1, 150, 2, 384, 385, seed=384 + s0)
    j, t = _both(arrs, "float32")
    init = (np.random.default_rng(385).normal(size=(1, 2, 384, 385))
            .astype(np.float32) if s0 else None)
    y, s = chunked_linear_scan(*t, chunk=64, initial_state=None if init is
                               None else torch.as_tensor(init))
    assert y.shape == (1, 150, 2, 385) and s.shape == (1, 2, 384, 385)
    want_y, want_s = jax_scan(*j, chunk=64, initial_state=None if init is
                              None else jnp.asarray(init))
    np.testing.assert_allclose(_np(y), _np(want_y), **_tol("float32"))
    np.testing.assert_allclose(_np(s), _np(want_s), **_tol("float32"))


# The card's gate for the kernel against the plain version in float64
# (chip_smoke.py: SSM_RTOL, SSM_ATOL, per output).
SSM_RTOL, SSM_ATOL = 1e-5, 1e-6


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero: the card's ``cvt.rna.tf32.f32``, on the int32 view."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _bf16_parts(x):
    """x as three bf16 values (held in float32) whose sum is x to 24 bits:
    the kernel's head, middle and remainder."""
    h = x.to(torch.bfloat16).float()
    m = (x - h).to(torch.bfloat16).float()
    return [h, m, (x - h - m).to(torch.bfloat16).float()]


def _mm(a, b, form):
    """a @ b as the card forms it, float32 accumulation: ``split`` takes
    each operand as a TF32 head and remainder and sums lo·hi, hi·lo and
    hi·hi (the kernel's float32 form); ``tf32`` one product of the TF32
    heads (the form the contract forbids); ``bf16`` three bf16 parts of
    each float32 operand (an operand that is bf16 already has one) with
    exact products (the kernel's bf16 form)."""
    if form == "tf32":
        return _tf32(a) @ _tf32(b)
    if form == "split":
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _tf32(a - ah), _tf32(b - bh)
        return al @ bh + ah @ bl + ah @ bh
    out = torch.zeros(a.shape[:-1] + b.shape[-1:])
    for pa in reversed(_bf16_parts(a)):
        for pb in reversed(_bf16_parts(b)):
            out = out + pa @ pb
    return out


def _kernel_arithmetic(k, v, q, ld, g, chunk, form):
    """The three phases in the kernel's precision: float64 cumsums and
    decay exponents rounded once to float32 before exp, float32 weights,
    every product by ``_mm(.., form)``, float32 state passing."""
    b, l, h, n = k.shape
    t = lambda x: x.permute(0, 2, 1, 3)                # [B,H,Lc,.]
    s = torch.zeros((b, h, n, v.shape[-1]))
    y = torch.empty((b, l, h, v.shape[-1]))
    for c0 in range(0, l, chunk):
        c1 = min(c0 + chunk, l)
        cum = torch.cumsum(ld[:, c0:c1].double(), 1).permute(0, 2, 1)
        gc = g[:, c0:c1].permute(0, 2, 1)              # [B,H,Lc]
        kc, vc, qc = t(k[:, c0:c1]), t(v[:, c0:c1]), t(q[:, c0:c1])
        w = torch.exp((cum[..., -1:] - cum).float()) * gc
        ds = _mm((kc * w[..., None]).transpose(-1, -2), vc, form)
        lower = torch.ones(c1 - c0, c1 - c0, dtype=torch.bool).tril()
        seg = (cum[..., :, None] - cum[..., None, :]).float()
        att = _mm(qc, kc.transpose(-1, -2), form)
        wts = torch.where(lower, att * torch.exp(seg.masked_fill(~lower, 0))
                          * gc[..., None, :], 0.0)
        yc = (_mm(qc, s, form) * torch.exp(cum.float())[..., None]
              + _mm(wts, vc, form))
        y[:, c0:c1] = yc.permute(0, 2, 1, 3)
        s = s * torch.exp(cum[..., -1].float())[..., None, None] + ds
    return y, s


@pytest.mark.parametrize("form,dtype,holds", [
    ("split", "float32", True), ("bf16", "bfloat16", True),
    ("tf32", "float32", False)])
def test_split_operand_products_meet_the_card_gate(form, dtype, holds):
    """The kernel's tensor-core arithmetic, emulated in plain PyTorch at
    zamba2-7b's widths (N = P = 64, chunk 256, L = 1000), meets the card's
    gate against the plain version in float64 (rtol 1e-5 + 1e-6·max per
    output): split TF32 for float32 inputs, bf16 parts for bf16 k/q/v.
    One TF32 product, which the contract forbids, misses it."""
    arrs = _inputs(1, 1000, 2, 64, 64, seed=64)
    _, (k, v, q, ld, g) = _both(arrs, dtype)
    k, v, q = (x.float() for x in (k, v, q))           # bf16 held exactly
    got = _kernel_arithmetic(k, v, q, ld, g, 256, form)
    exact = tref.linear_scan_ref(*(x.double() for x in (k, v, q, ld, g)),
                                 chunk=256)
    within = []
    for gt, ex in zip(got, exact):
        d = (gt.double() - ex).abs()
        within.append(bool((d <= SSM_RTOL * ex.abs()
                            + SSM_ATOL * ex.abs().max()).all()))
    assert all(within) is holds, within


def _fake(*shapes, dtype=torch.float32):
    return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


@pytest.mark.parametrize("case", [
    "zamba2-7b", "N 192", "N 192 bf16", "xlstm-125m", "xlstm-125m bf16",
    "chunk longer than L", "N 400 plans", "chunk past shared memory",
    "too many chunks",
    "chunk 0", "empty", "v shape", "q dtype", "initial_state shape",
    "cpu tensors"])
def test_plan_checks_shapes_and_limits(case):
    """``kernel.plan`` (the wrapper's checks and launch geometry) on fake
    CUDA tensors: the shapes it takes, with their grids, shared memory and
    scratch, and each refusal with its reason."""
    def args(b, l, h, n, p, dtype=torch.float32, stride0=False):
        with FakeTensorMode():
            k, q = _fake((b, l, 1 if stride0 else h, n), (b, l, 1 if stride0
                                                          else h, n),
                         dtype=dtype)
            if stride0:
                k, q = k.expand(b, l, h, n), q.expand(b, l, h, n)
            v, = _fake((b, l, h, p), dtype=dtype)
            ld, g = _fake((b, l, h), (b, l, h))
        return [k, v, q, ld, g]

    plan = tkernel.plan
    if case == "zamba2-7b":
        a = args(4, 1000, 112, 64, 64, stride0=True)
        pl = plan(*a, chunk=256)
        assert a[0].stride(2) == 0 and pl.vec == 7
        assert pl.grids == ((448, 4, 1), (448, 4), (448, 4, 4))
        assert pl.chunks == 4 and max(pl.smem) <= tkernel.SMEM_LIMIT
        # The chunk states' scratch, dS_c then S_{c-1}: 29 MB.
        assert 4 * pl.b * pl.h * pl.chunks * pl.n * pl.p == 29_360_128
    elif case.startswith("N 192"):
        dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
        pl = plan(*args(4, 1000, 4, 192, 193, dtype), chunk=256)
        assert (pl.n, pl.p, pl.bf16) == (192, 193, dtype == torch.bfloat16)
        assert pl.grids == ((16, 4, 12), (16, 37), (16, 4, 16))
        assert max(pl.smem) <= tkernel.SMEM_LIMIT
    elif case.startswith("xlstm-125m"):
        # The mLSTM's real widths: N = hd = 384, P = hd + 1 = 385.  N
        # streams through the chunk scan in slabs: the shared bytes are
        # N = 64's (zamba2-7b's).
        bf16 = case.endswith("bf16")
        dtype = torch.bfloat16 if bf16 else torch.float32
        pl = plan(*args(4, 1000, 4, 384, 385, dtype), chunk=256)
        assert (pl.n, pl.p, pl.bf16) == (384, 385, bf16)
        assert pl.grids == ((16, 4, 42), (16, 145), (16, 4, 28))
        assert pl.smem == tkernel.smem_bytes(64, 256, bf16) == (
            (39936, 74752) if bf16 else (76800, 109568))
        assert max(pl.smem) <= tkernel.SMEM_LIMIT
    elif case == "chunk longer than L":
        pl = plan(*args(1, 30, 2, 8, 8), chunk=256)
        assert (pl.chunk, pl.chunks) == (30, 1)
    elif case == "N 400 plans":
        # N = 400 overflowed the chunk scan's shared memory while it kept
        # the q tile over all N; streamed in slabs, it plans as N = 16 does.
        pl = plan(*args(1, 64, 2, 400, 16), chunk=16)
        assert pl.smem == plan(*args(1, 64, 2, 16, 16), chunk=16).smem
        assert pl.grids == ((2, 4, 7), (2, 7), (2, 4, 1))
    else:
        a, kw, err, match = args(1, 64, 2, 16, 16), dict(chunk=16), \
            ValueError, None
        if case == "chunk past shared memory":
            a, kw, match = args(1, 40000, 1, 16, 16), dict(chunk=20000), \
                "shared memory"
        elif case == "too many chunks":
            a, kw, match = args(1, 70000, 1, 4, 4), dict(chunk=1), \
                "grid dimension"
        elif case == "chunk 0":
            kw, match = dict(chunk=0), "positive"
        elif case == "empty":
            a, match = args(1, 64, 2, 0, 16), "empty"
        elif case == "v shape":
            a[1], match = args(1, 32, 2, 16, 16)[1], "v has shape"
        elif case == "q dtype":
            a[2] = args(1, 64, 2, 16, 16, torch.bfloat16)[2]
            err, match = TypeError, "q has dtype"
        elif case == "initial_state shape":
            with FakeTensorMode():
                kw["initial_state"], = _fake((1, 2, 16, 8))
            match = "initial_state has shape"
        elif case == "cpu tensors":
            a = [torch.as_tensor(x) for x in _inputs(1, 8, 2, 4, 4, 0)]
            match = "CUDA"
        with pytest.raises(err, match=match):
            plan(*a, **kw)
