"""The gradient of the port's prefill attention op.

The plain backward (``ref.attention_bwd_ref``: P recomputed from the
forward's log-sum-exp, dS = P(dP - Δ) through the mask and the softcap,
dK and dV summed over each KV head's query group) is held against
``jax.vjp`` of the JAX package's ``attention_ref`` in float32, at the
forward's 2e-5 (times the gradient's largest magnitude where that is
above 1), over causal, windowed, softcapped, non-causal, GQA and MQA
cases and rows that no key reaches.  ``FlashAttention`` (the op with
gradients on) is held on the CPU against float64 autograd of the same
function.  The CUDA backward kernel is held against the plain backward on
the card by ``chip_smoke.py`` phase train.

The ops without a backward kernel must refuse a gradient on the card
(ROADMAP C8): with their dispatch routed to the kernel, an input that
requires grad raises before the launch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ref import attention_ref as jax_attention
from repro_torch.kernels import dispatch, flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ops import FlashAttention

torch.set_num_threads(1)

# (B, H, KH, S, T, D, causal, window, softcap)
CASES = [
    (2, 4, 2, 24, 24, 16, True, None, None),        # GQA, causal
    (1, 4, 1, 20, 20, 8, True, 6, None),            # MQA, window
    (1, 3, 3, 17, 17, 12, False, None, None),       # MHA, non-causal
    (2, 6, 2, 16, 16, 8, True, None, 5.0),          # softcap
    (1, 8, 1, 18, 18, 16, True, 5, 3.0),            # MQA group 8, both
    (1, 2, 1, 21, 9, 4, True, 4, None),             # S > T: dead rows
    (1, 2, 2, 9, 13, 8, False, 3, 2.0),             # non-causal window
]
IDS = [f"h{c[1]}kh{c[2]}s{c[3]}t{c[4]}d{c[5]}" + ("c" if c[6] else "n")
       + (f"w{c[7]}" if c[7] else "") + (f"cap{c[8]:g}" if c[8] else "")
       for c in CASES]


def _inputs(case, seed):
    b, h, kh, s, t, d = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for shape in
            ((b, h, s, d), (b, kh, t, d), (b, kh, t, d), (b, h, s, d))]


def _kw(case):
    return dict(scale=None, causal=case[6], window=case[7], softcap=case[8])


def _close(got, want, atol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)


def _jax_vjp(kw):
    """(o, (dq, dk, dv)) of the JAX ``attention_ref``, jitted: one compile
    a case (the ops one at a time compile each primitive apart)."""
    def run(q, k, v, do):
        o, vjp = jax.vjp(lambda a, b_, c: jax_attention(a, b_, c, **kw),
                         q, k, v)
        return o, vjp(do)
    return jax.jit(run)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_jax_vjp(case):
    q, k, v, do = _inputs(case, len(IDS[CASES.index(case)]))
    kw = _kw(case)
    o, want = _jax_vjp(kw)(*map(jnp.asarray, (q, k, v, do)))
    tq, tk, tv, tdo = map(torch.as_tensor, (q, k, v, do))
    to, lse = fa_ref.attention_fwd_ref(tq, tk, tv, **kw)
    _close(to, o)
    got = fa_ref.attention_bwd_ref(tq, tk, tv, to, lse, tdo, **kw)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        _close(g, w)


def _attention64(q, k, v, *, scale, causal, window, softcap):
    """Attention in float64 throughout (the plain version computes in
    float32): the yardstick of the float32 gradient."""
    h, kh = q.shape[1], k.shape[1]
    k = torch.repeat_interleave(k, h // kh, dim=1)
    v = torch.repeat_interleave(v, h // kh, dim=1)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    sc = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(fa_ref._live(q.shape[2], k.shape[2], causal, window,
                                  q.device), sc, fa_ref.NEG)
    return torch.einsum("bhst,bhtd->bhsd", torch.softmax(sc, -1), v)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_autograd_function_on_cpu_matches_float64(case):
    q, k, v, do = map(torch.as_tensor, _inputs(case, 3))
    kw = _kw(case)
    x32 = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = flash_attention(*x32, **kw)
    assert isinstance(out.grad_fn, FlashAttention._backward_cls)
    got = torch.autograd.grad(out, x32, do)
    x64 = [t.double().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(_attention64(*x64, **kw), x64, do.double())
    for g, w in zip(got, want):
        _close(g, w)
    # The plain backward run in float64 (as the card's check runs it)
    # agrees with float64 autograd to rounding.
    x64 = [t.detach() for t in x64]
    o64 = _attention64(*x64, **kw)
    exact = fa_ref.attention_bwd_ref(*x64, o64, _lse64(*x64, **kw),
                                     do.double(), **kw)
    for g, w in zip(exact, want):
        _close(g, w, atol=1e-12)


def _lse64(q, k, v, *, scale, causal, window, softcap):
    k = torch.repeat_interleave(k, q.shape[1] // k.shape[1], dim=1)
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    sc = torch.einsum("bhsd,bhtd->bhst", q, k) * scale
    if softcap is not None:
        sc = softcap * torch.tanh(sc / softcap)
    sc = torch.where(fa_ref._live(q.shape[2], k.shape[2], causal, window,
                                  q.device), sc, fa_ref.NEG)
    return torch.logsumexp(sc, -1)


def test_dispatch_of_the_differentiable_op():
    """Without gradients the op is the forward alone (no grad_fn); a
    bfloat16 input that requires grad raises; ``force="ref"`` takes the
    Function with the plain versions; the kernel wrappers refuse CPU
    tensors."""
    q, k, v, do = map(torch.as_tensor, _inputs(CASES[0], 5))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None
    assert flash_attention(q, k, v).grad_fn is None     # nothing requires
    qb = q.to(torch.bfloat16).requires_grad_(True)
    with pytest.raises(TypeError, match="float32"):
        flash_attention(qb, k.to(torch.bfloat16), v.to(torch.bfloat16))
    qg = q.clone().requires_grad_(True)
    out = flash_attention(qg, k, v, force="ref")
    (dq,) = torch.autograd.grad(out, (qg,), do)
    o, lse = fa_ref.attention_fwd_ref(q, k, v)
    torch.testing.assert_close(out.detach(), o, rtol=0, atol=0)
    torch.testing.assert_close(dq, fa_ref.attention_bwd_ref(
        q, k, v, o, lse, do)[0], rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.prepare_bwd(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="CUDA"):
        fa_kernel.prepare(q, k, v, want_lse=True)


def _no_backward_calls():
    """(ops module, kernel function name, call) of each op without a
    backward kernel, on small CPU inputs that require grad."""
    from repro_torch.kernels.decode_attention import ops as da
    from repro_torch.kernels.gh_ei import ops as gh
    from repro_torch.kernels.masked_argmax import ops as am
    from repro_torch.kernels.select_step import ops as ss
    from repro_torch.kernels.tree_predict import ops as tp

    g = lambda *shape: torch.rand(shape, requires_grad=True)
    feat = torch.zeros((2, 2, 2), dtype=torch.int32)
    return [
        (da, "decode_attention_cuda", lambda: da.decode_attention(
            g(1, 2, 4), g(1, 1, 8, 4), g(1, 1, 8, 4), 5)),
        (tp, "tree_predict_cuda", lambda: tp.tree_predict(
            g(6, 2), feat, g(2, 2, 2), g(2, 4))),
        (gh, "gh_ei_cuda", lambda: gh.gh_ei(
            g(6), g(6), g(6), 1.0, 2.0, 0.5, 0.0)),
        (am, "masked_argmax_cuda", lambda: am.masked_argmax(
            g(6), torch.ones(6, dtype=torch.bool))),
        (ss, "select_step_cuda", lambda: ss.select_step(
            feat, g(2, 2, 2), g(2, 4), g(3), None, 0.5, 1.0, g(6, 2),
            g(6), 2.0, 0.0)),
    ]


@pytest.mark.parametrize("i", range(5), ids=["decode_attention",
                                              "tree_predict", "gh_ei",
                                              "masked_argmax", "select_step"])
def test_ops_without_backward_kernel_refuse_a_gradient(i, monkeypatch):
    """C8: routed to the kernel (as a CUDA tensor is), an op without a
    backward kernel raises before it launches when an input requires grad
    and grad mode is on; under ``no_grad`` it launches.  On the CPU the
    plain version keeps autograd."""
    mod, fn, call = _no_backward_calls()[i]
    launched = []
    monkeypatch.setattr(mod, "resolve_mode",
                        lambda force, device, op="": "kernel")

    def fake_launch(*args, **kwargs):
        launched.append(fn)
        raise RuntimeError("launched")

    monkeypatch.setattr(getattr(mod, "_kernel"), fn, fake_launch)
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        call()
    assert not launched
    with torch.no_grad(), pytest.raises(RuntimeError, match="launched"):
        call()
    assert launched == [fn]


def test_require_no_grad_lets_plain_tensors_through():
    x = torch.ones(3)
    dispatch.require_no_grad("op", x, None)
    with pytest.raises(NotImplementedError, match="op:"):
        dispatch.require_no_grad("op", x.requires_grad_(True))
    with torch.no_grad():
        dispatch.require_no_grad("op", x)
