"""The scan's plain backward (``kernels.ssm_scan.ref.linear_scan_bwd_ref``,
the CUDA backward kernel's four phases in PyTorch) and the op's gradient
path (``kernels.ssm_scan.ops.LinearScan``).

The plain backward is held against ``torch.autograd`` through
``linear_scan_ref`` in float64 (rtol 1e-10: the same function, summed in
another order) and against ``jax.vjp`` of the reference's
``repro.models.ssm.chunked_linear_scan`` in float32 (each gradient within
5e-6 of its largest magnitude: float32 keeps about 6e-8 a rounding, and
the two sum over up to a chunk's rows and L positions in other orders).
Three input forms, drawn with numpy from a ``zlib.crc32``-seeded
generator: Mamba2's (k and q one row broadcast over the heads, a head
stride of 0; no initial state), the mLSTM's (P = N + 1 with a ones
column, an initial state, L not a multiple of the chunk, a gradient of
the final state) and an edge (zero gates, among them the last row, a
chunk longer than L's tail, a final-state gradient).
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import chunked_linear_scan as jax_scan
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan.ref import (linear_scan_bwd_ref,
                                              linear_scan_fwd_ref,
                                              linear_scan_ref)

jax.config.update("jax_enable_x64", False)
torch.set_num_threads(1)

# name: (B, L, H, N, P, chunk, broadcast k/q, initial state, d_final,
# zero gates)
FORMS = {
    "mamba2": (2, 40, 3, 8, 8, 16, True, False, False, False),
    "mlstm": (1, 37, 2, 6, 7, 8, False, True, True, False),
    "zero_gates": (1, 21, 2, 5, 4, 16, False, False, True, True),
}
F64_RTOL = 1e-10
F32_REL = 5e-6
NAMES = ("dk", "dv", "dq", "d_log_decay", "d_gate", "d_initial_state")


def _inputs(form):
    b, l, h, n, p, chunk, bcast, s0, dfin, zeros = FORMS[form]
    rng = np.random.default_rng(zlib.crc32(form.encode()))
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    if bcast:
        k = np.broadcast_to(f(b, l, 1, n), (b, l, h, n))
        q = np.broadcast_to(f(b, l, 1, n), (b, l, h, n))
    else:
        k, q = f(b, l, h, n), f(b, l, h, n)
    v = f(b, l, h, p)
    if form == "mlstm":
        v[..., -1] = 1.0                         # the normalizer column
    ld = -rng.uniform(0.0, 1.0, (b, l, h)).astype(np.float32)
    g = rng.uniform(0.0, 2.0, (b, l, h)).astype(np.float32)
    if zeros:
        g[:, ::3] = 0.0
        g[:, -1] = 0.0
    x = dict(k=k, v=v, q=q, ld=ld, g=g, chunk=chunk,
             s0=f(b, h, n, p) if s0 else None, dy=f(b, l, h, p),
             dfin=f(b, h, n, p) if dfin else None)
    return x


def _t(a, dtype=torch.float64):
    return None if a is None else torch.tensor(np.ascontiguousarray(a),
                                               dtype=dtype)


def _bcast_t(a, form, dtype):
    """k or q as the Mamba2 block hands them over: a head stride of 0."""
    t = _t(a, dtype)
    if FORMS[form][6]:
        return _t(a[:, :, :1], dtype).expand(t.shape)
    return t


def _plain(x, form, dtype):
    args = (_bcast_t(x["k"], form, dtype), _t(x["v"], dtype),
            _bcast_t(x["q"], form, dtype), _t(x["ld"], dtype),
            _t(x["g"], dtype))
    return args, _t(x["s0"], dtype)


@pytest.mark.parametrize("form", FORMS)
def test_plain_backward_matches_float64_autograd(form):
    x = _inputs(form)
    args, s0 = _plain(x, form, torch.float64)
    dy, dfin = _t(x["dy"]), _t(x["dfin"])
    got = linear_scan_bwd_ref(*args, dy, dfin, chunk=x["chunk"],
                              initial_state=s0)
    leaves = [a.detach().clone().requires_grad_(True) for a in args]
    s0r = None if s0 is None else s0.clone().requires_grad_(True)
    y, s = linear_scan_ref(*leaves, chunk=x["chunk"], initial_state=s0r)
    loss = (y * dy).sum() + (0 if dfin is None else (s * dfin).sum())
    want = torch.autograd.grad(loss, leaves + ([s0r] if s0r is not None
                                               else []))
    for name, a, w in zip(NAMES, got, want):
        torch.testing.assert_close(a, w, rtol=F64_RTOL,
                                   atol=F64_RTOL * float(w.abs().max()),
                                   msg=name)
    # The states the backward reads are the forward's.
    _, s_fin, states = linear_scan_fwd_ref(*args, chunk=x["chunk"],
                                           initial_state=s0)
    again = linear_scan_bwd_ref(*args, dy, dfin, chunk=x["chunk"],
                                initial_state=s0, states=states,
                                final_state=s_fin)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("form", FORMS)
def test_plain_backward_matches_jax_vjp(form):
    x = _inputs(form)
    args, s0 = _plain(x, form, torch.float32)
    dy, dfin = _t(x["dy"], torch.float32), _t(x["dfin"], torch.float32)
    got = linear_scan_bwd_ref(*args, dy, dfin, chunk=x["chunk"],
                              initial_state=s0)
    jargs = [jnp.asarray(np.ascontiguousarray(x[k]))
             for k in ("k", "v", "q", "ld", "g")]
    b, l, h, n, p = x["dy"].shape[:3] + x["k"].shape[3:] + x["v"].shape[3:]
    js0 = (jnp.zeros((b, h, n, p), jnp.float32) if x["s0"] is None
           else jnp.asarray(x["s0"]))
    (y, s), vjp = jax.vjp(lambda *a: jax_scan(*a[:5], chunk=x["chunk"],
                                              initial_state=a[5]),
                          *jargs, js0)
    jfin = jnp.zeros_like(s) if x["dfin"] is None else jnp.asarray(x["dfin"])
    want = vjp((jnp.asarray(x["dy"]), jfin))
    for name, a, w in zip(NAMES, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=F32_REL * float(np.abs(w).max()),
                                   err_msg=name)


def test_op_differentiates_through_linear_scan_on_the_cpu():
    """A grad-requiring call on CPU tensors goes through ``LinearScan``
    (mode "ref"): the forward is ``linear_scan_ref``'s, bit for bit, and
    the gradients the plain backward's, the final state's included; an
    unused final state gives the backward no dS_final."""
    x = _inputs("mlstm")
    args, s0 = _plain(x, "mlstm", torch.float32)
    dy, dfin = _t(x["dy"], torch.float32), _t(x["dfin"], torch.float32)
    leaves = [a.clone().requires_grad_(True) for a in args + (s0,)]
    y, s = ops.linear_scan(*leaves[:5], chunk=x["chunk"],
                           initial_state=leaves[5])
    assert y.grad_fn is not None and "LinearScan" in type(y.grad_fn).__name__
    y0, s_0 = linear_scan_ref(*args, chunk=x["chunk"], initial_state=s0)
    assert torch.equal(y.detach(), y0) and torch.equal(s.detach(), s_0)
    got = torch.autograd.grad((y * dy).sum() + (s * dfin).sum(), leaves)
    want = linear_scan_bwd_ref(*args, dy, dfin, chunk=x["chunk"],
                               initial_state=s0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    y, _ = ops.linear_scan(*leaves[:5], chunk=x["chunk"],
                           initial_state=leaves[5])
    got = torch.autograd.grad((y * dy).sum(), leaves)
    want = linear_scan_bwd_ref(*args, dy, None, chunk=x["chunk"],
                               initial_state=s0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_grad_call_routed_to_the_kernel_reaches_the_backward_launcher(
        monkeypatch):
    """With the dispatch routed to the kernel (as a CUDA tensor is), a
    grad-requiring ``linear_scan`` launches the forward kernel with its
    states and, in the backward, the backward kernel on the forward's
    states and final state; under ``no_grad`` only the forward."""
    from repro_torch.kernels.ssm_scan import kernel
    calls = []

    def fwd(k, v, q, ld, g, *, chunk, initial_state=None,
            want_states=False):
        calls.append(("fwd", want_states))
        y, s, st = linear_scan_fwd_ref(k, v, q, ld, g, chunk=chunk,
                                       initial_state=initial_state)
        return (y, s, st) if want_states else (y, s)

    def bwd(*args, chunk, initial_state, states, final_state):
        calls.append(("bwd", tuple(states.shape), final_state is not None))
        return linear_scan_bwd_ref(*args, chunk=chunk,
                                   initial_state=initial_state,
                                   states=states, final_state=final_state)

    monkeypatch.setattr(ops, "resolve_mode",
                        lambda force, device, op="": "kernel")
    monkeypatch.setattr(kernel, "ssm_scan_cuda", fwd)
    monkeypatch.setattr(kernel, "ssm_scan_bwd_cuda", bwd)
    x = _inputs("mamba2")
    args, _ = _plain(x, "mamba2", torch.float32)
    leaves = [a.clone().requires_grad_(True) for a in args]
    y, _ = ops.linear_scan(*leaves, chunk=x["chunk"])
    grads = torch.autograd.grad((y * _t(x["dy"], torch.float32)).sum(),
                                leaves)
    b, l, h, n, p = 2, 40, 3, 8, 8
    assert calls == [("fwd", True), ("bwd", (b, h, 3, n, p), True)]
    assert all(g is not None and g.shape == a.shape
               for g, a in zip(grads, leaves))
    with torch.no_grad():
        ops.linear_scan(*leaves, chunk=x["chunk"])
    assert calls[-1] == ("fwd", False)


def test_bfloat16_with_grad_raises():
    x = _inputs("mlstm")
    args, _ = _plain(x, "mlstm", torch.float32)
    k, v, q = (a.to(torch.bfloat16).requires_grad_(True) for a in args[:3])
    with pytest.raises(TypeError, match="float32"):
        ops.linear_scan(k, v, q, args[3], args[4], chunk=x["chunk"])
    with torch.no_grad():                        # the forward alone takes it
        ops.linear_scan(k, v, q, args[3], args[4], chunk=x["chunk"])


def test_backward_plan_from_the_shapes():
    """``kernel.plan_bwd``: the chunk (at most L), the chunk count and the
    64-column tiles of N that split q·dq and k·dk̃ over blocks, at the
    training shapes, then the tiles and the dq partials' (query tile,
    key tile) pairs; the limits raise, and a CPU tensor never reaches
    the launcher."""
    from repro_torch.kernels.ssm_scan import kernel
    assert kernel.plan_bwd(1, 2048, 112, 64, 64, 256)[:3] == (256, 8, 1)
    assert kernel.plan_bwd(4, 2048, 4, 384, 385, 256)[:3] == (256, 8, 6)
    assert kernel.plan_bwd(2, 1100, 3, 48, 65, 256)[:3] == (256, 5, 1)
    assert kernel.plan_bwd(1, 40, 2, 65, 8, 256)[:3] == (40, 1, 2)
    pl = kernel.plan_bwd(4, 2048, 4, 384, 385, 256)
    assert (pl.q_tiles, pl.p_tiles, pl.pairs) == (4, 7, 10)
    assert pl.workspace_bytes == 4 * 4 * 4 * 8 * 10 * 6 * 64 * 64
    with pytest.raises(ValueError, match="grid dimension"):
        kernel.plan_bwd(1, 65536, 1, 8, 8, 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.plan_bwd(1, 20000, 1, 8, 8, 20000)
    # The dk/dv kernel holds one score tile whatever the chunk, beside
    # the chunk's cumsum and gate (12 bytes a row): chunks of 512 and 1024
    # fit, 10688 rows do not.
    assert kernel.plan_bwd(1, 1024, 1, 384, 385, 512)[:3] == (512, 2, 6)
    assert kernel.plan_bwd(1, 1024, 1, 64, 64, 1024)[:3] == (1024, 1, 1)
    with pytest.raises(ValueError, match="shared memory"):
        kernel.plan_bwd(1, 10688, 1, 64, 64, 10688)
    x = _inputs("mlstm")
    args, s0 = _plain(x, "mlstm", torch.float32)
    _, s, states = linear_scan_fwd_ref(*args, chunk=x["chunk"])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.prepare_bwd(*args, _t(x["dy"], torch.float32),
                           chunk=x["chunk"], states=states.contiguous(),
                           final_state=s)
