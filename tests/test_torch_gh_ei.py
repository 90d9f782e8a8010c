"""The port's fused acquisition op against ``repro.kernels.gh_ei``.

On CPU tensors ``repro_torch.kernels.gh_ei`` runs its plain version (the
port's ``acquisition.ei_constrained``/``budget_ok`` and the node formula).
It is held against the JAX package's ``gh_ei_ref`` and its Pallas kernel
in interpret mode (whose Phi is erf-based) at the gates of
``tests/test_kernels.py``: eic and nodes within 1e-5, the budget flag
exactly.  The censoring pre-pass is checked as that file checks it.  The
CUDA kernel is held against the plain version on the card by
``chip_smoke.py``; here its wrapper's dispatch rules are checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.acquisition import gauss_hermite
from repro.kernels.gh_ei.kernel import gh_ei_call
from repro.kernels.gh_ei.ops import gh_ei as jax_gh_ei
from repro.kernels.gh_ei.ref import gh_ei_ref
from repro_torch.core import acquisition as tacq
from repro_torch.kernels import gh_ei
from repro_torch.kernels.gh_ei import kernel as tkernel

torch.set_num_threads(1)

ATOL = 1e-5
SCAL = (2.5, 1.2, 10.0)            # y*, t_max, beta


def _inputs(m, seed):
    rng = np.random.default_rng(seed)
    mu = rng.uniform(1, 5, m).astype(np.float32)
    sig = rng.uniform(0.1, 2, m).astype(np.float32)
    u = rng.uniform(0.5, 3, m).astype(np.float32)
    return mu, sig, u


def _same(want, got):
    (we, wo, wn), (ge, go, gn) = want, got
    assert ge.dtype == torch.float32 and go.dtype == torch.bool
    assert gn.dtype == torch.float32 and gn.shape == np.asarray(wn).shape
    np.testing.assert_allclose(ge.numpy(), np.asarray(we), atol=ATOL, rtol=0)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), atol=ATOL, rtol=0)


@pytest.mark.parametrize("m,k_gh,bm", [(97, 3, 32), (512, 5, 128),
                                       (33, 2, 64)])
def test_matches_jax_ref_and_interpret(m, k_gh, bm):
    mu, sig, u = _inputs(m, seed=m)
    xi = gauss_hermite(k_gh)[0]
    got = gh_ei(*map(torch.as_tensor, (mu, sig, u)), *SCAL,
                torch.as_tensor(xi))
    j = tuple(map(jnp.asarray, (mu, sig, u)))
    _same(gh_ei_ref(*j, *SCAL, jnp.asarray(xi)), got)
    _same(gh_ei_call(*j, *SCAL, jnp.asarray(xi), bm=bm, interpret=True),
          got)


def test_budget_flag_at_its_threshold():
    """Points placed on both sides of the z-space threshold: the flag
    still equals the JAX package's exactly."""
    rng = np.random.default_rng(5)
    m = 256
    sig = rng.uniform(0.1, 2, m).astype(np.float32)
    q = np.float32(tacq.normal_quantile(0.99))
    beta = np.float32(10.0)
    mu = (beta - q * sig).astype(np.float32)
    mu = np.nextafter(mu, np.where(np.arange(m) % 3 == 0, np.inf, -np.inf)
                      ).astype(np.float32)
    u = rng.uniform(0.5, 3, m).astype(np.float32)
    xi = gauss_hermite(3)[0]
    got = gh_ei(*map(torch.as_tensor, (mu, sig, u)), 2.5, 1.2, float(beta),
                torch.as_tensor(xi))
    assert 0 < int(got[1].sum()) < m
    j = tuple(map(jnp.asarray, (mu, sig, u)))
    _same(gh_ei_ref(*j, 2.5, 1.2, beta, jnp.asarray(xi)), got)
    _same(gh_ei_call(*j, 2.5, 1.2, beta, jnp.asarray(xi), bm=128,
                     interpret=True), got)


def test_censoring_pre_pass():
    """The op's censoring path == censored_adjust then the plain call; an
    all-False mask reproduces the uncensored result bit for bit; both
    agree with the JAX op's censoring path."""
    m = 64
    mu, sig, u = _inputs(m, seed=7)
    y = np.random.default_rng(8).uniform(2, 8, m).astype(np.float32)
    cens = np.arange(m) % 7 == 0
    xi = gauss_hermite(3)[0]
    t = lambda a: torch.as_tensor(a)
    args = (t(mu), t(sig), t(u), *SCAL, t(xi))

    plain = gh_ei(*args)
    none_c = gh_ei(*args, cens=torch.zeros(m, dtype=torch.bool), y_cens=t(y))
    for a, b in zip(plain, none_c):
        assert a.numpy().tobytes() == b.numpy().tobytes()

    censored = gh_ei(*args, cens=t(cens), y_cens=t(y))
    mu_adj, sig_adj = tacq.censored_adjust(t(mu), t(sig), t(y), t(cens), 0.5)
    expect = gh_ei(mu_adj, sig_adj, t(u), *SCAL, t(xi))
    for a, b in zip(censored, expect):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    assert not np.array_equal(censored[0].numpy(), plain[0].numpy())

    j = tuple(map(jnp.asarray, (mu, sig, u)))
    for force in ("ref", "interpret"):
        want = jax_gh_ei(*j, *SCAL, jnp.asarray(xi), cens=jnp.asarray(cens),
                         y_cens=jnp.asarray(y), force=force)
        _same(want, censored)


def test_cpu_tensors_take_the_plain_version_and_kernel_raises():
    mu, sig, u = map(torch.as_tensor, _inputs(40, seed=1))
    xi = torch.as_tensor(gauss_hermite(3)[0])
    before = tkernel.gh_ei_cuda.launches
    eic, ok, nodes = gh_ei(mu, sig, u, *SCAL, xi)
    assert eic.shape == ok.shape == (40,) and nodes.shape == (3, 40)
    assert tkernel.gh_ei_cuda.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gh_ei(mu, sig, u, *SCAL, xi, force="kernel")
    with pytest.raises(ValueError, match="CUDA"):
        tkernel.gh_ei_cuda(mu, sig, u, *SCAL, xi)
