"""The port's acquisition functions against ``repro.core.acquisition``.

Inputs are random float32 with ±inf, NaN, signed zeros, subnormals and
z-scores spread over [-40, 40], made with numpy and given to both
packages.  Every output is compared by its bytes; NaNs compare by being
NaN, since IEEE leaves a NaN's sign and payload to the implementation and
no decision reads them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acquisition as ja
from repro_torch.core import acquisition as ta

# The tensors here are small: intra-op threads would only oversubscribe
# the test workers.
torch.set_num_threads(1)

N = 4000


def _vals(rng, n=N, scale=40.0):
    v = np.concatenate([
        rng.uniform(-scale, scale, n), rng.normal(0.0, 3.0, n),
        rng.uniform(0, 1, n) * 10.0 ** rng.integers(-45, 38, n),
        np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -1e-40, 1e-45,
                  -1e-45, 1.17e-38, 3.4e38, -3.4e38, 1.0, -1.0])])
    v = v.astype(np.float32)
    rng.shuffle(v)
    return v[:n]


def _same(want, got):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert want.dtype == got.dtype and want.shape == got.shape
    if want.dtype == np.float32:
        nan_w, nan_g = np.isnan(want), np.isnan(got)
        assert (nan_w == nan_g).all()
        want, got = np.where(nan_w, 0, want), np.where(nan_g, 0, got)
    assert want.tobytes() == got.tobytes()


@pytest.fixture(params=[0, 1, 2])
def data(request):
    rng = np.random.default_rng(request.param)
    mu, sig, ys, u = (_vals(rng) for _ in range(4))
    return dict(rng=rng, mu=mu, sig=np.abs(sig), sig_raw=sig, ys=ys,
                u=np.abs(u))


J = lambda a: jnp.asarray(a)
T = lambda a: torch.as_tensor(a)


@pytest.mark.parametrize("bits", [12, 4])
def test_quantize_scores(data, bits):
    _same(jax.jit(lambda x: ja.quantize_scores(x, bits))(J(data["mu"])),
          ta.quantize_scores(T(data["mu"]), bits))


@pytest.mark.parametrize("name", ["_exp_det", "_phi", "_Phi"])
def test_normal_polynomials(data, name):
    x = data["mu"]
    _same(jax.jit(getattr(ja, name))(J(x)), getattr(ta, name)(T(x)))
    z = np.linspace(-40, 40, 8001).astype(np.float32)
    _same(jax.jit(getattr(ja, name))(J(z)), getattr(ta, name)(T(z)))


def test_expected_improvement_and_constraint(data):
    mu, sig, ys, u = data["mu"], data["sig"], data["ys"], data["u"]
    t_max = np.float32(0.7)
    _same(jax.jit(ja.expected_improvement)(J(mu), J(sig), J(ys)),
          ta.expected_improvement(T(mu), T(sig), T(ys)))
    _same(jax.jit(ja.prob_leq)(J(mu), J(sig), J(ys)),
          ta.prob_leq(T(mu), T(sig), T(ys)))
    _same(jax.jit(ja.constraint_prob)(J(mu), J(sig), J(u), t_max),
          ta.constraint_prob(T(mu), T(sig), T(u), torch.tensor(t_max)))
    _same(jax.jit(ja.ei_constrained)(J(mu), J(sig), J(ys), J(u), t_max),
          ta.ei_constrained(T(mu), T(sig), T(ys), T(u), torch.tensor(t_max)))


@pytest.mark.parametrize("conf", [0.99, 0.5, 0.9])
def test_budget_ok(data, conf):
    mu, sig, beta = data["mu"], data["sig_raw"], data["ys"]
    _same(jax.jit(lambda a, b, c: ja.budget_ok(a, b, c, conf))(
        J(mu), J(sig), J(beta)),
        ta.budget_ok(T(mu), T(sig), T(beta), conf))
    assert ja.normal_quantile(conf) == ta.normal_quantile(conf)


def test_incumbent_rules(data):
    rng = data["rng"]
    y = data["ys"].reshape(-1, 16)
    sig = data["sig"].reshape(-1, 16)
    obs = rng.random(y.shape) < 0.4
    valid = rng.random(16) < 0.8
    bf = data["mu"][: y.shape[0]].copy()
    bf[::3] = np.inf
    for v in (None, valid):
        _same(jax.jit(ja.incumbent_fallback)(
            J(bf), J(y), J(obs), J(sig), None if v is None else J(v)),
            ta.incumbent_fallback(T(bf), T(y), T(obs), T(sig),
                                  None if v is None else T(v)))
    feas = rng.random(16) < 0.5
    _same(jax.jit(ja.incumbent)(J(y[0]), J(obs[0]), J(feas), J(y[0]),
                                J(sig[0])),
          ta.incumbent(T(y[0]), T(obs[0]), T(feas), T(y[0]), T(sig[0])))


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_gauss_hermite_nodes_and_expectation(data, k):
    xi_j, w_j = ja.gauss_hermite(k)
    xi_t, w_t = ta.gauss_hermite(k)
    assert xi_j.tobytes() == xi_t.tobytes() and w_j.tobytes() == w_t.tobytes()
    mu, sig = data["mu"], data["sig"]
    _same(jax.jit(ja.gh_cost_nodes)(J(mu), J(sig), J(xi_j)),
          ta.gh_cost_nodes(T(mu), T(sig), T(xi_t)))
    vals = data["ys"][: (N // k) * k].reshape(-1, k)
    _same(jax.jit(lambda v: ja.gh_expect(v, w_j))(J(vals)),
          ta.gh_expect(T(vals), w_t))


def test_censored_adjust(data):
    mu, sig, y = data["mu"], data["sig"], data["ys"]
    cens = data["rng"].random(N) < 0.3
    for want, got in zip(
            jax.jit(lambda *a: ja.censored_adjust(*a, 0.5))(
                J(mu), J(sig), J(y), J(cens)),
            ta.censored_adjust(T(mu), T(sig), T(y), T(cens), 0.5)):
        _same(want, got)


@pytest.mark.parametrize("kappa,mult", [(1.0, 3.0), (0.5, 1.0)])
def test_timeout_cap(data, kappa, mult):
    """τ is billed: bitwise, including the infeasible-incumbent branch."""
    bf, sig, u, beta = data["ys"], data["sig"], data["u"], data["mu"]
    f = jax.jit(ja.timeout_cap, static_argnums=(5, 6))
    _same(f(J(bf), J(sig), J(u), J(beta), jnp.float32(0.3), kappa, mult),
          ta.timeout_cap(T(bf), T(sig), T(u), T(beta), torch.tensor(0.3),
                         kappa, mult))


def test_no_contract_value_semantics(data):
    x = data["mu"]
    _same(jax.jit(ja.no_contract)(J(x)), ta.no_contract(T(x)))
