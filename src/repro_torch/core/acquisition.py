"""Acquisition machinery: EI, constrained EI, budget filter, Gauss-Hermite.

The PyTorch form of ``repro.core.acquisition`` (paper §3), value for value:

* ``EI(x) = (y* - mu)·Phi(z) + sigma·phi(z)``, ``z = (y* - mu)/sigma``;
* ``EI_c(x) = EI(x) · P(C(x) <= T_max · U(x))`` through the one cost model;
* ``y*`` = cheapest feasible observed cost, else ``max observed cost +
  3 · max sigma over untested``;
* the Gamma budget filter ``(beta - mu)/sigma >= Phi^-1(conf)`` in z-space;
* Gauss-Hermite cost nodes and the pinned, fenced G-H expectation;
* timeout-censored learning (``censored_adjust``, ``timeout_cap``).

Every function reproduces the reference's float32 operation sequence, so a
decision taken here equals the JAX package's bit for bit.  The rules that
takes, on the CPU and on the card alike:

* each constant enters as the float32 value JAX's 32-bit canonicalisation
  gives it (``_f32``);
* each operation is one IEEE float32 operation: torch evaluates eagerly,
  so no product is contracted into an FMA, and ``no_contract`` is kept
  only for its value semantics (NaN -> 0).  Where the reference's compiled
  program does contract a product (the forest mean, ``mu_parts``),
  :func:`fma` reproduces the single rounding;
* a division by a constant divides by a tensor (``_div``): CUDA torch turns
  ``tensor / python_scalar`` into a multiply by the reciprocal, which
  rounds differently.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

__all__ = [
    "expected_improvement", "prob_leq", "constraint_prob", "ei_constrained",
    "ei_constrained_factors",
    "incumbent", "incumbent_fallback", "budget_ok", "normal_quantile",
    "quantize_scores", "no_contract", "gh_expect", "ftz", "sqrt_rn", "fma",
    "gauss_hermite", "gh_cost_nodes", "censored_adjust", "timeout_cap",
]


def _f32(x) -> float:
    """A constant as JAX's 32-bit mode sees it: rounded to float32."""
    return float(np.float32(x))


def _div(a: torch.Tensor, b) -> torch.Tensor:
    """True float32 division, also when ``b`` is a Python number."""
    if not isinstance(b, torch.Tensor):
        b = torch.tensor(_f32(b), dtype=torch.float32, device=a.device)
    return a / b


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root.  torch's vectorized CPU
    ``sqrt`` for float32 is off by an ulp for some inputs; the float64 root
    rounded once to float32 is exact (53 >= 2·24 + 2 bits) on every
    device."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


_SIG_EPS = _f32(1e-12)
_TINY = float(np.finfo(np.float32).tiny)


def ftz(x: torch.Tensor) -> torch.Tensor:
    """Flush float32 subnormals to signed zero.

    The reference runs on XLA's CPU backend, which computes with
    flush-to-zero and denormals-are-zero set; torch, on the CPU and on the
    card, keeps subnormals.  The acquisition math flushes wherever a
    subnormal can arise or enter (the far EI tail) so both packages take
    the same decisions there.  The CUDA kernel is built with ``-ftz=true``.
    """
    return torch.where(torch.abs(x) < _TINY, x * 0.0, x)


def fma(a, b, c) -> torch.Tensor:
    """float32 ``a*b + c`` with a single rounding (flushed to zero).

    The reference's backend contracts some products into the add or
    subtraction that consumes them; this reproduces such a contracted
    operation on any device.  The float32 product is exact in float64; the
    float64 sum ``s`` is rounded once more to float32, and where ``s`` sits
    exactly halfway between two float32 values the sign of its float64
    rounding error (TwoSum) picks the side the exact sum lies on.
    """
    dev = next((v.device for v in (a, b, c) if isinstance(v, torch.Tensor)),
               None)
    a, b, c = torch.broadcast_tensors(
        *(torch.as_tensor(v, dtype=torch.float32, device=dev)
          for v in (a, b, c)))
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bp = s - p
    err = (p - (s - bp)) + (cd - bp)
    r = s.to(torch.float32)
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, math.inf, -math.inf)
                            .to(torch.float32))
    tie = (s != rd) & (s == (rd + other.double()) * 0.5) & (err != 0)
    side = torch.where(err > 0, torch.maximum(r, other),
                       torch.minimum(r, other))
    return ftz(torch.where(tie, side, r))


def _minus_mu(c, mu, mu_parts):
    """``c - mu``; with ``mu_parts = (acc, inv)`` (``mu = acc·inv``) the
    product is contracted into the subtraction, as the reference's backend
    compiles a forest mean consumed in the same fused loop."""
    if mu_parts is None:
        return ftz(ftz(c) - ftz(mu))
    acc, inv = mu_parts
    return fma(acc, -inv, ftz(torch.as_tensor(c, dtype=torch.float32,
                                              device=acc.device)))


_MASK32 = 0xFFFFFFFF


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (the uint32/int32 views)."""
    return (((v + (1 << 31)) & _MASK32) - (1 << 31)).to(torch.int32)


def quantize_scores(x: torch.Tensor, bits: int = 12) -> torch.Tensor:
    """Round float32 scores to ``bits`` mantissa bits before an argmax.

    Near-ties collapse to exact ties, which break by lowest index in every
    context.  Pure bit arithmetic on the uint32 view (done in int64: torch
    has no full uint32 arithmetic).  Infinities and NaNs pass through.
    """
    x = x.to(torch.float32)
    u = x.view(torch.int32).to(torch.int64) & _MASK32
    half = 1 << (22 - bits)
    mask = (0xFFFFFFFF << (23 - bits)) & _MASK32
    q = _to_int32((u + half) & mask).view(torch.float32)
    return torch.where(torch.isnan(x), x, q)


def no_contract(x: torch.Tensor) -> torch.Tensor:
    """The reference's FMA fence, kept for its value: NaN -> 0.

    Eager torch never contracts a product into a neighbouring add, so the
    fence itself is free here; its NaN-to-zero mapping is part of the
    reference's arithmetic and stays.
    """
    return torch.where(x == x, x, torch.zeros_like(x))


# --------------------------------------------------------------------------- #
# Deterministic normal pdf/cdf (fenced polynomials, as in the reference).
# --------------------------------------------------------------------------- #
_INV_SQRT2PI = _f32(1.0 / np.sqrt(2.0 * np.pi))
_LOG2E = _f32(1.4426950408889634)
_LN2_HI = _f32(0.693359375)
_LN2_LO = _f32(-2.12194440e-4)
_EXP_COEFFS = tuple(_f32(c) for c in
                    (1 / 720, 1 / 120, 1 / 24, 1 / 6, 0.5, 1.0, 1.0))
_PHI_P = _f32(0.2316419)
_PHI_B = tuple(_f32(b) for b in
               (1.330274429, -1.821255978, 1.781477937, -0.356563782,
                0.319381530))
_I32_MAX_F = 2147483520.0     # largest float32 below 2^31


def _f2i32(n: torch.Tensor) -> torch.Tensor:
    """XLA's float32 -> int32 convert, as int64: saturating, NaN -> 0."""
    n = torch.where(torch.isnan(n), torch.zeros_like(n), n)
    big = n > _I32_MAX_F
    out = n.clamp(-2147483648.0, _I32_MAX_F).to(torch.int64)
    return torch.where(big, torch.full_like(out, 2147483647), out)


def _exp_det(x: torch.Tensor) -> torch.Tensor:
    """Fenced exp for non-positive arguments (underflows to exact 0)."""
    x = x.to(torch.float32)
    n = torch.round(x * _LOG2E)
    r = (x - no_contract(n * _LN2_HI)) - no_contract(n * _LN2_LO)
    acc = torch.full_like(r, _EXP_COEFFS[0])
    for c in _EXP_COEFFS[1:]:
        acc = no_contract(acc * r) + c
    bits = acc.view(torch.int32).to(torch.int64) + (_f2i32(n) << 23)
    out = _to_int32(bits).view(torch.float32)
    return torch.where(x < -86.0, torch.zeros_like(out), out)


def _phi(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal pdf via the fenced exp."""
    z = z.to(torch.float32)
    return _INV_SQRT2PI * _exp_det((-0.5 * z) * z)


def _Phi(z: torch.Tensor) -> torch.Tensor:
    """Standard-normal cdf, A&S 26.2.17 with fenced Horner steps."""
    z = ftz(z.to(torch.float32))
    a = torch.abs(z)
    t = _div(torch.ones_like(a), no_contract(_PHI_P * a) + 1.0)
    poly = torch.full_like(t, _PHI_B[0])
    for b in _PHI_B[1:]:
        poly = no_contract(poly * t) + b
    tail = ftz(no_contract(_phi(a) * (poly * t)))
    return torch.where(z >= 0, 1.0 - tail, tail)


def _sig(sigma):
    return torch.maximum(ftz(sigma), torch.full_like(sigma, _SIG_EPS))


def expected_improvement(mu, sigma, y_star, mu_parts=None) -> torch.Tensor:
    """Closed-form EI for minimization. Shapes broadcast.  ``mu_parts``:
    see :func:`_minus_mu`."""
    s = _sig(sigma)
    d = _minus_mu(y_star, mu, mu_parts)
    z = ftz(d / s)
    out = ftz(ftz(no_contract(d * _Phi(z))) + ftz(no_contract(s * _phi(z))))
    # max(out, 0) as the reference's backend takes it: a tie (-0.0 against
    # +0.0, after a subnormal sum flushed to -0.0) returns +0.0, where
    # torch.maximum would return -0.0; NaN propagates.
    zero = torch.zeros_like(out)
    return torch.where((out > zero) | (out != out), out, zero)


def prob_leq(mu, sigma, bound, mu_parts=None) -> torch.Tensor:
    """P(N(mu, sigma) <= bound)."""
    return _Phi(ftz(_minus_mu(bound, mu, mu_parts) / _sig(sigma)))


def constraint_prob(mu_c, sigma_c, unit_price, t_max, mu_parts=None
                    ) -> torch.Tensor:
    """P(T(x) <= T_max) computed through the cost model: P(C <= T_max·U)."""
    return prob_leq(mu_c, sigma_c,
                    ftz(no_contract(ftz(t_max) * ftz(unit_price))), mu_parts)


def ei_constrained_factors(mu, sigma, y_star, unit_price, t_max,
                           mu_parts=None):
    """EI and P(feasible), the two factors of :func:`ei_constrained`, for a
    consumer that contracts their product into an addition (:func:`fma`)."""
    return (expected_improvement(mu, sigma, y_star, mu_parts),
            constraint_prob(mu, sigma, unit_price, t_max, mu_parts))


def ei_constrained(mu, sigma, y_star, unit_price, t_max, mu_parts=None
                   ) -> torch.Tensor:
    """EI_c.  ``mu_parts = (acc, inv)`` when ``mu`` is the raw forest mean
    ``acc·inv``: the reference's backend then contracts that product into
    ``y* - mu`` and ``bound - mu`` (:func:`_minus_mu`)."""
    ei, cp = ei_constrained_factors(mu, sigma, y_star, unit_price, t_max,
                                    mu_parts)
    return ftz(ei * cp)


def _masked_max(x, mask) -> torch.Tensor:
    return torch.where(mask, ftz(x), torch.full_like(x, -math.inf)).amax(
        dim=-1)


def incumbent_fallback(best_feas, y, obs_mask, sigma, valid=None):
    """y* given a (possibly infinite) best feasible observed cost: the
    cost itself, else ``max observed cost + 3·max sigma`` over the untested
    points.  Batched over leading axes (reductions over the last, point,
    axis); ``valid`` masks geometry-bucket padding lanes out of the
    untested-sigma term."""
    obs = obs_mask.to(torch.bool)
    untested = ~obs if valid is None else ~obs & valid.to(torch.bool)
    fallback = ftz(_masked_max(y, obs)
                   + ftz(no_contract(3.0 * _masked_max(sigma, untested))))
    return torch.where(torch.isfinite(best_feas), best_feas, fallback)


def incumbent(y, obs_mask, feasible_mask, mu, sigma, valid=None):
    """The paper's y* rule: cheapest observed feasible cost, else the
    :func:`incumbent_fallback` rule."""
    obs = obs_mask.to(torch.bool)
    feas_obs = obs & feasible_mask.to(torch.bool)
    best_feas = torch.where(feas_obs, y, torch.full_like(y, math.inf)).amin()
    return incumbent_fallback(best_feas, y, obs_mask, sigma, valid)


@functools.lru_cache(maxsize=None)
def normal_quantile(conf: float) -> float:
    """Standard-normal quantile Phi^-1(conf), host-side float64 bisection."""
    if not 0.0 < conf < 1.0:
        raise ValueError(f"conf must be in (0, 1), got {conf}")
    lo, hi = -40.0, 40.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if 0.5 * (1.0 + math.erf(mid / math.sqrt(2.0))) < conf:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def budget_ok(mu, sigma, beta, conf: float = 0.99, mu_parts=None
              ) -> torch.Tensor:
    """Gamma filter: ``(beta - mu)/sigma >= Phi^-1(conf)``, compared against
    the float32 quantile (Alg. 1 line 23)."""
    z = ftz(_minus_mu(beta, mu, mu_parts) / _sig(sigma))
    return z >= _f32(normal_quantile(float(conf)))


def gauss_hermite(k: int) -> tuple[np.ndarray, np.ndarray]:
    """Physicists' Gauss-Hermite nodes/weights, weights normalized to sum 1."""
    xi, om = np.polynomial.hermite.hermgauss(k)
    return xi.astype(np.float32), (om / np.sqrt(np.pi)).astype(np.float32)


_SQRT2 = _f32(np.sqrt(2.0))


def gh_cost_nodes(mu, sigma, xi, mu_parts=None) -> torch.Tensor:
    """Speculated cost values ``mu + sqrt(2)·sigma·xi_i``; broadcasts over xi.

    ``mu_parts = (acc, inv)`` when ``mu`` is the raw forest mean ``acc·inv``
    computed in the same program: the reference's backend then contracts
    that product into the node's addition (one rounding, :func:`fma`)."""
    step = ftz(no_contract(ftz(ftz(_SQRT2 * ftz(sigma[..., None])) * xi)))
    if mu_parts is not None:
        acc, inv = mu_parts
        return fma(acc[..., None], inv, step)
    return ftz(ftz(mu[..., None]) + step)


def gh_expect(vals: torch.Tensor, w) -> torch.Tensor:
    """``sum_i w_i · vals[..., i]``, left to right, each product fenced."""
    w = [float(v) for v in np.asarray(w, np.float32)]

    def term(i):
        # XLA folds a product by an exact 1.0 away (k = 1 has w = [1.0]).
        v = vals[..., i]
        return no_contract(v) if w[i] == 1.0 else ftz(no_contract(v * w[i]))

    acc = term(0)
    for i in range(1, vals.shape[-1]):
        acc = ftz(acc + term(i))
    return acc


# --------------------------------------------------------------------------- #
# Timeout-censored exploration (paper §3, mechanism i)
# --------------------------------------------------------------------------- #
def censored_adjust(mu, sigma, y, cens, rel):
    """Posterior correction at censored (timed-out) observations: mean
    clamped to ``>= y``, sigma floored at ``rel·|y|``; a bitwise no-op where
    ``cens`` is False."""
    c = cens.to(torch.bool)
    mu_adj = torch.where(c, torch.maximum(ftz(mu), ftz(y)), mu)
    floor = ftz(_f32(rel) * torch.abs(ftz(y)))
    sigma_adj = torch.where(c, torch.maximum(ftz(sigma), floor), sigma)
    return mu_adj, sigma_adj


def timeout_cap(best_feas, sigma_sel, u_sel, beta, t_max, kappa, tmax_mult
                ) -> torch.Tensor:
    """Per-exploration predictive timeout τ, in runtime units (paper §3):
    ``min(tmax_mult·t_max, beta/U)``, tightened to ``(y* + kappa·sigma)/U``
    once a feasible incumbent exists; sigma enters on a 4-bit grid.  τ is
    billed, so every operation here is exact float32 arithmetic."""
    dev = best_feas.device
    f = lambda v: ftz(torch.as_tensor(v, dtype=torch.float32, device=dev))
    best_feas, t_max, beta, u_sel = f(best_feas), f(t_max), f(beta), f(u_sel)
    u_floor = torch.maximum(u_sel, torch.full_like(u_sel, _SIG_EPS))
    cap = torch.minimum(ftz(t_max * _f32(tmax_mult)),
                        ftz(torch.maximum(beta, torch.zeros_like(beta))
                            / u_floor))
    sig_q = quantize_scores(sigma_sel, bits=4)
    pred = ftz(ftz(best_feas + ftz(no_contract(_f32(kappa) * ftz(sig_q))))
               / u_floor)
    return torch.where(torch.isfinite(best_feas), torch.minimum(cap, pred),
                       cap)
