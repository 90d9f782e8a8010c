"""Mutation self-test fixtures: one deliberately broken program per rule.

The torch counterpart of ``repro.analysis.fixtures``.  The auditor is only
trustworthy if it still fires: each fixture is a compact padded-selector
variant seeded with exactly one contract violation, the bug class its rule
was written for, and :func:`check_fixtures` asserts that the audit of each
gives exactly one finding, of exactly the expected rule, while the
unbroken twins audit clean.

The fixtures run on the device they are built for (``device``): on the
card, ``_kernel_argmax`` launches the CUDA masked-argmax kernel, whose
labels the walker follows through its declared plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.analysis.rules import default_rules
from repro_torch.analysis.trace_audit import Finding, audit
from repro_torch.device import resolve_device

__all__ = ["Fixture", "fixtures", "audit_fixture", "check_fixtures"]

_M = 16           # padded candidate width of the mini selector


@dataclasses.dataclass(frozen=True)
class Fixture:
    name: str
    rule: str                 # the one rule expected to fire
    build: Callable[[torch.device], tuple[Callable, tuple, list]]


def _mini_selector(broken: str | None, device):
    """A compact padded selector sharing the real programs' op patterns:
    masked posterior, incumbent fallback, per-index PRNG jitter, masked +
    quantized argmax.  ``broken`` seeds one violation."""
    from repro_torch.core import prng
    from repro_torch.core.acquisition import quantize_scores

    def fn(key, y, obs, valid, beta):
        w = obs.to(torch.float32)
        n = torch.clamp_min(w.sum(), 1.0)
        mean = (y * w).sum() / n
        mu = torch.where(obs, y, mean)
        sigma = torch.abs(y - mean) + 0.1
        untested = ~obs & valid
        if broken == "r3":
            # Historical bug class: the untested-sigma fallback term forgot
            # the validity mask - a padding lane's posterior spread moves y*.
            spread = torch.where(~obs, sigma, -math.inf).amax()
        else:
            spread = torch.where(untested, sigma, -math.inf).amax()
        ystar = torch.where(obs, y, -math.inf).amax() + 3.0 * spread
        ei = torch.clamp_min(ystar - mu, 0.0) + sigma
        if broken == "r2":
            # Historical bug class: the per-point key tree derives from the
            # (geometry-dependent) point count via split.
            keys = prng.split(key, _M)
        else:
            keys = prng.fold_in(key[None, :],
                                torch.arange(_M, device=key.device))
        jitter = prng.uniform(keys, ())
        score = torch.where(untested, ei + 1e-6 * jitter, -math.inf)
        if broken != "r1":
            # Historical bug class when skipped: a raw-score argmax breaks
            # near-ties differently per compilation geometry.
            score = quantize_scores(score)
        sel = torch.argmax(score).reshape(1)
        out_beta = beta - mu[sel]
        if broken == "r4_callback":
            out_beta = torch.full_like(out_beta, out_beta.item())
        return sel, untested.any(), out_beta

    dev = torch.device(device)
    args = (torch.zeros(2, dtype=torch.int64, device=dev),
            torch.zeros(_M, dtype=torch.float32, device=dev),
            torch.zeros(_M, dtype=torch.bool, device=dev),
            torch.zeros(_M, dtype=torch.bool, device=dev),
            torch.tensor(3.0, dtype=torch.float32, device=dev))
    rules = default_rules(m=_M, mask_argnums=(2, 3))
    return fn, args, rules


def _kernel_argmax(broken: bool, device):
    """Mini fused-selector step: masked scores and their argmax inside the
    masked-argmax kernel (``kernels.masked_argmax``).  ``broken=True`` seeds
    the in-kernel variant of the R1 bug class: the kernel argmaxes raw
    float scores, which the walker must still catch through the launch's
    declared plain version."""
    from repro_torch.kernels.masked_argmax.ops import masked_argmax

    def fn(score, valid):
        return masked_argmax(score, valid, quantize=not broken)

    dev = torch.device(device)
    args = (torch.zeros(_M, dtype=torch.float32, device=dev),
            torch.zeros(_M, dtype=torch.bool, device=dev))
    return fn, args, default_rules(m=_M, mask_argnums=(1,))


def _f64_leak(device):
    """Historical bug class: float64 arithmetic leaking into an episode
    state update, rounded straight back to float32."""
    fn = lambda beta: beta.to(torch.float64).to(torch.float32)
    args = (torch.tensor(3.0, dtype=torch.float32,
                         device=torch.device(device)),)
    return fn, args, default_rules(m=_M, mask_argnums=())


def fixtures() -> list[Fixture]:
    return [
        Fixture("fixture/r1_unquantized_argmax", "R1",
                lambda d: _mini_selector("r1", d)),
        Fixture("fixture/r2_shape_dependent_split", "R2",
                lambda d: _mini_selector("r2", d)),
        Fixture("fixture/r3_unmasked_sigma_max", "R3",
                lambda d: _mini_selector("r3", d)),
        Fixture("fixture/r4_f64_promotion", "R4", _f64_leak),
        Fixture("fixture/r4_host_callback", "R4",
                lambda d: _mini_selector("r4_callback", d)),
        Fixture("fixture/r1_unquantized_kernel_argmax", "R1",
                lambda d: _kernel_argmax(True, d)),
    ]


def audit_fixture(fx: Fixture, device="cuda") -> list[Finding]:
    """Audit one fixture on ``device``: the card unless the caller asks for
    the CPU (``cuda`` without a card raises)."""
    fn, args, rules = fx.build(resolve_device(device))
    return audit(fn, args, rules, program=fx.name)


# The unbroken twins: the mini selector and the mini kernel step.
_CLEAN_TWINS = {"fixture/clean": lambda d: _mini_selector(None, d),
                "fixture/clean_kernel": lambda d: _kernel_argmax(False, d)}


def run_fixtures(device="cuda") -> dict[str, list[Finding]]:
    """Every fixture's and clean twin's findings, by name, on ``device``
    (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    out = {}
    for tag, build in _CLEAN_TWINS.items():
        fn, args, rules = build(device)
        out[tag] = audit(fn, args, rules, program=tag)
    for fx in fixtures():
        out[fx.name] = audit_fixture(fx, device)
    return out


def check_fixtures(device="cuda") -> list[str]:
    """Run the mutation self-test on ``device`` (the card unless the caller
    asks for the CPU); returns error strings (empty = healthy).

    Checks, per fixture: exactly one finding, of exactly the expected rule.
    Plus: the unbroken twins audit clean."""
    found = run_fixtures(device)
    errors: list[str] = []
    for tag in _CLEAN_TWINS:
        if found[tag]:
            errors.append(f"{tag}: unbroken twin produced findings: "
                          f"{[str(f) for f in found[tag]]}")
    for fx in fixtures():
        got = found[fx.name]
        rules_hit = sorted({f.rule for f in got})
        if not got:
            errors.append(f"{fx.name}: expected a {fx.rule} finding, "
                          "got none (false negative)")
        elif rules_hit != [fx.rule]:
            errors.append(f"{fx.name}: expected only {fx.rule}, got "
                          f"{rules_hit}: {[str(f) for f in got]}")
        elif len(got) != 1:
            errors.append(f"{fx.name}: expected exactly one finding, got "
                          f"{len(got)}: {[str(f) for f in got]}")
    return errors
