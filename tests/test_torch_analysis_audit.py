"""The port's trace audit (``repro_torch.analysis``), on the CPU.

The mutation self-check (each broken fixture gives exactly one finding of
its rule, the clean twins none), with the fixture names and rules of the
JAX package's ``repro.analysis.fixtures``; the per-rule targeted programs
of ``tests/test_analysis_audit.py`` in torch; the kernel launch path,
rehearsed with an opaque stand-in kernel; registered selector and episode
programs at a small geometry; and the gate's command line.
"""

import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
from torch.utils._python_dispatch import _disable_current_modes

from repro.analysis.fixtures import fixtures as jax_fixtures
from repro_torch.analysis import (ForbiddenPrimitivesRule, MaskedReduceRule,
                                  NoF64NoCallbackRule, QuantizedArgmaxRule,
                                  SizeInvariantPRNGRule, audit)
from repro_torch.analysis.fixtures import (check_fixtures, fixtures,
                                           run_fixtures)
from repro_torch.analysis.registry import audit_program, registered_programs
from repro_torch.core import prng
from repro_torch.core.acquisition import fma, quantize_scores, sqrt_rn
from repro_torch.kernels.masked_argmax import kernel as ma_kernel
from repro_torch.kernels.masked_argmax import ops as ma_ops
from repro_torch.kernels.masked_argmax import ref as ma_ref

ROOT = pathlib.Path(__file__).resolve().parents[1]

torch.set_num_threads(1)


def test_mutation_self_check_is_healthy():
    assert check_fixtures("cpu") == []


def test_fixtures_mirror_the_reference():
    """Same names and rules as the JAX package's fixtures, the kernel
    fixture renamed for the port's kernel (no Pallas)."""
    want = {f.name: f.rule for f in jax_fixtures()}
    got = {f.name: f.rule for f in fixtures()}
    assert got == want


# --------------------------------------------------------------------------- #
# Targeted per-rule programs (the reference's, in torch)
# --------------------------------------------------------------------------- #
def test_r1_flags_raw_float_argmax_but_not_quantized_or_integer():
    raw = audit(lambda s: torch.argmax(s), (torch.ones(8),),
                [QuantizedArgmaxRule()])
    assert [f.rule for f in raw] == ["R1"]
    quant = audit(lambda s: torch.argmax(quantize_scores(s)),
                  (torch.ones(8),), [QuantizedArgmaxRule()])
    assert quant == []
    ints = audit(lambda s: torch.argmax(s),
                 (torch.ones(8, dtype=torch.int32),), [QuantizedArgmaxRule()])
    assert ints == []


def test_r1_sees_through_where_passthrough():
    """The NaN/validity select around a quantized score keeps the quant
    flag — the real selectors all argmax over a where()."""
    def fn(s, ok):
        q = quantize_scores(s)
        return torch.argmax(torch.where(ok, q, -math.inf))

    assert audit(fn, (torch.ones(8), torch.ones(8, dtype=torch.bool)),
                 [QuantizedArgmaxRule()]) == []


def test_r2_flags_geometry_dependent_split_only():
    key = prng.PRNGKey(0)

    def bad(k):
        return prng.split(k, 8)

    def good(k):
        return prng.fold_in(k[None, :], torch.arange(8))

    assert [f.rule for f in audit(bad, (key,),
                                  [SizeInvariantPRNGRule()])] == ["R2"]
    assert audit(good, (key,), [SizeInvariantPRNGRule()]) == []
    # a plain 2-way split is size-invariant and allowed
    assert audit(lambda k: prng.split(k), (key,),
                 [SizeInvariantPRNGRule()]) == []


def test_r3_requires_mask_domination_of_m_reductions():
    m = 8
    args = (torch.ones(m), torch.zeros(m, dtype=torch.bool))
    rules = [MaskedReduceRule(m=m, mask_argnums=(1,))]
    bad = audit(lambda y, obs: torch.sum(y), args, rules)
    assert [f.rule for f in bad] == ["R3"]
    assert audit(lambda y, obs: torch.sum(y * obs.to(y.dtype)), args,
                 rules) == []
    # a product contracting M: a masked factor zeroes the padding
    args = args + (torch.ones(m, 3),)
    bad = audit(lambda y, obs, w: y[None, :] @ w, args, rules)
    assert [f.rule for f in bad] == ["R3"]
    assert audit(lambda y, obs, w: (y * obs)[None, :] @ w, args,
                 rules) == []


def test_r3_understands_antimask_negation():
    """~mask is True at padding (antimask); ``where(~obs & valid, ...)``
    must still count as mask-dominated."""
    m = 8

    def fn(y, obs, valid):
        untested = ~obs & valid
        return torch.where(untested, y, -math.inf).amax()

    args = (torch.ones(m), torch.zeros(m, dtype=torch.bool),
            torch.zeros(m, dtype=torch.bool))
    assert audit(fn, args, [MaskedReduceRule(m=m, mask_argnums=(1, 2))]) == []


def test_r4_flags_f64_and_callbacks_but_not_the_rounding_helpers():
    f64 = audit(lambda x: x.to(torch.float64).to(torch.float32),
                (torch.tensor(1.0),), [NoF64NoCallbackRule()])
    assert [f.rule for f in f64] == ["R4"]
    found = audit(lambda x: torch.full_like(x, x.item()),
                  (torch.tensor(1.0),), [NoF64NoCallbackRule()])
    assert [(f.rule, f.op) for f in found] == [("R4", "_local_scalar_dense")]
    # indexing with a 0-d tensor reads it on the host
    found = audit(lambda x, i: x[i], (torch.ones(4), torch.tensor(1)),
                  [NoF64NoCallbackRule()])
    assert [f.rule for f in found] == ["R4"]
    # sqrt_rn and fma compute in float64 and round once: allowed
    x = torch.rand(8)
    assert audit(lambda a: fma(a, a, sqrt_rn(a)), (x,),
                 [NoF64NoCallbackRule()]) == []


def test_forbidden_primitives_rule_records_the_call_path():
    """An erf buried in a callee is found, with the callee on its path."""
    def inner(z):
        return torch.erf(z)

    findings = audit(lambda z: inner(z), (torch.ones(4),),
                     [ForbiddenPrimitivesRule(("erf",))])
    assert [f.rule for f in findings] == ["FORBID"]
    assert findings[0].path[-1].endswith("inner")


# --------------------------------------------------------------------------- #
# The kernel path, rehearsed on the CPU
# --------------------------------------------------------------------------- #
def test_kernel_launch_is_followed_through_its_declared_plain_version(
        monkeypatch):
    """On the card the mode sees only the wrapper's ``torch.empty``.  An
    opaque stand-in kernel (the plain version computed outside the mode)
    shows that the op's declaration carries the labels: the broken kernel
    fixture still gives its R1, under ``kernel:masked_argmax``, and the
    clean one gives none."""
    def opaque(score, valid, *, quantize=True):
        out = torch.empty((1,), dtype=torch.int32)
        with _disable_current_modes():
            out.copy_(ma_ref.masked_argmax_ref(score, valid,
                                               quantize=quantize))
        return out

    monkeypatch.setattr(ma_kernel, "masked_argmax_cuda", opaque)
    monkeypatch.setattr(ma_ops, "resolve_mode",
                        lambda force, device, op="": "kernel")
    found = run_fixtures("cpu")
    assert found["fixture/clean_kernel"] == []
    broken = found["fixture/r1_unquantized_kernel_argmax"]
    assert [f.rule for f in broken] == ["R1"]
    assert broken[0].path[0] == "kernel:masked_argmax"
    assert check_fixtures("cpu") == []


# --------------------------------------------------------------------------- #
# Registered programs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", [
    "selector/lynceus/native",
    "selector/lynceus/padded",
    "selector/lynceus/padded/fused",
    "selector/lynceus/padded/timeout",
    "episode/lockstep",
    "episode/lockstep/timeout",
    "episode/segment",
    "episode/segment/bucketed",
])
def test_registered_program_audits_clean(name):
    spec = {s.name: s for s in registered_programs()}[name]
    findings = audit_program(spec, "cpu")
    assert findings == [], [str(f) for f in findings]


def test_registry_names_unique_and_cover_every_kernel():
    names = [s.name for s in registered_programs()]
    assert len(names) == len(set(names))
    from repro_torch import kernels
    for op in kernels.__all__:
        if op != "resolve_mode":
            assert f"kernel/{op}/kernel" in names, op


def test_gate_command_line_passes_on_the_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--all", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "determinism gate: OK" in out.stdout
