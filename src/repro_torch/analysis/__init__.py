"""Determinism-contract auditor of the port: trace audit + source lint.

The torch counterpart of ``repro.analysis``.  Two layers enforce the
contract every slice of the port keeps (quantized argmaxes, size-invariant
PRNG, masked padded reductions, no float64 leaks or host round trips):

* ``trace_audit`` + ``rules`` — run a program under a ``TorchDispatchMode``
  and walk the aten operations it records, propagating value labels, with
  the rules R1-R4 as sink checks (the counterpart of ``make_jaxpr`` and the
  jaxpr walker);
* ``ast_lint`` — source rules over ``src/repro_torch`` with the justified
  ``allowlist``.

``registry`` lists the audited port programs, ``fixtures`` the
deliberately broken programs that self-test each rule (one of them
launches the masked-argmax kernel), and ``python -m repro_torch.analysis``
runs the gate.  :func:`signature` renders a program's canonical text (the
ordered aten operations it runs), which the forensics artifacts carry.
"""

from repro_torch.analysis.registry import (ProgramSpec, audit_all,
                                           audit_program,
                                           registered_programs)
from repro_torch.analysis.rules import (ForbiddenPrimitivesRule,
                                        MaskedReduceRule,
                                        NoF64NoCallbackRule,
                                        QuantizedArgmaxRule,
                                        SizeInvariantPRNGRule, default_rules)
from repro_torch.analysis.trace_audit import (Finding, Labels, Op, audit,
                                              signature)

__all__ = [
    "Finding", "Labels", "Op", "audit", "QuantizedArgmaxRule",
    "SizeInvariantPRNGRule", "MaskedReduceRule", "NoF64NoCallbackRule",
    "ForbiddenPrimitivesRule", "default_rules", "ProgramSpec",
    "registered_programs", "audit_program", "audit_all", "signature",
]
