"""The port's determinism gate: AST lint + trace audit + mutation self-check.

The counterpart of ``scripts/lint_repro.py``:

* default        — AST lint over ``src/repro_torch`` through the justified
  allowlist; fails on any unsuppressed finding or stale allowlist entry;
* ``--audit``      — run every registered program (selectors, kernel ops)
  under the trace audit; fails on any finding;
* ``--self-check`` — the mutation self-test: each deliberately broken
  fixture must give exactly its expected finding, the clean twins none.

``--all`` runs all three.  ``--device`` picks where the programs run: the
card by default (``cuda``: the kernels launch), ``cpu`` for the plain
versions.

  PYTHONPATH=src python -m repro_torch.analysis --all --device cpu
"""

from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[3]


def run_ast_lint() -> bool:
    from repro_torch.analysis.ast_lint import lint_tree

    findings, suppressed, stale = lint_tree(ROOT)
    for f in findings:
        print(f"FAIL  {f}")
        if f.source:
            print(f"      > {f.source}")
    for a in stale:
        print(f"FAIL  stale allowlist entry (matches nothing): "
              f"{a.file} [{a.rule}] match={a.match!r}")
    print(f"ast-lint: {len(findings)} finding(s), "
          f"{len(suppressed)} suppressed by allowlist, "
          f"{len(stale)} stale allowlist entr(ies)")
    return not findings and not stale


def run_audit(device) -> bool:
    from repro_torch.analysis.registry import audit_all, registered_programs

    t0 = time.perf_counter()
    n_programs = len(registered_programs())
    findings = audit_all(device,
                         progress=lambda name: print(f"  audit {name}"))
    for f in findings:
        print(f"FAIL  {f}")
    print(f"trace-audit: {n_programs} program(s) on {device}, "
          f"{len(findings)} finding(s) [{time.perf_counter() - t0:.1f}s]")
    return not findings


def run_self_check(device) -> bool:
    from repro_torch.analysis.fixtures import check_fixtures, fixtures

    t0 = time.perf_counter()
    errors = check_fixtures(device)
    for e in errors:
        print(f"FAIL  {e}")
    print(f"self-check: {len(fixtures())} mutation fixture(s) + clean twins "
          f"on {device}, {len(errors)} error(s) "
          f"[{time.perf_counter() - t0:.1f}s]")
    return not errors


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--audit", action="store_true",
                   help="run the R1-R4 trace audit over registered programs")
    p.add_argument("--self-check", action="store_true",
                   help="run the mutation-fixture self-test")
    p.add_argument("--no-ast", action="store_true",
                   help="skip the AST lint layer")
    p.add_argument("--all", action="store_true", help="run every layer")
    p.add_argument("--device", default="cuda",
                   help="where the audited programs run: cuda (default) "
                        "or cpu")
    args = p.parse_args(argv)

    ok = True
    if not args.no_ast or args.all:
        ok &= run_ast_lint()
    if args.audit or args.self_check or args.all:
        from repro_torch.device import resolve_device
        device = resolve_device(args.device)
        if args.audit or args.all:
            ok &= run_audit(device)
        if args.self_check or args.all:
            ok &= run_self_check(device)
    print("determinism gate:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
