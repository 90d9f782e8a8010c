"""Divergence forensics: one artifact per parity failure, not a rerun.

``PINNED_OUTCOME_FIELDS`` is every ``Outcome`` field except the wall-clock
``select_seconds``.  The port's parity gates (CPU tests against the JAX
package, and ``chip_smoke.py`` on the card) compare exactly these.

When such a gate trips, :func:`dump_divergence` freezes the evidence into
a single JSON artifact at failure time:

* per-run field diffs over :data:`PINNED_OUTCOME_FIELDS` plus full
  expected/actual dumps,
* the flight record (events + full-history counts) when a recorder is
  passed,
* canonical program signatures from ``repro_torch.analysis`` (via
  :func:`registry_signatures`: the ordered aten operations each registered
  program runs), so triage can tell "different program" from "same
  program, different arithmetic" without rerunning.
"""

from __future__ import annotations

import json
import pathlib
import time
from typing import Iterable, Sequence

__all__ = ["PINNED_OUTCOME_FIELDS", "diff_outcomes", "dump_divergence",
           "outcome_to_dict", "registry_signatures"]

PINNED_OUTCOME_FIELDS = ("explored", "recommended", "cno", "nex", "spent",
                         "budget", "found_optimum", "trajectory",
                         "spend_trajectory", "censored")

_DEFAULT_OUT_DIR = "results/forensics"


def outcome_to_dict(o) -> dict:
    """JSON-safe dump of one Outcome's pinned fields (tuples -> lists)."""
    d = {}
    for f in PINNED_OUTCOME_FIELDS:
        v = getattr(o, f, None)
        d[f] = list(v) if isinstance(v, (tuple, set)) else v
    return d


def diff_outcomes(expected: Sequence, actual: Sequence,
                  fields: Iterable[str] = PINNED_OUTCOME_FIELDS
                  ) -> list[str]:
    """Human-readable per-run field mismatches (empty list = bit-equal)."""
    diffs = []
    if len(expected) != len(actual):
        diffs.append(f"length: expected {len(expected)} outcomes, "
                     f"got {len(actual)}")
    for i, (a, b) in enumerate(zip(expected, actual)):
        for f in fields:
            va, vb = getattr(a, f, None), getattr(b, f, None)
            if va != vb:
                diffs.append(f"run {i}: {f} differs "
                             f"(expected {va!r}, actual {vb!r})")
    return diffs


def registry_signatures(names: Iterable[str], device="cuda"
                        ) -> dict[str, str]:
    """Canonical ``repro_torch.analysis`` signatures of registered programs,
    each run on ``device`` (the card unless the caller asks for the CPU:
    the ``kernel/*/auto`` programs then record the kernels the card runs;
    ``cuda`` without a card raises, as every entry point of the port).

    ``names`` selects registry entries by exact name or name prefix (e.g.
    ``"episode/segment"`` matches the native, bucketed and sharded segment
    programs).  Unknown names are skipped; a program that fails to run maps
    to the error string instead — forensics must degrade, not raise.
    """
    from repro_torch.analysis import registered_programs, signature
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    out: dict[str, str] = {}
    wanted = tuple(names)
    for spec in registered_programs():
        if not any(spec.name == n or spec.name.startswith(n + "/")
                   for n in wanted):
            continue
        try:
            fn, example, _ = spec.build(dev)
            out[spec.name] = signature(fn, *example)
        except Exception as e:          # pragma: no cover - degraded path
            out[spec.name] = f"<signature failed: {type(e).__name__}: {e}>"
    return out


def dump_divergence(tag: str, *, expected: Sequence = (),
                    actual: Sequence = (), recorder=None,
                    signatures: dict[str, str] | Iterable[str] | None = None,
                    context: dict | None = None,
                    out_dir=_DEFAULT_OUT_DIR,
                    device="cuda") -> pathlib.Path:
    """Freeze one parity failure into ``<out_dir>/<tag>__NNN.json``.

    ``expected``/``actual`` are the diverging Outcome sequences (diffs are
    computed here); ``recorder`` contributes its event ring + counts;
    ``signatures`` is either a ready ``{name: signature}`` mapping or an
    iterable of registry names/prefixes to resolve via
    :func:`registry_signatures` on ``device`` (the device the diverging
    run used: the card unless the caller asks for the CPU).  Returns the
    artifact path (NNN increments so repeated failures under one tag never
    overwrite each other).
    """
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    artifact = {
        "tag": tag,
        "created_unix": time.time(),
        "context": context or {},
        "diffs": diff_outcomes(expected, actual),
        "expected": [outcome_to_dict(o) for o in expected],
        "actual": [outcome_to_dict(o) for o in actual],
    }
    if recorder is not None:
        artifact["flight_record"] = [e.to_json() for e in recorder.events()]
        artifact["event_counts"] = recorder.counts()
        artifact["events_dropped"] = recorder.dropped
    if signatures is not None:
        if not isinstance(signatures, dict):
            signatures = registry_signatures(signatures, device)
        artifact["program_signatures"] = dict(signatures)
    n = 0
    while (path := out_dir / f"{tag}__{n:03d}.json").exists():
        n += 1
    path.write_text(json.dumps(artifact, indent=1, default=str))
    return path
