"""Divergence forensics, the pinned part: which Outcome fields the
determinism contract compares, and a readable diff of two Outcome lists.

``PINNED_OUTCOME_FIELDS`` is every ``Outcome`` field except the wall-clock
``select_seconds``.  The port's parity gates (CPU tests against the JAX
package, and ``chip_smoke.py`` on the card) compare exactly these.
"""

from __future__ import annotations

from typing import Iterable, Sequence

__all__ = ["PINNED_OUTCOME_FIELDS", "diff_outcomes", "outcome_to_dict"]

PINNED_OUTCOME_FIELDS = ("explored", "recommended", "cno", "nex", "spent",
                         "budget", "found_optimum", "trajectory",
                         "spend_trajectory", "censored")


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
