"""Exporters + validators: Prometheus text, JSONL traces, lifecycle checks.

The port's copy of ``repro.obs.export``, unchanged but for its imports:
the trace schema is the reference's, so a port trace reads in
``scripts/obs_report.py`` and the validators give the reference's output
on the same events (``tests/test_torch_obs.py`` holds them equal).

* :func:`metrics_to_prometheus` renders a :class:`~repro_torch.service.
  ServiceMetrics` snapshot in the Prometheus text exposition format (one
  ``# TYPE`` line per series; monotone counters vs point-in-time gauges).
* :func:`write_trace_jsonl` / :func:`read_trace_jsonl` freeze and reload a
  flight record as JSON Lines.
* :func:`validate_trace` (schema: required keys, known kinds, dense
  monotone ``seq``, nondecreasing ``t``) and :func:`validate_lifecycle`
  (the per-ticket state machine: no seat without admit, no resolve after
  cancel, no event after a terminal) turn a trace into a checkable
  contract instead of a log to eyeball.
"""

from __future__ import annotations

import json
import pathlib
from typing import Iterable

from repro_torch.obs.recorder import EVENT_KINDS, Event

__all__ = ["COUNTER_FIELDS", "metrics_to_prometheus", "read_trace_jsonl",
           "validate_lifecycle", "validate_trace", "write_trace_jsonl"]

# ServiceMetrics fields that are monotone counters within a metrics window
# (everything else in the snapshot is a gauge: ratios, depths, latencies).
COUNTER_FIELDS = frozenset({
    "segments", "steps", "busy_slot_steps", "submitted", "resolved",
    "cancelled", "preempted", "resumed", "slo_missed", "deadline_rejected",
    "explorations",
})


def metrics_to_prometheus(metrics, prefix: str = "lynceus_service") -> str:
    """Render a ``ServiceMetrics`` snapshot as Prometheus text format.

    Every dataclass field becomes one series ``<prefix>_<field>`` with a
    ``# TYPE`` annotation (counter or gauge).  Works on anything with a
    ``to_dict()`` (or dataclass fields) whose values are numbers.
    """
    d = metrics.to_dict() if hasattr(metrics, "to_dict") else dict(metrics)
    lines = []
    for name, value in d.items():
        kind = "counter" if name in COUNTER_FIELDS else "gauge"
        series = f"{prefix}_{name}"
        lines.append(f"# TYPE {series} {kind}")
        lines.append(f"{series} {float(value):g}")
    return "\n".join(lines) + "\n"


# --------------------------------------------------------------------------- #
# JSONL traces
# --------------------------------------------------------------------------- #
def write_trace_jsonl(events: Iterable[Event], path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with path.open("w") as f:
        for e in events:
            f.write(json.dumps(e.to_json()) + "\n")
    return path


def read_trace_jsonl(path) -> list[Event]:
    events = []
    for line in pathlib.Path(path).read_text().splitlines():
        if line.strip():
            events.append(Event.from_json(json.loads(line)))
    return events


# --------------------------------------------------------------------------- #
# Validators
# --------------------------------------------------------------------------- #
def validate_trace(events: list[Event]) -> list[str]:
    """Schema check; returns human-readable issues (empty list = valid).

    Pins: known ``kind``; strictly increasing ``seq`` with nondecreasing
    ``t`` (both assigned under the recorder lock); ``span`` events carry a
    known phase and a nonnegative duration; ``dispatch`` events carry a
    segment id and step counts.
    """
    from repro_torch.obs.spans import PHASES
    issues = []
    prev_seq, prev_t = 0, float("-inf")
    for e in events:
        where = f"event seq={e.seq}"
        if e.kind not in EVENT_KINDS:
            issues.append(f"{where}: unknown kind {e.kind!r}")
        if e.seq <= prev_seq:
            issues.append(f"{where}: seq not increasing "
                          f"(prev {prev_seq})")
        if e.t < prev_t:
            issues.append(f"{where}: timestamp went backwards")
        prev_seq, prev_t = e.seq, e.t
        if e.kind == "span":
            if e.data.get("phase") not in PHASES:
                issues.append(f"{where}: span with unknown phase "
                              f"{e.data.get('phase')!r}")
            if not (isinstance(e.data.get("dur_s"), (int, float))
                    and e.data["dur_s"] >= 0):
                issues.append(f"{where}: span without nonnegative dur_s")
        if e.kind == "dispatch":
            if e.segment is None:
                issues.append(f"{where}: dispatch without a segment id")
            if not isinstance(e.data.get("steps"), int):
                issues.append(f"{where}: dispatch without integer steps")
        if e.kind in ("submit", "admit", "stage", "inject", "seat",
                      "restage", "evict", "preempt", "resume",
                      "cancel_request", "cancel", "harvest", "resolve",
                      "fail") and e.ticket is None:
            issues.append(f"{where}: {e.kind} without a ticket id")
        shard = e.data.get("shard")
        if shard is not None and not (isinstance(shard, int)
                                      and not isinstance(shard, bool)
                                      and shard >= 0):
            issues.append(f"{where}: shard must be a nonnegative int, "
                          f"got {shard!r}")
    return issues


# Per-ticket state machine: event kind -> states it may fire from.  States
# advance as _STATE_AFTER says; "cancel_request" is an orthogonal flag
# (any non-terminal state), "cancel"/"resolve"/"fail" are terminal.  This
# is the reference's state machine, which the broker and engine emit.
_ALLOWED_FROM = {
    "submit": {"new"},
    "admit": {"submitted"},
    "stage": {"admitted"},
    "inject": {"staged"},
    "seat": {"staged", "injected"},
    "restage": {"injected"},
    "evict": {"seated"},
    "preempt": {"evicted"},
    "resume": {"seated"},
    "harvest": {"seated"},
    "resolve": {"harvested"},
}
_STATE_AFTER = {
    "submit": "submitted", "admit": "admitted", "stage": "staged",
    "inject": "injected", "seat": "seated", "restage": "admitted",
    "evict": "evicted", "preempt": "admitted", "resume": "seated",
    "harvest": "harvested", "resolve": "terminal", "cancel": "terminal",
    "fail": "terminal",
}


def validate_lifecycle(events: list[Event],
                       require_terminal: bool = False) -> list[str]:
    """Check every ticket's event stream against the lifecycle state
    machine; returns violations (empty list = valid).

    Enforced per ticket: events start with ``submit``; ``seat`` requires a
    prior ``admit`` (via stage/inject); ``resume`` requires a prior
    ``preempt``; ``cancel`` requires a prior ``cancel_request``;
    ``resolve`` requires a prior ``harvest``; nothing follows a terminal
    event (so in particular no ``resolve`` after ``cancel``).  With
    ``require_terminal=True`` (a drained service) every ticket must have
    reached exactly one terminal event.

    Sharded traces (events tagged ``shard=...``) additionally pin sticky
    placement: every shard-tagged event of one ticket must name the same
    shard — a ticket observed on two shards is cross-shard leakage, which
    the broker's sticky affinity forbids (cancel/preempt/resume all stay
    on the home shard).
    """
    issues: list[str] = []
    state: dict[int, str] = {}
    preempted: set[int] = set()
    cancel_requested: set[int] = set()
    shard_of: dict[int, int] = {}
    for e in events:
        if e.ticket is None or e.kind in ("dispatch", "span",
                                          "deadline_reject"):
            continue
        tid, kind = e.ticket, e.kind
        cur = state.get(tid, "new")
        where = f"ticket {tid} seq={e.seq}"
        sh = e.data.get("shard")
        if sh is not None:
            home = shard_of.setdefault(tid, sh)
            if sh != home:
                issues.append(f"{where}: {kind!r} on shard {sh} but the "
                              f"ticket's home shard is {home} (sticky "
                              "placement forbids cross-shard leakage)")
        if cur == "terminal":
            issues.append(f"{where}: {kind!r} after a terminal event")
            continue
        if kind == "cancel_request":
            cancel_requested.add(tid)
            continue
        if kind in ("cancel", "fail"):
            if kind == "cancel" and tid not in cancel_requested:
                issues.append(f"{where}: cancel without a prior "
                              "cancel_request")
            state[tid] = "terminal"
            continue
        allowed = _ALLOWED_FROM.get(kind)
        if allowed is None:
            issues.append(f"{where}: unknown lifecycle kind {kind!r}")
            continue
        if cur not in allowed:
            issues.append(f"{where}: {kind!r} from state {cur!r} "
                          f"(allowed from {sorted(allowed)})")
        if kind == "resume" and tid not in preempted:
            issues.append(f"{where}: resume without a prior preempt")
        if kind == "preempt":
            preempted.add(tid)
        state[tid] = _STATE_AFTER[kind]
    if require_terminal:
        for tid, st in sorted(state.items()):
            if st != "terminal":
                issues.append(f"ticket {tid}: never reached a terminal "
                              f"event (left in state {st!r})")
    return issues
