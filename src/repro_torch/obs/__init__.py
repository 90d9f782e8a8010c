"""Flight-recorder observability for the port's streaming tuner.

The counterpart of ``repro.obs``, a copy rather than an import (the port
imports nothing of the JAX package):

* ``recorder``  — :class:`FlightRecorder`: bounded thread-safe structured
  event log (ring buffer -> JSONL) of every lifecycle transition and
  segment dispatch, emitted by ``service/broker.py`` + ``service/
  engine.py`` behind ``ServiceConfig.trace``
* ``spans``     — :func:`phase_span`: per-phase timing around the segment
  loop (seat/inject/dispatch/device_block/harvest) with attribution of new
  program geometries via ``episode_cache_size()``/``selector_cache_size()``
  and optional ``torch.profiler`` scopes (``ServiceConfig.trace_profiler``)
* ``export``    — Prometheus text renderer, JSONL trace writer/reader, and
  the trace validators (schema + per-ticket lifecycle state machine)
* ``forensics`` — the pinned Outcome fields and their diffs, and
  :func:`dump_divergence`: one JSON artifact per parity failure (field
  diffs + flight record + canonical program signatures from
  ``repro_torch.analysis``)

Zero-perturbation rule: this layer watches the determinism contract, it
never joins it.  A trace-on service replays the trace-off service bit for
bit (``tests/test_torch_obs.py``).
"""

from repro_torch.obs.export import (COUNTER_FIELDS, metrics_to_prometheus,
                                    read_trace_jsonl, validate_lifecycle,
                                    validate_trace, write_trace_jsonl)
from repro_torch.obs.forensics import (PINNED_OUTCOME_FIELDS, diff_outcomes,
                                       dump_divergence, outcome_to_dict,
                                       registry_signatures)
from repro_torch.obs.recorder import (EVENT_KINDS, TERMINAL_KINDS, Event,
                                      FlightRecorder)
from repro_torch.obs.spans import PHASES, phase_span

__all__ = [
    "COUNTER_FIELDS", "EVENT_KINDS", "Event", "FlightRecorder", "PHASES",
    "PINNED_OUTCOME_FIELDS", "TERMINAL_KINDS", "diff_outcomes",
    "dump_divergence", "metrics_to_prometheus", "outcome_to_dict",
    "phase_span", "read_trace_jsonl", "registry_signatures",
    "validate_lifecycle", "validate_trace", "write_trace_jsonl",
]
