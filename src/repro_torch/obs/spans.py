"""Per-phase timing spans around the segment loop, with compile attribution.

:func:`phase_span` wraps one phase of the seat -> inject -> dispatch ->
device_block -> harvest cycle (``service/engine.py``) and emits a ``span``
event carrying the phase name and wall duration.  With ``compiles=True``
the span also records how many episode/selector program geometries were
first run inside it — read off ``episode_cache_size()`` /
``selector_cache_size()``, the port's counterparts of the reference's jit
cache sizes — so a slow dispatch that met a new geometry tells itself
apart from one that did not.

With ``profiler=True`` the phase additionally runs under a
``torch.profiler.record_function`` scope (``ServiceConfig.
trace_profiler``), so the phases show up by name in a captured
``torch.profiler`` trace.  The scope is host-side naming only: like
everything in ``repro_torch.obs`` it cannot perturb a selection.

What the phases time in the port: ``dispatch`` is the call of
``_episode_segment``, a host loop of device steps that reads its loop
condition once a step, so nearly all of a segment's device time falls
inside it; ``device_block`` is the wait for the engine's device to finish
what the last step enqueued (``torch.cuda.synchronize``; nothing on the
CPU).
"""

from __future__ import annotations

import contextlib
import time

__all__ = ["PHASES", "phase_span"]

# The segment-cycle phase vocabulary, in execution order (the reference's
# span diagram).
PHASES = ("seat", "inject", "dispatch", "device_block", "harvest")


def _cache_sizes() -> tuple[int, int]:
    # Lazy import: obs must stay importable without pulling the whole core
    # (and core never imports obs, so there is no cycle either way).
    from repro_torch.core import episode_cache_size, selector_cache_size
    return episode_cache_size(), selector_cache_size()


def _profiler_scope(name: str):
    import torch
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def phase_span(recorder, phase: str, *, segment: int | None = None,
               profiler: bool = False, compiles: bool = False,
               shard: int | None = None):
    """Time one phase into ``recorder`` (no-op when it is absent/disabled).

    Emits ``span`` with ``phase`` and ``dur_s``; with ``compiles=True``
    also ``episode_compiles``/``selector_compiles`` deltas across the
    phase; with ``shard`` set, the emitting engine's shard id (the sharded
    service runs one segment cycle per shard, so spans must say whose
    phase they time).  The span is emitted even when the body raises (a
    crashed dispatch still shows up in the record — that is the point).
    """
    if phase not in PHASES:
        raise ValueError(f"unknown phase {phase!r} (known: {PHASES})")
    enabled = recorder is not None and getattr(recorder, "enabled", False)
    scope = _profiler_scope(f"lynceus/{phase}") if profiler \
        else contextlib.nullcontext()
    if not enabled:
        with scope:
            yield
        return
    e0, s0 = _cache_sizes() if compiles else (0, 0)
    t0 = time.perf_counter()
    try:
        with scope:
            yield
    finally:
        data = {"phase": phase, "dur_s": time.perf_counter() - t0}
        if shard is not None:
            data["shard"] = shard
        if compiles:
            e1, s1 = _cache_sizes()
            data["episode_compiles"] = e1 - e0
            data["selector_compiles"] = s1 - s0
        recorder.emit("span", segment=segment, **data)
