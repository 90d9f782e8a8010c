"""Shard placement for the sharded streaming tuner: who serves a ticket.

The sharded service (``ServiceConfig.num_shards > 1``) keeps one resident
segment engine per shard — its own slot carry, device queue, tables and
metrics, on its own device — and the broker routes each admitted ticket to
exactly one shard (engine-per-device, one host broker).  This module is
the host-side half of that routing:

* :func:`choose_shard` — the placement policies.  ``least_backlog`` picks
  the shard with the fewest unfinished tickets (backlog + in-flight),
  lowest shard id breaking ties; ``round_robin`` rotates.  Both are pure
  functions of host-side integers — placement can never consult device
  state, so it can never perturb a selection.
* **Sticky affinity** — a ticket that has ever been placed keeps its
  ``ticket.shard`` for life: cancel, preempt and resume are single-shard
  operations (the banked carry rows a preempted run resumes from live in
  its home engine's bookkeeping, and the flight-record validator rejects
  any cross-shard ticket stream — ``repro_torch.obs.validate_lifecycle``).
* :func:`shard_devices` — the device mapping: shard ``d`` runs on
  ``cuda:{d % torch.cuda.device_count()}`` (modulo, so ``num_shards`` may
  exceed the card count — shards then share cards), and a CPU service maps
  every shard to ``cpu``.  Each shard's tensors are whole copies on its
  device: placement, never partitioning, so a shard runs exactly the
  single-device segment program.

Determinism contract: placement decides only *where* (and therefore when)
a run executes.  Per-run PRNG keys, bootstrap replay and float32 billing
are placement-independent, so every Outcome — ``spend_trajectory``
included — is byte-identical to the sequential oracle regardless of
``num_shards`` or which shard served it
(``tests/test_torch_service_sharded.py`` pins it).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PLACEMENT_POLICIES", "choose_shard", "shard_devices",
           "shard_segment"]

PLACEMENT_POLICIES = ("least_backlog", "round_robin")


def choose_shard(policy: str, loads, home: int | None = None,
                 rr: int = 0) -> int:
    """Pick the shard for one ticket.

    ``loads`` is the per-shard unfinished-work vector (backlog depth +
    in-flight seats) at decision time; ``home`` is the ticket's existing
    shard, if any — sticky affinity short-circuits every policy, so a
    preempted/resumed ticket never migrates.  ``rr`` is the broker's
    monotone round-robin cursor.  Deterministic: equal loads resolve to
    the lowest shard id.
    """
    n = len(loads)
    if n < 1:
        raise ValueError("need at least one shard")
    if home is not None:
        if not 0 <= home < n:
            raise ValueError(f"home shard {home} out of range [0, {n})")
        return home
    if n == 1:                       # degenerate: everything on shard 0
        return 0
    if policy == "least_backlog":
        return int(np.argmin(np.asarray(loads)))   # ties -> lowest id
    if policy == "round_robin":
        return rr % n
    raise ValueError(f"unknown placement_policy {policy!r} "
                     f"(known: {PLACEMENT_POLICIES})")


def shard_devices(num_shards: int, device) -> list[torch.device]:
    """The device of each shard of a service on ``device``: shard ``d`` on
    ``cuda:{d % torch.cuda.device_count()}`` (modulo: shards beyond the
    card count share cards rather than fail — placement degrades, programs
    don't change); a CPU service puts every shard on ``cpu``."""
    if num_shards < 1:
        raise ValueError("need at least one shard")
    device = torch.device(device)
    if device.type == "cpu":
        return [torch.device("cpu")] * num_shards
    n = torch.cuda.device_count()
    if n < 1:
        raise RuntimeError("no CUDA device to place the shards on")
    return [torch.device("cuda", d % n) for d in range(num_shards)]


def shard_segment(carry, queue, qtail, evict, low_water, step_quota,
                  job_ids, cost, runtime, points, left, thresholds, valid,
                  u, t_max, s):
    """The per-shard segment entry point.

    Delegates to ``_episode_segment`` unchanged: a shard runs the *same*
    program as the single-engine service on tensors placed on its own
    device — placement is the only difference, and placement is not part
    of the program.  The registry pins that: ``episode/segment/sharded``
    in ``repro_torch.analysis.registry`` audits the segment's step program
    on a shard's device, so the sharded path can never grow shard-local
    math the auditor has not seen.
    """
    from repro_torch.core.optimizer import _episode_segment
    return _episode_segment(carry, queue, qtail, evict, low_water,
                            step_quota, job_ids, cost, runtime, points,
                            left, thresholds, valid, u, t_max, s)
