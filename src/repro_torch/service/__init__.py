"""Streaming tuning service: live RunRequests into a resident episode.

The port of ``repro.service``.  The one-shot batched entry points
(``repro_torch.core.run_queue_batched``) snapshot their queue before the
episode starts.  This package turns the same lane-compacting episode into
a long-lived endpoint: the episode runs as bounded *segments*
(``_episode_segment`` in ``core/optimizer.py``), and between segments a
host-side broker injects newly submitted runs into the device-resident
pending queue and harvests finished outcomes — so tuning traffic streams
in and out while the device keeps working.

Layout:

* ``config``    — :class:`ServiceConfig`: seats, device queue capacity,
  low-water mark, step quota, admission backpressure, shards
* ``engine``    — :class:`SegmentEngine`: the resident device state and the
  seat/inject/dispatch/harvest cycle around each segment;
  :class:`ShardedEngine`, one engine per shard
* ``placement`` — which shard serves a ticket, and on which device
* ``broker``    — :class:`StreamingTuner`: admission buffer (double-
  buffered, priority-ordered), ``submit() -> TuningTicket`` futures,
  ``drain()``, optional background pump thread
* ``metrics``   — :class:`ServiceMetrics`: throughput, lane occupancy,
  queue depth, per-request latency

``StreamingTuner(jobs, settings, config, device="cuda")`` runs on the card
unless the caller asks for the CPU.  Observability rides along behind
``ServiceConfig.trace`` (``repro_torch.obs``): the recorder watches the
service, it never joins the decision path.

Determinism contract: streamed outcomes are bit-identical to the
sequential oracle — arrival order, priorities, segment pacing, shard
count, cancellations of *other* runs, and even preemption+resume of the
run itself decide *when* it executes, never *what* it computes
(``tests/test_torch_service*.py`` hold it against the JAX package).
"""

from repro_torch.service.broker import (DeadlineUnmeetable, QueueFull,
                                        StreamingTuner, TicketCancelled,
                                        TuningTicket)
from repro_torch.service.config import ServiceConfig
from repro_torch.service.engine import SegmentEngine, SegmentReport
from repro_torch.service.metrics import MetricsRecorder, ServiceMetrics

__all__ = ["DeadlineUnmeetable", "QueueFull", "ServiceConfig",
           "ServiceMetrics", "SegmentEngine", "SegmentReport",
           "MetricsRecorder", "StreamingTuner", "TicketCancelled",
           "TuningTicket"]
