"""Fault-tolerant training loop — ``repro.runtime.fault_tolerance``:
checkpoint/restart, preemption, a straggler watchdog.

``run_training`` wraps a step function with:

* auto-resume from the latest checkpoint (the data stream is
  deterministic in (seed, step), so a resumed run sees the batches the
  failed one would have);
* periodic and preemption-triggered checkpoints (SIGTERM/SIGINT);
* failure injection (``fail_at_step``), which the tests use to show that
  a kill -> restart cycle continues bit for bit;
* a straggler watchdog: an EMA of step time; steps slower than
  ``straggler_factor`` x EMA are logged and counted.

A step's time ends at ``torch.cuda.synchronize`` on the card (the
reference's ``block_until_ready``).  The summary also carries every
step's seconds (``step_times``).  A sharded run passes its
``state_shardings``: the resumed state is placed on them, whatever mesh
wrote the checkpoint.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable

import torch

from repro_torch.checkpoint.manager import CheckpointManager

__all__ = ["RunConfig", "run_training", "StragglerWatchdog"]


@dataclasses.dataclass
class RunConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    log_every: int = 10
    straggler_factor: float = 3.0
    fail_at_step: int | None = None       # failure injection (tests)


class StragglerWatchdog:
    def __init__(self, factor: float = 3.0, alpha: float = 0.1):
        self.factor, self.alpha = factor, alpha
        self.ema: float | None = None
        self.stragglers: list[tuple[int, float]] = []

    def observe(self, step: int, dt: float) -> bool:
        if self.ema is None:
            self.ema = dt
            return False
        slow = dt > self.factor * self.ema
        if slow:
            self.stragglers.append((step, dt))
        self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return slow


class _PreemptionGuard:
    def __init__(self):
        self.requested = False
        self._old = {}

    def __enter__(self):
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._old[sig] = signal.signal(sig, self._handler)
            except ValueError:            # non-main thread (tests)
                pass
        return self

    def _handler(self, signum, frame):
        self.requested = True

    def __exit__(self, *exc):
        for sig, old in self._old.items():
            signal.signal(sig, old)


def _block(metrics) -> None:
    """Wait for the step's device work: its first metric's device."""
    first = next(iter(metrics.values()), None)
    if isinstance(first, torch.Tensor) and first.is_cuda:
        torch.cuda.synchronize(first.device)


def run_training(step_fn: Callable, state, data_source: Callable,
                 ckpt: CheckpointManager, run_cfg: RunConfig,
                 state_shardings=None, device=None,
                 log: Callable = print) -> dict:
    """Drive training with checkpoint/restart.  Returns the run summary.

    step_fn(state, batch) -> (state, metrics); data_source(step) -> batch.
    A restored checkpoint goes onto ``state_shardings`` (a tree of
    ``shard.NamedSharding`` matching ``state``) if given, else onto
    ``device`` (by default each leaf onto its leaf's device in
    ``state``).
    """
    start = 0
    restored = ckpt.restore_latest(state, state_shardings, device=device)
    if restored[0] is not None:
        start, state = restored
        log(f"[resume] restored checkpoint at step {start}")
    watchdog = StragglerWatchdog(run_cfg.straggler_factor)
    history, step_times = [], []
    with _PreemptionGuard() as guard:
        step = start
        while step < run_cfg.total_steps:
            t0 = time.perf_counter()
            batch = data_source(step)
            if run_cfg.fail_at_step is not None and step == run_cfg.fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            state, metrics = step_fn(state, batch)
            _block(metrics)
            dt = time.perf_counter() - t0
            step_times.append(dt)
            step += 1
            slow = watchdog.observe(step, dt)
            if slow:
                log(f"[straggler] step {step} took {dt:.3f}s "
                    f"(ema {watchdog.ema:.3f}s)")
            if step % run_cfg.log_every == 0:
                loss = float(metrics.get("loss", float("nan")))
                history.append((step, loss, dt))
                log(f"step {step:6d} loss {loss:.4f} {dt*1e3:.0f}ms")
            if step % run_cfg.checkpoint_every == 0 or guard.requested:
                ckpt.save(step, state)
                if guard.requested:
                    ckpt.wait()
                    log(f"[preempt] checkpointed at {step}; exiting")
                    return {"state": state, "step": step, "history": history,
                            "preempted": True,
                            "stragglers": watchdog.stragglers,
                            "step_times": step_times}
    ckpt.save(run_cfg.total_steps, state)
    ckpt.wait()
    return {"state": state, "step": run_cfg.total_steps, "history": history,
            "preempted": False, "stragglers": watchdog.stragglers,
            "step_times": step_times}
