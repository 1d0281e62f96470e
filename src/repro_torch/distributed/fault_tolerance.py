"""Fault tolerance and straggler mitigation for the training driver (the
reference's `repro.distributed.fault_tolerance`, host-side Python only).

On a real multi-pod deployment each component maps to the corresponding
fleet mechanism (health service, preemption notices, rescheduler); here the
mechanisms are implemented host-side and exercised by tests and
the port's `launch/train.py --simulate-failure`:

  * `StepWatchdog`    -- wall-clock budget per step; a step exceeding
                         `timeout_factor` x the trailing median is flagged
                         as a straggler (counter + callback hook, e.g. to
                         trigger re-dispatch or checkpoint-now).
  * `run_resilient`   -- step-loop wrapper: on exception it restores the
                         latest checkpoint and replays (the deterministic
                         data pipeline replays the same batches).
  * `FailureInjector` -- deterministic fault injection for tests/demos.
"""
from __future__ import annotations

import logging
import statistics
import time
from dataclasses import dataclass, field
from typing import Callable

log = logging.getLogger("repro_torch.ft")


@dataclass
class StepWatchdog:
    timeout_factor: float = 3.0
    min_history: int = 5
    on_straggler: Callable[[int, float, float], None] | None = None
    history: list[float] = field(default_factory=list)
    stragglers: int = 0

    def observe(self, step: int, duration: float) -> bool:
        """Record a step duration; returns True when flagged."""
        flagged = False
        if len(self.history) >= self.min_history:
            med = statistics.median(self.history[-50:])
            if duration > self.timeout_factor * med:
                self.stragglers += 1
                flagged = True
                log.warning("straggler step %d: %.3fs vs median %.3fs",
                            step, duration, med)
                if self.on_straggler:
                    self.on_straggler(step, duration, med)
        self.history.append(duration)
        return flagged


@dataclass
class FailureInjector:
    """Raises RuntimeError at the given step indices (once each)."""
    fail_at: tuple[int, ...] = ()
    fired: set = field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected failure at step {step}")

    @classmethod
    def from_trace(cls, trace: list[dict]) -> "FailureInjector":
        """Build from a shared-format fault trace
        (`repro_torch.fleet.faults.FaultInjector.trace` /
        `step_failure_trace`): only `step_failure` entries are
        training-loop faults; fabric entries (link/port/plane) belong to
        the fleet layer (`repro_torch.fleet.fault_events_from_trace`) and are
        skipped here, so one seeded trace drives both failure models."""
        steps = sorted({int(ev["step"]) for ev in trace
                        if ev.get("kind") == "step_failure"})
        return cls(fail_at=tuple(steps))

    def to_trace(self) -> list[dict]:
        """Export as shared-format `step_failure` entries."""
        from repro_torch.fleet.faults import step_failure_trace
        return step_failure_trace(self.fail_at)


def run_resilient(num_steps: int,
                  do_step: Callable[[int], dict],
                  save_ckpt: Callable[[int], None],
                  restore_ckpt: Callable[[], int],
                  ckpt_every: int = 50,
                  max_restarts: int = 3,
                  watchdog: StepWatchdog | None = None) -> dict:
    """Checkpointed, restartable step loop.

    do_step(step) -> metrics dict; save_ckpt(step) persists state;
    restore_ckpt() reloads the latest checkpoint and returns its step.
    Deterministic data (`repro_torch.training.data`) replays the same
    batches after a restore.
    """
    restarts = 0
    step = 0
    metrics: dict = {}
    while step < num_steps:
        try:
            t0 = time.time()
            metrics = do_step(step)
            if watchdog is not None:
                watchdog.observe(step, time.time() - t0)
            step += 1
            if step % ckpt_every == 0 or step == num_steps:
                save_ckpt(step)
        except Exception as exc:   # noqa: BLE001 - any failure is fatal-ish
            restarts += 1
            if restarts > max_restarts:
                raise
            log.warning("step %d failed (%s); restoring checkpoint "
                        "(restart %d/%d)", step, exc, restarts, max_restarts)
            step = restore_ckpt()
    return {"metrics": metrics, "restarts": restarts,
            "stragglers": watchdog.stragglers if watchdog else 0,
            "steps": step}
