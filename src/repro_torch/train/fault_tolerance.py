"""Fault tolerance for long runs.

* `PreemptionGuard`: SIGTERM (or the signals given) sets a flag that the
  train loop reads once a step, to take an emergency checkpoint and stop.
* `StragglerMonitor`: an EWMA of step times that flags steps beyond
  ``threshold`` times the running mean.
* `retry_step`: bounded retries with backoff for transient failures. An
  error from the CUDA runtime or a kernel launch is never retried: after
  a device fault the context is unusable, and a retry would hide it.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, List, Optional

import torch

__all__ = ["PreemptionGuard", "StragglerMonitor", "retry_step",
           "is_device_fault"]


class PreemptionGuard:
    """Installs signal handlers; `should_stop` flips on SIGTERM/SIGINT."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = signals
        self._prev = {}
        self.should_stop = False

    def _handler(self, signum, frame):
        self.should_stop = True

    def __enter__(self):
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handler)
        return self

    def __exit__(self, *exc):
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        return False


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time monitor; flagged steps are counted and logged."""
    alpha: float = 0.1
    threshold: float = 2.0
    warmup: int = 3

    _mean: float = 0.0
    _count: int = 0
    straggler_steps: int = dataclasses.field(default=0)
    last_flagged: Optional[int] = None
    history: List[float] = dataclasses.field(default_factory=list)

    def update(self, step: int, dt: float) -> bool:
        """Record one step time; returns True if flagged as a straggler."""
        self.history.append(dt)
        self._count += 1
        if self._count <= self.warmup:
            self._mean = dt if self._count == 1 else (
                self._mean + (dt - self._mean) / self._count)
            return False
        flagged = dt > self.threshold * self._mean
        if flagged:
            self.straggler_steps += 1
            self.last_flagged = step
        else:   # stragglers do not poison the running mean
            self._mean = (1 - self.alpha) * self._mean + self.alpha * dt
        return flagged

    @property
    def mean_step_time(self) -> float:
        return self._mean


# messages of errors raised by the CUDA runtime, cuBLAS / cuDNN, or the
# port's kernel wrappers ("<kernel> launch failed: cudaError n")
_DEVICE_FAULT_MARKS = ("CUDA error", "cudaError", "CUBLAS_STATUS",
                       "CUDNN_STATUS", "device-side assert")


def is_device_fault(exc: BaseException) -> bool:
    """Whether ``exc`` comes from the CUDA runtime or a kernel launch."""
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    msg = str(exc)
    return any(mark in msg for mark in _DEVICE_FAULT_MARKS)


def retry_step(fn: Callable[[], Any], retries: int = 2,
               backoff_s: float = 0.5,
               retriable=(RuntimeError,)) -> Any:
    """Run ``fn``, retrying transient failures (``retriable``) up to
    ``retries`` times with exponential backoff. ``fn`` must not modify
    its inputs, so a retry starts from the same state. Device faults
    (`is_device_fault`) are re-raised at once."""
    for attempt in range(retries + 1):
        try:
            return fn()
        except retriable as e:
            if attempt == retries or is_device_fault(e):
                raise
            time.sleep(backoff_s * (2 ** attempt))
