"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (the reference's
``SynchronizedWallClockTimer``, ``ThroughputTimer`` and ``NoopTimer``).
A timer synchronizes the device where the JAX package blocks on a result:
given a ``sync_val`` on a CUDA device, ``start``/``stop`` call
``torch.cuda.synchronize()`` first, so the interval covers the device work
queued before it, not only its launch. CPU values need no synchronization.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

from .logging import log_dist

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"
TRAIN_BATCH_TIMER = "train_batch"


def _sync(sync_val: Any | None = None) -> None:
    if isinstance(sync_val, torch.Tensor) and sync_val.is_cuda:
        torch.cuda.synchronize(sync_val.device)


class _Timer:
    def __init__(self, name: str):
        self.name_ = name
        self.started_ = False
        self.start_time = 0.0
        self.elapsed_ = 0.0
        self.count = 0

    def start(self, sync_val: Any | None = None) -> None:
        _sync(sync_val)
        self.start_time = time.perf_counter()
        self.started_ = True

    def stop(self, sync_val: Any | None = None, record: bool = True) -> None:
        if not self.started_:
            return
        _sync(sync_val)
        if record:
            self.elapsed_ += time.perf_counter() - self.start_time
            self.count += 1
        self.started_ = False

    def elapsed(self, reset: bool = True) -> float:
        """Return accumulated seconds; optionally reset."""
        value = self.elapsed_
        if self.started_:
            value += time.perf_counter() - self.start_time
        if reset:
            self.elapsed_ = 0.0
            self.count = 0
        return value

    def mean(self) -> float:
        return self.elapsed_ / self.count if self.count else 0.0

    def reset(self) -> None:
        self.started_ = False
        self.elapsed_ = 0.0
        self.count = 0


class SynchronizedWallClockTimer:
    """Named-timer registry (reference ``utils/timer.py:44``)."""

    def __init__(self):
        self.timers: dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def has(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        if not torch.cuda.is_available():
            return "device mem stats unavailable"
        in_use = torch.cuda.memory_allocated() / (1024**3)
        peak = torch.cuda.max_memory_allocated() / (1024**3)
        return f"device mem in use {in_use:.2f} GB | peak {peak:.2f} GB"

    def log(self, names: list[str], normalizer: float = 1.0, reset: bool = True,
            memory_breakdown: bool = False, ranks: list[int] | None = None) -> None:
        assert normalizer > 0.0
        parts = []
        for name in names:
            if name in self.timers:
                elapsed = self.timers[name].elapsed(reset=reset) * 1000.0 / normalizer
                parts.append(f"{name}: {elapsed:.2f}")
        msg = "time (ms) | " + " | ".join(parts)
        if memory_breakdown:
            msg += " | " + self.memory_usage()
        log_dist(msg, ranks=ranks)

    def get_timers_ms(self, names: list[str], reset: bool = False) -> dict[str, float]:
        return {n: self.timers[n].elapsed(reset=reset) * 1000.0 for n in names if n in self.timers}


class NoopTimer:
    class _N:
        def start(self, *a, **k):
            pass

        def stop(self, *a, **k):
            pass

        def reset(self):
            pass

        def elapsed(self, *a, **k):
            return 0.0

    def __call__(self, name):
        return self._N()

    def has(self, name):
        return False

    def log(self, *a, **k):
        pass


class ThroughputTimer:
    """Samples/sec + TFLOPs estimator (reference ``utils/timer.py:199``)."""

    def __init__(self, batch_size: int, start_step: int = 2, steps_per_output: int = 50,
                 monitor_memory: bool = False, logging_fn: Callable | None = None):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.monitor_memory = monitor_memory
        self.logging = logging_fn or (lambda msg: log_dist(msg))
        self.initialized = False
        self.global_step_count = 0
        self.local_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self.start_time = 0.0
        self.started = False
        self.last_step_s: float | None = None

    def update_epoch_count(self) -> None:
        self.local_step_count = 0

    def start(self) -> None:
        self.started = True
        self.start_time = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True,
             sync_val: Any | None = None, flops_per_sample: float | None = None) -> None:
        if not self.started:
            return
        self.started = False
        if global_step:
            self.global_step_count += 1
            self.local_step_count += 1
        if self.start_time:
            _sync(sync_val)
            duration = time.perf_counter() - self.start_time
            self.last_step_s = duration
            if self.global_step_count <= self.start_step:
                return  # warmup steps don't count toward averages
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            if global_step and report_speed and self.global_step_count % self.steps_per_output == 0:
                rate = self.avg_samples_per_sec()
                msg = (f"step={self.global_step_count}, samples/sec (avg)={rate:.2f}, "
                       f"batch_size={self.batch_size}")
                if flops_per_sample:
                    msg += f", TFLOPs={rate * flops_per_sample / 1e12:.2f}"
                self.logging(msg)
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and self.total_elapsed_time > 0:
            steps = self.global_step_count - self.start_step
            return self.batch_size / (self.total_elapsed_time / steps)
        return 0.0
