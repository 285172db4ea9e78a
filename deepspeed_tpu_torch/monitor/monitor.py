"""Monitor ABC + fan-out master.

The port's copy of ``deepspeed_tpu/monitor/monitor.py`` (reference
deepspeed/monitor/monitor.py: ``Monitor`` ABC :13, ``MonitorMaster`` :30).
The contract is unchanged —
``write_events([(tag, value, step), ...])`` fanned out to every enabled
backend — because it is host-side bookkeeping with nothing device-specific.
Backends degrade gracefully when their package is missing (tensorboard /
wandb are optional in the image).
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Sequence

Event = tuple  # (tag: str, value: float, step: int)


class Monitor(ABC):
    def __init__(self, config):
        self.enabled = bool(getattr(config, "enabled", False))

    @abstractmethod
    def write_events(self, event_list: Sequence[Event]) -> None:
        ...

    def flush(self) -> None:  # optional
        pass


class MonitorMaster(Monitor):
    """Fan-out to tensorboard/wandb/csv backends per config (reference
    monitor.py:30)."""

    def __init__(self, config):
        from .backends import (CometMonitor, CSVMonitor, PrometheusMonitor,
                               TensorBoardMonitor, WandbMonitor)

        self.backends: list[Monitor] = []
        self._backend_warned: set[str] = set()
        for attr, cls in (("tensorboard", TensorBoardMonitor),
                          ("wandb", WandbMonitor),
                          ("csv_monitor", CSVMonitor),
                          ("comet", CometMonitor),
                          ("prometheus", PrometheusMonitor)):
            sub = getattr(config, attr, None)
            if sub is not None and getattr(sub, "enabled", False):
                backend = cls(sub)
                if backend.enabled:
                    self.backends.append(backend)
        self.enabled = bool(self.backends)

    def _guarded(self, backend: Monitor, method: str, *args) -> None:
        """One failing backend (full disk under CSV, a wandb network blip)
        must never raise out of the train step or starve the others —
        isolate, warn ONCE per backend+method, keep fanning out."""
        try:
            getattr(backend, method)(*args)
        except Exception as e:
            from ..utils.logging import logger

            key = f"{type(backend).__name__}.{method}"
            if key not in self._backend_warned:
                self._backend_warned.add(key)
                logger.warning(
                    f"monitor backend {key} failed ({e!r}); further "
                    f"failures of this backend are suppressed")

    def write_events(self, event_list: Sequence[Event]) -> None:
        for b in self.backends:
            self._guarded(b, "write_events", event_list)

    def write_counters(self, counters: dict, step: int,
                       prefix: str = "") -> None:
        """Convenience for scalar counter dicts — the resilience layer
        (rewinds / skipped steps / checkpoint save+commit durations) emits
        through this so dashboards see recovery activity without bespoke
        plumbing: ``{"rewinds": 2}`` → ``("<prefix>rewinds", 2.0, step)``."""
        if not self.enabled or not counters:
            return
        self.write_events([(f"{prefix}{k}", float(v), int(step))
                           for k, v in counters.items()])
        # counter emissions are low-frequency (steps_per_print / recovery
        # events) and exist to be LOOKED AT — flush through to disk/backends
        # so a crash right after doesn't eat the last window
        self.flush()

    def flush(self) -> None:
        for b in self.backends:
            self._guarded(b, "flush")
