"""Monitor backends (reference deepspeed/monitor/{tensorboard,wandb,
csv_monitor}.py). CSV is always available; TB/W&B import lazily and disable
themselves (with a log line) when the package is absent.
"""
from __future__ import annotations

import os
from typing import Sequence

from ..utils.logging import logger
from .monitor import Monitor


class TensorBoardMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        self.writer = None
        if not self.enabled:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter
        except Exception:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
            except Exception:
                logger.warning("tensorboard not available; TB monitor disabled")
                self.enabled = False
                return
        path = os.path.join(config.output_path or "runs", config.job_name)
        self.writer = SummaryWriter(log_dir=path)

    def write_events(self, event_list: Sequence[tuple]) -> None:
        if not self.enabled or self.writer is None:
            return
        for tag, value, step in event_list:
            self.writer.add_scalar(tag, float(value), int(step))

    def flush(self) -> None:
        if self.writer is not None:
            self.writer.flush()


class WandbMonitor(Monitor):
    def __init__(self, config):
        super().__init__(config)
        if not self.enabled:
            return
        try:
            import wandb
        except Exception:
            logger.warning("wandb not available; wandb monitor disabled")
            self.enabled = False
            return
        self._wandb = wandb
        wandb.init(project=config.project, group=config.group,
                   entity=config.team, name=config.job_name)

    def write_events(self, event_list: Sequence[tuple]) -> None:
        if not self.enabled:
            return
        for tag, value, step in event_list:
            self._wandb.log({tag: float(value)}, step=int(step))


class CometMonitor(Monitor):
    """Comet ML backend (reference deepspeed/monitor/comet.py). Lazily
    imports comet_ml and disables itself when absent — this image has no
    network, so in practice it only activates in user deployments."""

    def __init__(self, config):
        super().__init__(config)
        if not self.enabled:
            return
        try:
            import comet_ml
        except Exception:
            logger.warning("comet_ml not available; comet monitor disabled")
            self.enabled = False
            return
        kw = {}
        for key in ("project", "workspace", "api_key", "experiment_key",
                    "online", "mode"):
            v = getattr(config, key, None)
            if v is not None:
                kw[key] = v
        try:
            self.experiment = comet_ml.start(**kw)
            name = getattr(config, "experiment_name", None)
            if name:
                self.experiment.set_name(name)
        except Exception as e:  # bad creds/kwargs must not kill training
            logger.warning(f"comet experiment init failed ({e}); disabled")
            self.enabled = False

    def write_events(self, event_list: Sequence[tuple]) -> None:
        if not self.enabled:
            return
        for tag, value, step in event_list:
            self.experiment.log_metric(tag, float(value), step=int(step))

    def flush(self) -> None:
        if self.enabled and hasattr(self.experiment, "flush"):
            self.experiment.flush()


class PrometheusMonitor(Monitor):
    """Prometheus text-format exposition of monitor events.

    No reference analogue (the reference monitor/ pushes to TB/W&B/CSV);
    production serving wants a PULL endpoint. Events land as gauges named
    by their sanitized tag in the PROCESS-WIDE telemetry registry
    (telemetry/), so one ``/metrics`` page carries both the write_events
    stream (Resilience/*, Train/*, user scalars) and the engines' native
    SLO instruments. ``config.port`` starts the stdlib HTTP endpoint
    (0 = ephemeral); ``port: null`` keeps it render-only — reachable via
    ``telemetry.get_telemetry().registry.render_prometheus()`` or a
    later ``start_http``."""

    def __init__(self, config):
        super().__init__(config)
        self.registry = None
        if not self.enabled:
            return
        from ..telemetry import get_telemetry, sanitize_metric_name

        self._sanitize = sanitize_metric_name
        telem = get_telemetry()
        self.registry = telem.registry
        port = getattr(config, "port", None)
        if port is not None:
            try:
                telem.start_http(int(port))
            except OSError as e:   # a busy port must not kill training
                logger.warning(f"prometheus monitor: cannot bind port "
                               f"{port} ({e}); exposition is render-only")

    def write_events(self, event_list: Sequence[tuple]) -> None:
        if not self.enabled:
            return
        for tag, value, step in event_list:
            self.registry.gauge(self._sanitize(tag)).set(float(value))
            self.registry.gauge("monitor_last_step").set(float(step))


class CSVMonitor(Monitor):
    """One csv per tag under output_path/job_name (reference
    csv_monitor.py)."""

    def __init__(self, config):
        super().__init__(config)
        self._files: dict[str, object] = {}
        if not self.enabled:
            return
        self.dir = os.path.join(config.output_path or "csv_logs",
                                config.job_name)
        os.makedirs(self.dir, exist_ok=True)

    def _file(self, tag: str):
        if tag not in self._files:
            safe = tag.replace("/", "_")
            f = open(os.path.join(self.dir, f"{safe}.csv"), "a")
            if f.tell() == 0:
                f.write("step,value\n")
            self._files[tag] = f
        return self._files[tag]

    def write_events(self, event_list: Sequence[tuple]) -> None:
        if not self.enabled:
            return
        for tag, value, step in event_list:
            self._file(tag).write(f"{int(step)},{float(value)}\n")

    def flush(self) -> None:
        for f in self._files.values():
            f.flush()
