"""Experiment monitoring (reference deepspeed/monitor/)."""
from .monitor import Monitor, MonitorMaster  # noqa: F401
from .backends import (CSVMonitor, PrometheusMonitor,  # noqa: F401
                       TensorBoardMonitor, WandbMonitor)
