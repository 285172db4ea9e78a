"""The port's package logger, ``deepspeed_tpu_torch``.

Counterpart of ``deepspeed_tpu/utils/logging.py``: one named logger writing
to stdout, its level read from ``DS_TPU_LOG_LEVEL`` (debug | info | warning
| error | critical; default info).
"""
from __future__ import annotations

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "deepspeed_tpu_torch") -> logging.Logger:
    level = LOG_LEVELS.get(os.environ.get("DS_TPU_LOG_LEVEL", "info").lower(),
                           logging.INFO)
    logger_ = logging.getLogger(name)
    logger_.setLevel(level)
    logger_.propagate = False
    if not logger_.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setLevel(level)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S"))
        logger_.addHandler(handler)
    return logger_


logger = _create_logger()
