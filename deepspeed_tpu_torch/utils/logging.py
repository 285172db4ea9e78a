"""The port's package logger, ``deepspeed_tpu_torch``.

Counterpart of ``deepspeed_tpu/utils/logging.py``: one named logger writing
to stdout, its level read from ``DS_TPU_LOG_LEVEL`` (debug | info | warning
| error | critical; default info), and ``log_dist``, which logs on chosen
process ranks only.
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


def log_dist(message: str, ranks: list[int] | None = None,
             level: int = logging.INFO) -> None:
    """Log ``message`` on the listed process ranks (rank 0 by default; -1
    for every rank). The port's engine runs in one process, rank 0."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    ranks = [0] if ranks is None else ranks
    if -1 in ranks or rank in ranks:
        logger.log(level, f"[Rank {rank}] {message}")
