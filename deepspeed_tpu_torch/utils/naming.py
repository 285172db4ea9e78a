"""Shared name sanitization for state keys → filenames.

Counterpart of ``deepspeed_tpu/utils/naming.py``: the universal-checkpoint
atom writer (``checkpoint/universal.py``) and the checkpoint writer
(``runtime/checkpointing.py``) name their files with it.
"""
from __future__ import annotations

import re


def safe_filename(key: str) -> str:
    """Filesystem-safe token for a state key."""
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", key).strip("_")
