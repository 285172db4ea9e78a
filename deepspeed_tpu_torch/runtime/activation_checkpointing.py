"""Activation checkpointing (rematerialization).

Counterpart of ``deepspeed_tpu/runtime/activation_checkpointing.py``: the
Megatron-style module surface of the reference (``configure(config)`` and
``checkpoint(fn, *args)``) over the policy registry of ``ops/remat.py``
(``torch.utils.checkpoint``, selective checkpointing for the matmul-saving
policies). ``partition_activations`` asks for the residual stream
partitioned over the sequence: at ``seq`` > 1 each rank already holds only
its slice of every row's tokens (``parallel/sequence.py``), and at seq 1
the engine warns that activations stay whole, as the JAX one does;
``cpu_checkpointing`` maps to the "offload" policy: the unbatched products'
outputs kept in pinned host memory, everything else recomputed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..config import ActivationCheckpointingConfig, Config, _take
from ..ops.remat import (  # noqa: F401  (re-exported native surface)
    POLICIES,
    checkpoint_fn,
    make_policy,
)

_configured = ActivationCheckpointingConfig()


def configure(config: Config | ActivationCheckpointingConfig | dict | None = None,
              **kwargs) -> None:
    """Set the module-level checkpointing behavior from a DeepSpeed-style
    config section (the whole Config, the section dict, or kwargs)."""
    global _configured
    if isinstance(config, Config):
        _configured = config.activation_checkpointing
    elif isinstance(config, ActivationCheckpointingConfig):
        _configured = config
    elif isinstance(config, dict):
        _configured = _take(dict(config), ActivationCheckpointingConfig,
                            "activation_checkpointing")
    if kwargs:
        _configured = dataclasses.replace(_configured, **kwargs)


def checkpoint(function: Callable, *args):
    """Run ``function(*args)`` under the configured policy ("full" when none
    is configured), the reference's ``CheckpointFunction`` call shape."""
    policy = _configured.policy if _configured.policy != "none" else "full"
    return checkpoint_fn(function, policy=policy)(*args)
