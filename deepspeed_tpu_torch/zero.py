"""``deepspeed_tpu_torch.zero`` — the reference's ``deepspeed.zero``
surface (runtime/zero/partition_parameters.py).

Counterpart of ``deepspeed_tpu/zero.py``. ``Init`` accepts the reference's
arguments, as the JAX package's does: the port builds a model on its
device and ``initialize()`` partitions it (``runtime/zero``), so there is
nothing to do at construction. ``GatheredParameters`` really gathers the
stage-3 parameters it is given for the block (and releases what it
gathered after), and with ``modifier_rank`` writes that rank's edits back
on exit: broadcast to every rank, into the compute partitions and into the
fp32 master wherever a value changed. Parameters of a stage 0-2 engine are
whole already; their edits reach the compute parameters only.
"""
from __future__ import annotations

import contextlib
from typing import Any

import torch

from .utils.logging import logger

_init_logged = False


@contextlib.contextmanager
def Init(module=None, data_parallel_group=None, mem_efficient_linear=True,
         remote_device=None, pin_memory=False, config_dict_or_path=None,
         config=None, enabled=True, dtype=None, mpu=None,
         sequence_data_parallel_group=None, param_dict=None):
    """Construction-time parameter partitioning context (reference
    ``zero.Init``, partition_parameters.py:808). Arguments are accepted
    verbatim; the engine partitions at ``initialize()``."""
    global _init_logged
    if enabled and not _init_logged:
        _init_logged = True
        logger.info("zero.Init: the engine partitions the model at "
                    "initialize(); context accepted for API compatibility")
    yield


def _as_list(params: Any) -> list:
    if params is None:
        return []
    if isinstance(params, torch.nn.Module):
        return list(params.parameters())
    if isinstance(params, torch.Tensor):
        return [params]
    return list(params)


@contextlib.contextmanager
def GatheredParameters(params: Any = None, modifier_rank: int | None = None,
                       fwd_module=None, enabled: bool = True):
    """Reference ``zero.GatheredParameters``: the full values of ``params``
    (a parameter, a list of them or a module) for host-side reads and, with
    ``modifier_rank``, writes (see the module docstring). Every rank of the
    engine's group enters it together."""
    plist = _as_list(params)
    owner = next((getattr(p, "_zero_owner", None) for p in plist
                  if getattr(p, "_zero_owner", None) is not None), None)
    if not enabled or owner is None:
        yield params
        return
    z = owner()
    idx = [z.index_of[id(p)] for p in plist if id(p) in z.index_of]
    units = sorted({z.plan.segment_of(i).unit for i in idx})
    with z.gathered(units):
        before = [z.params[i].data.clone() for i in idx] \
            if modifier_rank is not None else None
        yield params
        if modifier_rank is not None:
            z.write_back(idx, before, modifier_rank)
