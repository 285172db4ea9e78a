"""Rematerialization policy registry.

Counterpart of ``deepspeed_tpu/ops/remat.py``, over ``torch.utils.checkpoint``
instead of ``jax.checkpoint``. The policy names are the JAX package's:

- "full" / "nothing_saveable": checkpoint the call — keep only its inputs
  and run it again in the backward;
- "dots_saveable" / "checkpoint_dots": selective checkpointing that saves
  the outputs of matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``)
  and recomputes the rest; "dots_with_no_batch_dims_saveable" /
  "checkpoint_dots_with_no_batch_dims" save the unbatched ones (``mm``,
  ``addmm``) only;
- "none" / "everything_saveable": no checkpointing;
- "cpu" / "offload" / "offload_dots" (activations in host memory) raise
  NotImplementedError: activation offload comes with ZeRO-Offload (ROADMAP
  queue 1, item 3).

Every checkpoint is non-reentrant (``use_reentrant=False``), so parameters
reached inside the call get their grads and the K4 autograd function runs
again in the backward.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: name → what is kept: None (no checkpoint), "full", "dots",
#: "dots_no_batch", "everything"
POLICIES: dict[str, str | None] = {
    "none": None,
    "full": "full",
    "nothing_saveable": "full",
    "dots_saveable": "dots",
    "checkpoint_dots": "dots",
    "dots_with_no_batch_dims_saveable": "dots_no_batch",
    "checkpoint_dots_with_no_batch_dims": "dots_no_batch",
    "everything_saveable": "everything",
}
_OFFLOAD = ("cpu", "offload", "offload_dots")

_aten = torch.ops.aten
_SAVED_OPS = {
    "dots": {_aten.mm.default, _aten.addmm.default, _aten.bmm.default,
             _aten.baddbmm.default},
    "dots_no_batch": {_aten.mm.default, _aten.addmm.default},
}


def make_policy(name: str) -> str | None:
    """Resolve a policy name (see the module docstring)."""
    if name in POLICIES:
        return POLICIES[name]
    if name in _OFFLOAD:
        raise NotImplementedError(
            f"activation checkpointing policy '{name}' keeps activations in "
            f"host memory: it is ported with ZeRO-Offload (ROADMAP queue 1, "
            f"item 3)")
    raise ValueError(f"unknown activation checkpointing policy '{name}'; "
                     f"one of {sorted(POLICIES)} or 'offload'")


def _context_fn(saved_ops):
    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


def checkpoint_fn(fn: Callable, policy: str = "full") -> Callable:
    """``fn`` (a function or a module, e.g. one transformer block, as the
    JAX package wraps each block with ``nn.remat``) wrapped so its
    intermediates are rematerialized in the backward under ``policy``;
    ``fn`` itself where the policy keeps everything."""
    kind = make_policy(policy)
    if kind in (None, "everything"):
        return fn
    if kind == "full":
        return functools.partial(checkpoint, fn, use_reentrant=False)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=_context_fn(_SAVED_OPS[kind]))
