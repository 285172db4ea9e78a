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
- "cpu" / "offload" / "offload_dots": the reference's ``cpu_checkpointing``
  (the JAX package's ``offload_dot_with_no_batch_dims("device",
  "pinned_host")``): the outputs of the unbatched products (``mm``,
  ``addmm``) are copied to pinned host memory in the forward and copied
  back in the backward's recompute, which runs everything else again. On
  the card the policy works or raises: there is no quiet fallback.

Every checkpoint is non-reentrant (``use_reentrant=False``), so parameters
reached inside the call get their grads and the K4 autograd function runs
again in the backward.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

#: name → what is kept: None (no checkpoint), "full", "dots",
#: "dots_no_batch", "everything", "offload" (unbatched products, on the host)
POLICIES: dict[str, str | None] = {
    "none": None,
    "full": "full",
    "nothing_saveable": "full",
    "dots_saveable": "dots",
    "checkpoint_dots": "dots",
    "dots_with_no_batch_dims_saveable": "dots_no_batch",
    "checkpoint_dots_with_no_batch_dims": "dots_no_batch",
    "everything_saveable": "everything",
    "cpu": "offload",
    "offload": "offload",
    "offload_dots": "offload",
}

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
    raise ValueError(f"unknown activation checkpointing policy '{name}'; "
                     f"one of {sorted(POLICIES)} or 'offload'")


def _context_fn(saved_ops):
    def policy_fn(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


#: products whose outputs the "offload" policy saved to host memory and
#: took back in a recompute, and the bytes it saved (reset by the caller)
offload_counts = {"saved": 0, "restored": 0, "bytes": 0}


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """A host copy of a product's output: pinned and asynchronous from the
    card (ordered on the stream before any later use), a clone on the
    CPU."""
    if not t.is_cuda:
        return t.detach().clone()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t.detach(), non_blocking=True)
    return host


class _OffloadSave(TorchDispatchMode):
    """The checkpointed forward: every unbatched product's output goes to
    host memory, in call order."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in _SAVED_OPS["dots_no_batch"]:
            self.store.append((_to_host(out), out.device))
            offload_counts["saved"] += 1
            offload_counts["bytes"] += out.numel() * out.element_size()
        return out


class _OffloadRestore(TorchDispatchMode):
    """The backward's recompute: each unbatched product takes its saved
    output back from host memory instead of running; everything else runs
    again."""

    def __init__(self, store: list):
        super().__init__()
        self.store = store
        self.next = 0

    def __enter__(self):
        self.next = 0
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func not in _SAVED_OPS["dots_no_batch"]:
            return func(*args, **(kwargs or {}))
        if self.next >= len(self.store):
            raise RuntimeError("activation offload: the recompute ran more "
                               "products than the forward saved")
        host, device = self.store[self.next]
        self.next += 1
        offload_counts["restored"] += 1
        return host.to(device, non_blocking=True)


def _offload_contexts():
    store: list = []
    return _OffloadSave(store), _OffloadRestore(store)


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
    if kind == "offload":
        return functools.partial(checkpoint, fn, use_reentrant=False,
                                 context_fn=_offload_contexts)
    return functools.partial(checkpoint, fn, use_reentrant=False,
                             context_fn=_context_fn(_SAVED_OPS[kind]))
