"""Profiler range annotations — the NVTX analogue.

Reference: deepspeed/utils/nvtx.py ``instrument_w_nvtx`` (wraps functions in
``get_accelerator().range_push/pop`` so kernels group under named ranges in
nsight). The port's counterpart of ``deepspeed_tpu/utils/annotations.py``
(where a range is a ``jax.profiler.TraceAnnotation`` plus a
``jax.named_scope``): a ``torch.profiler.record_function`` range, so a
``torch.profiler`` trace groups the kernels launched inside it under the
name, plus an NVTX range (``torch.cuda.nvtx``) when CUDA is present. On the
CPU the NVTX range is left out: there is no card to trace. No range opens
while the current CUDA stream is capturing a graph.

Like a ``TraceAnnotation`` with no trace active, a range costs next to
nothing when no profiler runs: ``record_function`` is entered only while
one is (a range opened before a profiler starts is not recorded by it);
the NVTX push / pop stay, for an external tool.
"""
from __future__ import annotations

import functools

import torch

_cuda: bool | None = None        # CUDA present (probed at first range)


def _has_cuda() -> bool:
    global _cuda
    if _cuda is None:
        _cuda = torch.cuda.is_available()
    return _cuda


def instrument_w_nvtx(fn=None, *, name: str | None = None):
    """Decorator: run ``fn`` under a named profiler range. Usable bare
    (``@instrument_w_nvtx``) or with a custom name."""
    def wrap(f):
        label = name or getattr(f, "__qualname__", getattr(f, "__name__", "fn"))

        @functools.wraps(f)
        def inner(*args, **kwargs):
            with range_push(label):
                return f(*args, **kwargs)

        return inner

    return wrap(fn) if fn is not None else wrap


class range_push:
    """Context-manager form (reference range_push/range_pop pairs)."""

    def __init__(self, name: str):
        self.name = name
        self._rf = None
        self._nvtx = False

    def __enter__(self):
        if _has_cuda():
            if torch.cuda.is_current_stream_capturing():
                return self
            torch.cuda.nvtx.range_push(self.name)
            self._nvtx = True
        if torch.autograd.profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
            self._rf = None
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
            self._nvtx = False
        return False
