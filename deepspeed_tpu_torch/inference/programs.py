"""The serving engine's compiled programs: CUDA graphs over static buffers.

Counterpart of the JAX engine's ``self._programs`` jit cache
(``deepspeed_tpu/inference/engine_v2.py``: ``_program(T, S_rows)`` and
``_window_program(W)``). XLA compiles a step program once per plan shape
and a decode window once per pow2 size, and every later dispatch runs the
compiled program. Here a program is the engine's own eager function,
captured once per key into a ``torch.cuda.CUDAGraph``; a dispatch copies its
plan into the graph's static input and replays it, so a window of W
iterations over L layers costs one launch from the host instead of
thousands.

- Inputs: one flat int64 device buffer per program, the plan's arrays
  packed by :func:`pack` (:func:`unpack` gives the function its views).
  The host side stages them in pinned memory (:class:`HostStaging`), so the
  copy is asynchronous and the host never waits for the device.
- Outputs: the tensors the function returned at capture. Every replay
  rewrites them at the same addresses, so a caller copies them out (on the
  same stream, before the next replay of the same program).
- Capture follows torch's recipe: the function first runs eagerly on a side
  stream with the null input (all zeros: every slot inactive, every row
  writing the trash block, no sample kept), which makes every first-call
  side effect happen outside the capture — library loads, a kernel's
  shared-memory attribute, cached workspaces, cuBLAS handles — and then it
  is captured. All graphs of an engine share one memory pool. The engine's
  generator is registered with each graph, so every replay draws new
  numbers.
- Launch counts: the kernel wrappers count launches in Python, which runs
  at capture and never on a replay. A program records the counts its
  capture added and adds them again on every replay; the warm-up's and the
  capture's own ticks are taken back, so the counts are those of the
  kernels' launches on the device.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Sequence

import numpy as np
import torch


def pack(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """The arrays of one dispatch as one flat int64 array, in order."""
    return np.concatenate([np.asarray(a).reshape(-1) for a in arrays]
                          ).astype(np.int64, copy=False)


def unpack(flat: torch.Tensor, shapes: Sequence[tuple[int, ...]]
           ) -> list[torch.Tensor]:
    """Views of ``flat`` in the shapes :func:`pack` packed, in order."""
    out, off = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(flat[off:off + n].view(shape))
        off += n
    if off != flat.numel():
        raise ValueError(f"packed input of {flat.numel()} values, shapes "
                         f"{list(shapes)} take {off}")
    return out


# ---------------------------------------------------------------------------
# launch counts across replays
# ---------------------------------------------------------------------------

def _counters() -> tuple:
    """The launch counters of every kernel wrapper on the serving path (K1,
    K7, K2, K3, K5)."""
    from ..ops import grouped_matmul as gm
    from ..ops import paged_attention as pa
    from ..ops import quant_matmul as qm

    return (pa.counts, pa.prefill_counts, qm.counts, qm.grouped_counts,
            gm.counts)


def count_snapshot() -> list[dict]:
    return [dataclasses.asdict(c) for c in _counters()]


def _restore(snap: list[dict]) -> None:
    for c, values in zip(_counters(), snap):
        for k, v in values.items():
            setattr(c, k, v)


def _delta(before: list[dict], after: list[dict]) -> list[dict]:
    return [{k: a[k] - b[k] for k in a if a[k] != b[k]}
            for b, a in zip(before, after)]


def _add(delta: list[dict]) -> None:
    for c, values in zip(_counters(), delta):
        for k, v in values.items():
            setattr(c, k, getattr(c, k) + v)


# ---------------------------------------------------------------------------
# staging and programs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _warmup_stream(index: int) -> torch.cuda.Stream:
    """The side stream of every eager warm-up on a device, made once: the
    libraries keep per-stream state (cuBLAS a workspace for each stream it
    runs on), so a fresh stream per capture would leave one behind each
    time."""
    return torch.cuda.Stream(index)


class HostStaging:
    """Pinned host buffers for the plan arrays of a dispatch, used in turn.
    A buffer is refilled only after the host-to-device copy that last read
    it has completed (the event :meth:`copied` records), so up to ``slots``
    dispatches' copies may be in flight; ``waits`` counts the refills that
    had to wait."""

    def __init__(self, slots: int):
        self._bufs: list[torch.Tensor | None] = [None] * slots
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._next = 0
        self.waits = 0

    def stage(self, flat: np.ndarray) -> torch.Tensor:
        """``flat`` in the next pinned buffer; call :meth:`copied` once the
        copy that reads it is enqueued."""
        i = self._next
        ev = self._events[i]
        if ev is not None and not ev.query():
            self.waits += 1
            ev.synchronize()
        buf = self._bufs[i]
        if buf is None or buf.numel() < flat.size:
            buf = self._bufs[i] = torch.empty(
                max(flat.size, 2 * (0 if buf is None else buf.numel())),
                dtype=torch.int64, pin_memory=True)
        view = buf[:flat.size]
        view.numpy()[:] = flat
        return view

    def copied(self, stream) -> None:
        ev = torch.cuda.Event()
        ev.record(stream)
        self._events[self._next] = ev
        self._next = (self._next + 1) % len(self._bufs)


@dataclasses.dataclass
class Program:
    """One captured program: its graph, static input and outputs, the
    launch counts one run adds, and its replays."""
    key: tuple
    graph: torch.cuda.CUDAGraph
    inputs: torch.Tensor
    outputs: tuple
    counts: list
    capture_s: float
    replays: int = 0

    def replay(self) -> tuple:
        self.graph.replay()
        _add(self.counts)
        self.replays += 1
        return self.outputs


class ProgramCache:
    """An engine's programs by key — ``("win", W)`` for a decode window of
    W iterations, ``(T, S_rows)`` for a step plan — in one graph memory
    pool, with the engine's ``generator`` registered with every graph."""

    def __init__(self, device: torch.device, generator: torch.Generator):
        self.device = device
        self._gen = generator
        self._pool = torch.cuda.graph_pool_handle()
        self.programs: dict[tuple, Program] = {}
        #: seconds spent capturing
        self.capture_s = 0.0

    def __contains__(self, key) -> bool:
        return key in self.programs

    def get(self, key: tuple, fn: Callable[[torch.Tensor], tuple],
            n_inputs: int) -> Program:
        """The program of ``key``, captured from ``fn`` (a function of the
        flat int64 input that returns a tuple of tensors) on first use."""
        prog = self.programs.get(key)
        if prog is None:
            prog = self.programs[key] = self._capture(key, fn, n_inputs)
        return prog

    def _capture(self, key, fn, n_inputs: int) -> Program:
        dev = self.device
        t0 = time.perf_counter()
        before = count_snapshot()
        inputs = torch.zeros(n_inputs, dtype=torch.int64, device=dev)
        cur = torch.cuda.current_stream(dev)
        side = _warmup_stream(dev.index if dev.index is not None
                              else torch.cuda.current_device())
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn(inputs)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph, pool=self._pool):
            at = count_snapshot()
            outputs = fn(inputs)
            counts = _delta(at, count_snapshot())
        _restore(before)
        torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        self.capture_s += dt
        return Program(key, graph, inputs, tuple(outputs), counts, dt)

    def pool_bytes(self) -> int:
        """The bytes the graphs' memory pool holds on the card (its
        segments in the caching allocator's snapshot)."""
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def stats(self) -> dict:
        """Graphs, capture seconds, the pool's bytes and the replays by
        key."""
        return {"graphs": len(self.programs), "capture_s": self.capture_s,
                "pool_bytes": self.pool_bytes(),
                "replays": {str(k): p.replays
                            for k, p in self.programs.items()}}
