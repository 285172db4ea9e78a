"""Latency-hiding tensor parallelism: ring collective matmuls.

Counterpart of ``deepspeed_tpu/parallel/tensor.py``. A tensor-parallel
projection otherwise waits on a blocking collective: the column-parallel
in-projection on its activation all-gather, the row-parallel out-projection
on its all-reduce. The ring "collective matmul" (Wang et al., ASPLOS'23)
splits the product into per-peer chunks whose point-to-point transfers
travel the ring while the dependent partial products run.

The JAX functions take global arrays and run their ring inside
``shard_map``; these run SPMD, one process per tensor rank, on this rank's
shards, over the ``tensor`` group of the topology registered with
``comm.set_topology``. Each transfer is started (``comm.ring_shift(...,
async_op=True)``) before the partial products that do not depend on it, so
the products run while the chunk is in flight:

- :func:`allgather_matmul` — column-parallel in-projection: ``x`` is this
  rank's row chunk ``[C, K]``, ``w`` this rank's output columns ``[K,
  N/n]`` (or a tuple of such weights fed by ONE ring: fused QKV, GLU gate
  and up). Returns ``[n*C, N/n]``: every row, this rank's columns.
- :func:`matmul_reduce_scatter` — row-parallel out-projection: ``x`` is
  every row of this rank's contraction slice ``[M, K/n]``, ``w`` the
  matching rows ``[K/n, N]``; partial outputs ring-accumulate in fp32
  toward their owner. Returns this rank's row chunk ``[M/n, N]``.
- :func:`ring_row_matmul` — a row-parallel product whose output stays
  replicated: the reduce-scatter ring followed by an all-gather, a
  ``torch.autograd.Function`` whose backward is the transposed ring (the
  output gradient's chunks travel the ring and each arriving chunk feeds
  the input and weight gradients).

Local products go through ``ops/quant_matmul.local_matmul``: a per-shard
``QuantLinear`` launches the quantized-weight kernel (K2) on every ring
step, a plain weight is one matrix product. As in the JAX package,
``QuantLinear`` shapes are per-shard (the engine quantizes each shard's
slice); here plain weights are per-shard too.

The JAX package checks that a global dim divides the axis; on shards that a
caller has already cut, the checks that remain raise its ``ValueError``\\ s
(a 2-D ``x``, the contraction match, output rows that divide the axis for
the reduce-scatter), and :func:`ring_row_matmul` returns None with a
fallback count where the JAX one does. :data:`overlap_counters` counts each
ring product with its steps and the bytes it permutes, and each fallback;
the JAX package counts once per traced program, the port at every call.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from contextlib import contextmanager
from typing import Any

import torch

from .. import comm
from ..ops.quant_matmul import QuantLinear, local_matmul


# ---------------------------------------------------------------------------
# overlap accounting
# ---------------------------------------------------------------------------

class OverlapCounters:
    """Process-wide ring collective-matmul counters; the keys are the
    engine ``stats`` keys."""

    _KEYS = ("tp_ring_matmuls", "tp_ring_steps", "tp_bytes_permuted",
             "tp_fallbacks")

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._c = {k: 0 for k in self._KEYS}
            self._p: dict[str, list[int]] = {}

    def ring(self, steps: int, bytes_permuted: int) -> None:
        with self._lock:
            self._c["tp_ring_matmuls"] += 1
            self._c["tp_ring_steps"] += int(steps)
            self._c["tp_bytes_permuted"] += int(bytes_permuted)

    def fallback(self) -> None:
        with self._lock:
            self._c["tp_fallbacks"] += 1

    def products(self, kernel: str, made: int, blocking: int) -> None:
        """A ring made ``made`` local products, each a launch of
        ``kernel``, where the blocking path makes ``blocking``."""
        with self._lock:
            p = self._p.setdefault(kernel, [0, 0])
            p[0] += made
            p[1] += blocking

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._c)

    def products_snapshot(self) -> dict[str, tuple[int, int]]:
        """{kernel: (local products the rings made, products the blocking
        path would have made)}: a kernel's launches on a ringing path are
        the blocking path's plus the difference."""
        with self._lock:
            return {k: tuple(v) for k, v in self._p.items()}


overlap_counters = OverlapCounters()


# ---------------------------------------------------------------------------
# scope: how model code finds the ring (the training engine opens it under
# tensor_parallel.overlap; models/transformer.py's row-parallel wo and
# w_down read it)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPOverlapScope:
    """Active ring-overlap context for model code: the topology whose
    ``axis`` group rings, the mesh axes of the token dims of activations
    (``token_specs``), and which projections ring."""
    topology: Any
    axis: str = "tensor"
    token_specs: tuple = (("data", "expert", "fsdp"), "seq")
    attention: bool = True
    ffn: bool = True


_scope: TPOverlapScope | None = None


@contextmanager
def tp_overlap_scope(topology, *, axis: str = "tensor",
                     token_specs: tuple = (("data", "expert", "fsdp"),
                                           "seq"),
                     attention: bool = True, ffn: bool = True):
    """Enable ring collective matmuls in model code run inside the
    context. A process global, as ``comm.sequence_parallel_scope`` is: on
    CUDA the backward, and the forward that remat runs again inside it,
    run on autograd's device thread, which a context variable set here
    would not reach."""
    global _scope
    prev = _scope
    _scope = TPOverlapScope(topology, axis, tuple(token_specs), attention,
                            ffn)
    try:
        yield
    finally:
        _scope = prev


def current_tp_overlap() -> TPOverlapScope | None:
    return _scope


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------

def _check_w(w) -> None:
    if not isinstance(w, QuantLinear) and w.dim() != 2:
        raise ValueError(f"dense ring weights must be 2D, got "
                         f"{tuple(w.shape)} — reshape the projection to "
                         f"[K, N] first")


def _w_contract_out(w, n: int, *, sharded: str) -> tuple[int, int]:
    """(global contraction K, global output N) of one weight shard under
    ``sharded`` ∈ {'col', 'row'} over an axis of size ``n`` (shapes are
    per-shard, a ``QuantLinear``'s logical ``shape`` and a plain weight's
    alike)."""
    K, N = (w.shape if isinstance(w, QuantLinear)
            else (int(w.shape[-2]), int(w.shape[-1])))
    return (K, N * n) if sharded == "col" else (K * n, N)


def _dot(w, layer_index, small_m_xla):
    return lambda c: local_matmul(c, w, layer_index=layer_index,
                                  small_m_xla=small_m_xla)


def _kernel(w) -> str | None:
    """The kernel a local product with ``w`` launches (a plain weight's
    matrix product: none)."""
    return "k2" if isinstance(w, QuantLinear) else None


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


# ---------------------------------------------------------------------------
# ring cores (this rank's shards)
# ---------------------------------------------------------------------------

def _ring_ag_core(x_loc, dots, n: int, axis_name: str, kernels=()):
    """Bidirectional all-gather⊗matmul: ``x_loc`` [C, K] is this rank's
    token chunk; each step's transfer is started before the products of the
    chunks already here, so the two overlap. Returns ``[n*C, N_j]`` per
    dot. ``kernels[j]`` names the kernel dot j launches (None: none), for
    :meth:`OverlapCounters.products`."""
    C = x_loc.shape[0]
    made = [0] * len(dots)

    def run(j, chunk):
        made[j] += 1
        return dots[j](chunk)

    idx = comm.axis_index(axis_name)
    k_up = n // 2                   # ceil((n-1)/2) hops from below …
    k_dn = n - 1 - k_up             # … the rest from above

    def start(up, dn, s):
        xs, shifts = [up], [1]
        if s <= k_dn:
            xs.append(dn)
            shifts.append(-1)
        return comm.ring_shift(xs, shifts, axis_name, async_op=True)

    pend = start(x_loc, x_loc, 1) if n > 1 else None
    outs = [run(j, x_loc) for j in range(len(dots))]
    ys = [o.new_empty((n * C, o.shape[1])) for o in outs]
    for y, o in zip(ys, outs):
        y[idx * C:(idx + 1) * C] = o
    for s in range(1, k_up + 1):
        got = pend.wait()
        up = got[0]                                   # shard idx-s
        dn = got[1] if s <= k_dn else None            # shard idx+s
        if s < k_up:
            pend = start(up, dn, s + 1)
        for src, chunk in (((idx - s) % n, up), ((idx + s) % n, dn)):
            if chunk is None:
                continue
            for j, y in enumerate(ys):
                y[src * C:(src + 1) * C] = run(j, chunk)
    for j, k in enumerate(kernels):
        if k is not None:
            overlap_counters.products(k, made[j], 1)
    return ys


def _ring_rs_core(x_loc, dot, n: int, axis_name: str, out_dtype, *,
                  bidir: bool | None = None, kernel: str | None = None):
    """Bidirectional matmul⊗reduce-scatter: ``x_loc`` [M, K_loc] (every
    rank holds all M rows of its contraction slice); the partial outputs of
    each destination's row chunk ring-accumulate toward their owner in
    fp32, the next chunk's product running while the accumulator travels.
    Returns this rank's ``[M/n, N]`` chunk in ``out_dtype``.

    ``dot(rows, start)`` also receives the chunk's global row offset, for
    callers with per-row side tables (the grouped MoE product's
    tile→expert map). ``bidir=False`` forces the one-directional schedule
    (callers whose side tables cannot split a chunk in half). ``kernel``
    names the kernel ``dot`` launches, for
    :meth:`OverlapCounters.products`."""
    M = x_loc.shape[0]
    C = M // n
    idx = comm.axis_index(axis_name)
    made = [0]

    def part(dest, lo, sz):
        start = dest * C + lo
        made[0] += 1
        return dot(x_loc[start:start + sz], start).float()

    def done(y):
        if kernel is not None:
            overlap_counters.products(kernel, made[0], 1)
        return y.to(out_dtype)

    if bidir is None:
        bidir = C % 2 == 0
    if not bidir or n == 1:
        acc = pend = None
        for s in range(n):
            p = part((idx + (n - 1 - s)) % n, 0, C)
            acc = p if pend is None else pend.wait()[0] + p
            if s != n - 1:
                pend = comm.ring_shift([acc], [1], axis_name, async_op=True)
        return done(acc)
    h = C // 2
    acc_u = acc_d = pend = None
    for s in range(n):
        pu = part((idx + (n - 1 - s)) % n, 0, h)
        pd = part((idx - (n - 1 - s)) % n, h, h)
        if pend is None:
            acc_u, acc_d = pu, pd
        else:
            got = pend.wait()
            acc_u, acc_d = got[0] + pu, got[1] + pd
        if s != n - 1:
            pend = comm.ring_shift([acc_u, acc_d], [1, -1], axis_name,
                                   async_op=True)
    return done(torch.cat([acc_u, acc_d], dim=0))


# ---------------------------------------------------------------------------
# public primitives
# ---------------------------------------------------------------------------

def allgather_matmul(x: torch.Tensor, w, *, axis: str = "tensor",
                     layer_index=None, small_m_xla: bool | None = None):
    """``<all-gather x over axis> @ w``, ring-overlapped.

    x: this rank's row chunk ``[C, K]``; w: this rank's output columns
    ``[K, N/n]`` — a plain weight, a per-shard ``QuantLinear``, or a tuple
    of those (one ring feeds several projections). Returns ``[n*C, N/n]``
    (tuple in → tuple out). ``layer_index`` selects a layer of stacked
    ``[L, ...]`` ``QuantLinear`` codes inside the kernel."""
    # NB QuantLinear is a NamedTuple: the multi-weight form is a plain
    # tuple/list of weights, never the weight itself
    single = isinstance(w, QuantLinear) or not isinstance(w, (tuple, list))
    ws = (w,) if single else tuple(w)
    n = comm.axis_size(axis)
    if x.dim() != 2:
        raise ValueError(f"allgather_matmul expects 2D x, got "
                         f"{tuple(x.shape)}")
    K = x.shape[1]
    for wi in ws:
        _check_w(wi)
        wK, _ = _w_contract_out(wi, n, sharded="col")
        if wK != K:
            raise ValueError(f"contract mismatch: x K={K} vs w K={wK}")
    dots = [_dot(wi, layer_index, small_m_xla) for wi in ws]
    if n == 1:
        outs = tuple(d(x) for d in dots)
        return outs[0] if single else outs
    overlap_counters.ring(steps=n - 1, bytes_permuted=(n - 1) * n * _nbytes(x))
    outs = tuple(_ring_ag_core(x, dots, n, axis,
                               [_kernel(wi) for wi in ws]))
    return outs[0] if single else outs


def matmul_reduce_scatter(x: torch.Tensor, w, *, axis: str = "tensor",
                          layer_index=None,
                          small_m_xla: bool | None = None) -> torch.Tensor:
    """``reduce-scatter(x @ w) over axis``, ring-overlapped.

    x: every row of this rank's contraction slice ``[M, K/n]``; w: the
    matching rows ``[K/n, N]`` (plain or per-shard ``QuantLinear``).
    Returns this rank's row chunk ``[M/n, N]`` in x's dtype, the partial
    products accumulated in fp32. Raises ``ValueError`` when M does not
    divide the axis."""
    n = comm.axis_size(axis)
    if x.dim() != 2:
        raise ValueError(f"matmul_reduce_scatter expects 2D x, got "
                         f"{tuple(x.shape)}")
    M, K = x.shape
    _check_w(w)
    wK, wN = _w_contract_out(w, n, sharded="row")
    if wK != K * n:
        raise ValueError(f"contract mismatch: x K={K * n} vs w K={wK}")
    if n > 1 and M % n:
        raise ValueError(
            f"matmul_reduce_scatter: output rows {M} not divisible by "
            f"'{axis}' axis size {n} — pad the token dim or fall back")
    dot = _dot(w, layer_index, small_m_xla)
    if n == 1:
        return dot(x)
    overlap_counters.ring(steps=n - 1, bytes_permuted=(n - 1) * M * wN * 4)
    return _ring_rs_core(x, lambda rows, _s: dot(rows), n, axis, x.dtype,
                         kernel=_kernel(w))


class _RingRowMatmul(torch.autograd.Function):
    """``all-gather(reduce-scatter(x @ w))`` with the transposed ring as its
    backward: the replicated output gradient's own chunk travels the
    all-gather ring, and each arriving chunk feeds its rows of the input
    gradient and its share of the weight gradient."""

    @staticmethod
    def forward(ctx, x2, w, n, axis):
        ctx.save_for_backward(x2, w)
        ctx.n, ctx.axis = n, axis
        y_c = _ring_rs_core(x2, lambda rows, _s: rows @ w.to(rows.dtype), n,
                            axis, x2.dtype)
        return comm.all_gather(y_c, axis, axis=0)

    @staticmethod
    def backward(ctx, gy):
        x2, w = ctx.saved_tensors
        n, axis = ctx.n, ctx.axis
        C = gy.shape[0] // n
        idx = comm.axis_index(axis)
        g_c = gy[idx * C:(idx + 1) * C].contiguous()
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)

        def dot(chunk, src):
            dw.add_(x2[src * C:(src + 1) * C].float().t() @ chunk.float())
            return chunk @ w.to(chunk.dtype).t()

        # the all-gather ring over g_c, each arriving chunk consumed
        k_up = n // 2
        k_dn = n - 1 - k_up
        dx = gy.new_empty(x2.shape)
        dx[idx * C:(idx + 1) * C] = dot(g_c, idx)
        up = dn = g_c
        for s in range(1, k_up + 1):
            xs, shifts = [up], [1]
            if s <= k_dn:
                xs.append(dn)
                shifts.append(-1)
            got = comm.ring_shift(xs, shifts, axis)
            up = got[0]
            src = (idx - s) % n
            dx[src * C:(src + 1) * C] = dot(up, src)
            if s <= k_dn:
                dn = got[1]
                src = (idx + s) % n
                dx[src * C:(src + 1) * C] = dot(dn, src)
        return dx, dw.to(w.dtype), None, None


def ring_row_matmul(x: torch.Tensor, w: torch.Tensor, *,
                    axis: str = "tensor", lead_specs=None):
    """Replicated-output row-parallel ``x @ w``: x ``[*lead, K/n]`` (this
    rank's contraction slice of every token row), w ``[K/n, N]``; returns
    ``[*lead, N]``, the same on every rank of the axis. Ring
    matmul⊗reduce-scatter then an all-gather of the row chunks;
    differentiable (the backward is the transposed ring).

    Returns None, counting a fallback, where the shapes cannot ring (the
    contraction slices disagree, or the token rows do not divide the axis):
    callers keep the plain product. ``lead_specs`` is accepted for the JAX
    signature: the lead dims here are this process's already."""
    n = comm.axis_size(axis)
    if n <= 1:
        return None
    lead = x.shape[:-1]
    if lead_specs is not None and len(tuple(lead_specs)) != len(lead):
        raise ValueError(f"lead_specs {tuple(lead_specs)} does not match x "
                         f"lead dims {tuple(lead)}")
    _check_w(w)
    wK, wN = _w_contract_out(w, n, sharded="row")
    M = math.prod(lead) if lead else 1
    if wK != x.shape[-1] * n or M % n:
        overlap_counters.fallback()
        return None
    overlap_counters.ring(
        steps=n - 1,
        bytes_permuted=(n - 1) * M * wN * 4
        + (n - 1) * M * wN * x.element_size() // n)
    y = _RingRowMatmul.apply(x.reshape(M, x.shape[-1]), w, n, axis)
    return y.reshape(*lead, wN)


__all__ = ["OverlapCounters", "overlap_counters", "TPOverlapScope",
           "tp_overlap_scope", "current_tp_overlap", "allgather_matmul",
           "matmul_reduce_scatter", "ring_row_matmul"]
