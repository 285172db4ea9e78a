"""Communication facade over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` (the reference's
``deepspeed.comm``). The JAX package's collectives run inside a compiled
program over a named mesh axis; these run eagerly over that axis's process
group. Every collective takes the JAX ``axis_name`` (one of the mesh axes,
or a tuple of them) and resolves it through the topology the engine
registered (:func:`set_topology`) to the group of processes that share
every other coordinate; ``None`` means the whole world. On the card the
groups are NCCL's, on the CPU gloo's.

``init_distributed`` brings the process group up from the environment
``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` / ``MASTER_PORT``), from the JAX package's variables
(``DS_TPU_COORDINATOR``, ``DS_TPU_NUM_PROCESSES``, ``DS_TPU_PROCESS_ID``)
or from a scheduler's (Open MPI, Slurm, PMI), or from its arguments. With
none of them it makes a world of one on an in-process store, so nothing
binds a port.

:class:`CommsLogger` records each collective's op, axis and bytes, as the
JAX package's does at trace time; here it records at each call.

``all_to_all``, the tiled ``all_gather`` and the ring shifts
``send_recv_next`` / ``send_recv_prev`` are differentiable when their input
requires a gradient, as the JAX collectives are under ``jax.grad``: the
backward is the inverse all-to-all, a reduce-scatter, and the shift the
other way round. :func:`sequence_parallel_scope` says, while a training
step runs, which axis splits each row's tokens, and
:func:`tensor_parallel_scope` which axis shards the model; Megatron's two
conjugate operators :func:`copy_to_tensor` (identity forward, sum
backward) and :func:`reduce_from_tensor` (sum forward, identity backward)
carry its layers' all-reduces.

CUDA tensors over a gloo group (the tensor-parallel or sequence-parallel
ranks that share one card, where NCCL refuses two ranks on one device):
gloo takes
``all_reduce`` and ``broadcast`` of a device tensor itself; every other op
(the gathers and scatters, ``all_to_all`` and the point-to-point sends of
``ppermute`` and the ring shifts) is staged here through pinned host
memory: a blocking copy to the host, the op on the host copy, a copy back.
Staging is never silent: :data:`staged` counts each op's calls and bytes,
the first staged call of an op is logged, and an enabled ``CommsLogger``
records it as ``<op>:host_staged``.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import threading
import time
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist

from ..utils.logging import log_dist, logger


@dataclass
class CommOpRecord:
    op: str
    axis: str
    size_bytes: int
    count: int = 1
    total_bytes: int = 0

    def __post_init__(self):
        self.total_bytes = self.size_bytes


class CommsLogger:
    """Collective accounting (reference comms_logging.py:67): counts and
    bytes per (op, axis, message size)."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 debug: bool = False):
        self.enabled = enabled
        self.verbose = verbose
        self.debug = debug
        self._records: dict[tuple[str, str, int], CommOpRecord] = {}
        self._lock = threading.Lock()

    def configure(self, enabled: bool = True, verbose: bool = False,
                  debug: bool = False) -> None:
        self.enabled = enabled
        self.verbose = verbose
        self.debug = debug

    def record(self, op: str, axis: str, size_bytes: int) -> None:
        if not self.enabled:
            return
        key = (op, axis, size_bytes)
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                self._records[key] = CommOpRecord(op=op, axis=axis,
                                                  size_bytes=size_bytes)
            else:
                rec.count += 1
                rec.total_bytes += size_bytes
        if self.verbose:
            log_dist(f"comm op: {op} | axis: {axis} | msg size: "
                     f"{size_bytes} bytes")

    def log_summary(self) -> str:
        lines = [f"{'op':<20}{'axis':<10}{'msg size':<14}{'count':<8}"
                 f"{'total':<14}"]
        with self._lock:
            for rec in sorted(self._records.values(),
                              key=lambda r: -r.total_bytes):
                lines.append(
                    f"{rec.op:<20}{rec.axis:<10}"
                    f"{_fmt_bytes(rec.size_bytes):<14}{rec.count:<8}"
                    f"{_fmt_bytes(rec.total_bytes):<14}")
        summary = "\n".join(lines)
        log_dist("Communication summary:\n" + summary)
        return summary

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if n < 1024 or unit == "TB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{n} B"
        n /= 1024
    return f"{n} B"


comms_logger = CommsLogger()


def configure_comms_logger(enabled: bool = True, verbose: bool = False,
                           debug: bool = False) -> None:
    comms_logger.configure(enabled=enabled, verbose=verbose, debug=debug)


def log_summary() -> str:
    return comms_logger.log_summary()


# --------------------------------------------------------------------------
# Process bring-up (reference comm.py:619 init_distributed)
# --------------------------------------------------------------------------

def _env_int(*names: str) -> int | None:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def init_distributed(dist_backend: str | None = None, *,
                     init_method: str | None = None,
                     rank: int | None = None, world_size: int | None = None,
                     local_rank: int | None = None, device=None,
                     timeout_s: int = 300) -> None:
    """Bring the default process group up once (a no-op when it is up).

    Rank and world size come from the arguments, else from ``RANK`` /
    ``WORLD_SIZE`` (torchrun), ``DS_TPU_PROCESS_ID`` /
    ``DS_TPU_NUM_PROCESSES``, or a scheduler's variables (the JAX package's
    ``mpi_discovery`` list, comm.py:213-224); the rendezvous from
    ``init_method``, else ``MASTER_ADDR`` / ``MASTER_PORT`` or
    ``DS_TPU_COORDINATOR`` (``host:port``). The backend is NCCL when
    ``device`` is (or defaults to) CUDA and gloo for ``device="cpu"``; on
    CUDA the current device becomes ``cuda:LOCAL_RANK``. With no world size
    anywhere the world is this process alone, on an in-process store."""
    if dist.is_initialized():
        return
    from ..accelerator import get_device

    dev = get_device(device)
    backend = dist_backend or ("nccl" if dev.type == "cuda" else "gloo")
    if rank is None:
        rank = _env_int("RANK", "DS_TPU_PROCESS_ID", "OMPI_COMM_WORLD_RANK",
                        "SLURM_PROCID", "PMI_RANK")
    if world_size is None:
        world_size = _env_int("WORLD_SIZE", "DS_TPU_NUM_PROCESSES",
                              "OMPI_COMM_WORLD_SIZE", "SLURM_NTASKS",
                              "PMI_SIZE")
    if local_rank is None:
        local_rank = _env_int("LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK",
                              "SLURM_LOCALID")
    if local_rank is None:
        local_rank = 0 if rank is None else rank % max(
            1, torch.cuda.device_count() if dev.type == "cuda" else 1)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank)
    timeout = datetime.timedelta(seconds=timeout_s)
    if world_size is None or (world_size == 1 and init_method is None
                              and "MASTER_ADDR" not in os.environ):
        logger.info(f"init_distributed: a world of one ({backend}, "
                    f"in-process store)")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, timeout=timeout)
        return
    if init_method is None:
        coord = os.environ.get("DS_TPU_COORDINATOR")
        if "MASTER_ADDR" in os.environ:
            init_method = (f"tcp://{os.environ['MASTER_ADDR']}:"
                           f"{os.environ.get('MASTER_PORT', '29500')}")
        elif coord:
            init_method = f"tcp://{coord}"
        else:
            raise ValueError(
                f"init_distributed: world size {world_size} but no "
                f"rendezvous (set MASTER_ADDR/MASTER_PORT or pass "
                f"init_method)")
    logger.info(f"init_distributed: {backend} rank {rank}/{world_size} via "
                f"{init_method}")
    dist.init_process_group(backend, init_method=init_method,
                            rank=int(rank or 0), world_size=int(world_size),
                            timeout=timeout)


def is_initialized() -> bool:
    return dist.is_initialized()


def get_rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def get_world_size(group=None) -> int:
    """Processes in ``group`` (the world by default): one device each."""
    return dist.get_world_size(group) if dist.is_initialized() else 1


def get_process_count() -> int:
    return get_world_size()


def get_local_device_count() -> int:
    return 1


def barrier(group=None) -> None:
    """Host-level barrier across processes (reference comm.py:412)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier(group=group)


# --------------------------------------------------------------------------
# Collectives over named mesh axes (reference comm.py:222-521)
# --------------------------------------------------------------------------

_topology = None


def set_topology(topology) -> None:
    """The topology whose axis groups resolve ``axis_name``s (the engine
    registers its own)."""
    global _topology
    _topology = topology


def group_of(axis_name: str | Sequence[str] | None):
    """The process group of ``axis_name``: None (the world) for None or
    when every named axis has size 1 in a world of one."""
    if axis_name is None:
        return None
    if _topology is None:
        if get_world_size() == 1:
            return None
        raise RuntimeError(f"axis '{axis_name}' named but no topology is "
                           f"registered (comm.set_topology)")
    return _topology.group(axis_name)


def axis_size(axis_name: str | Sequence[str] | None) -> int:
    return get_world_size(group_of(axis_name))


def axis_index(axis_name: str | Sequence[str] | None) -> int:
    return get_rank(group_of(axis_name))


def _record(op: str, axis, x: torch.Tensor) -> None:
    if comms_logger.enabled:
        comms_logger.record(op, str(axis), x.numel() * x.element_size())


#: ops gloo runs on CUDA tensors itself; the others are staged here
GLOO_DEVICE_OPS = frozenset({"all_reduce", "broadcast"})
#: staged ops: op -> [calls, bytes]
staged: dict[str, list[int]] = {}


def _host_staged(op: str, axis, x: torch.Tensor, group) -> bool:
    """Whether ``op`` on ``x`` over ``group`` goes through pinned host
    memory (a CUDA tensor, a gloo group, an op gloo does not take on the
    device); counts and logs it when it does."""
    if (not x.is_cuda or op in GLOO_DEVICE_OPS or not dist.is_initialized()
            or dist.get_backend(group) != "gloo"):
        return False
    nbytes = x.numel() * x.element_size()
    rec = staged.setdefault(op, [0, 0])
    rec[0] += 1
    rec[1] += nbytes
    if rec[0] == 1:
        logger.info(f"comm: {op} of CUDA tensors over gloo is staged "
                    f"through pinned host memory")
    if comms_logger.enabled:
        comms_logger.record(f"{op}:host_staged", str(axis), nbytes)
    return True


def _pinned(x: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of ``x``, complete when this returns."""
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def _pinned_empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=True)


# torch 2.13 renames the tensor forms (``*_single``); 2.11 has only the
# older names. Resolve whichever this build has, once per call. CUDA
# tensors over gloo (ZeRO's flat buffers on ranks sharing one card) go
# through pinned host memory.
def _gather_into(out: torch.Tensor, inp: torch.Tensor, group) -> None:
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    if _host_staged("all_gather", None, inp, group):
        host = _pinned_empty(out.shape, out.dtype)
        fn(host, _pinned(inp), group=group)
        out.copy_(host)
        return
    fn(out, inp, group=group)


def _scatter_into(out: torch.Tensor, inp: torch.Tensor, group,
                  op=dist.ReduceOp.SUM) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    if _host_staged("reduce_scatter", None, inp, group):
        host = _pinned_empty(out.shape, out.dtype)
        fn(host, _pinned(inp), op=op, group=group)
        out.copy_(host)
        return
    fn(out, inp, op=op, group=group)


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN, "avg": dist.ReduceOp.SUM,
        "mean": dist.ReduceOp.SUM}


def all_reduce(x: torch.Tensor, axis_name=None, op: str = "sum"
               ) -> torch.Tensor:
    """A new tensor: ``x`` reduced (sum, mean / avg, max, min) over the
    axis's group (reference comm.py:481)."""
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op: {op}")
    _record("all_reduce", axis_name, x)
    out = x.clone()
    group = group_of(axis_name)
    if dist.is_initialized():
        dist.all_reduce(out, op=_OPS[op], group=group)
    if op in ("avg", "mean"):
        out = out / get_world_size(group)
    return out


def all_gather(x: torch.Tensor, axis_name=None, axis: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every member's ``x`` concatenated along ``axis`` in rank order
    (``tiled``), or stacked on a new leading-``axis`` dim (reference
    comm.py:315). Tiled, it is differentiable, as ``lax.all_gather`` is:
    the backward sums the members' gradients and keeps this member's slice
    (a reduce-scatter)."""
    if tiled and _recording(x):
        return _AllGather.apply(x, axis_name, axis)
    return _all_gather(x, axis_name, axis, tiled)


def _all_gather(x: torch.Tensor, axis_name, axis: int, tiled: bool
                ) -> torch.Tensor:
    _record("all_gather", axis_name, x)
    group = group_of(axis_name)
    n = get_world_size(group)
    src = x.movedim(axis, 0).contiguous() if tiled else x.contiguous()
    shape = (n * src.shape[0], *src.shape[1:]) if tiled else (n, *src.shape)
    if _host_staged("all_gather", axis_name, src, group):
        out = _pinned_empty(shape, src.dtype)
        _gather_into(out, _pinned(src), group)
        return out.to(x.device).movedim(0, axis)
    out = src.new_empty(shape)
    if dist.is_initialized():
        _gather_into(out, src, group)
    else:
        out.copy_(src.reshape(out.shape))
    return out.movedim(0, axis)


def reduce_scatter(x: torch.Tensor, axis_name=None, axis: int = 0,
                   op: str = "sum") -> torch.Tensor:
    """``x`` summed over the group, this member's ``1/n`` slice of
    ``axis`` kept (reference comm.py:257); ``op="mean"`` divides by n."""
    _record("reduce_scatter", axis_name, x)
    group = group_of(axis_name)
    n = get_world_size(group)
    src = x.movedim(axis, 0).contiguous()
    if src.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not divide over {n} members")
    shape = (src.shape[0] // n, *src.shape[1:])
    if _host_staged("reduce_scatter", axis_name, src, group):
        out = _pinned_empty(shape, src.dtype)
        _scatter_into(out, _pinned(src), group)
        out = out.to(x.device)
    elif dist.is_initialized():
        out = src.new_empty(shape)
        _scatter_into(out, src, group)
    else:
        out = src.clone()
    if op in ("avg", "mean"):
        out = out / n
    return out.movedim(0, axis)


def all_to_all(x: torch.Tensor, axis_name=None, split_axis: int = 0,
               concat_axis: int = 0, tiled: bool = True) -> torch.Tensor:
    """``x`` split into n pieces along ``split_axis``, piece j sent to
    member j, the received pieces concatenated along ``concat_axis``
    (reference comm.py:222). Differentiable: the backward is the inverse
    all-to-all, split and concat axes swapped (Ulysses' head <-> sequence
    exchange, ``parallel/sequence.py``)."""
    if _recording(x):
        return _AllToAll.apply(x, axis_name, split_axis, concat_axis)
    return _all_to_all(x, axis_name, split_axis, concat_axis)


def _all_to_all(x: torch.Tensor, axis_name, split_axis: int,
                concat_axis: int) -> torch.Tensor:
    _record("all_to_all", axis_name, x)
    group = group_of(axis_name)
    n = get_world_size(group)
    pieces = x.movedim(split_axis, 0)
    if pieces.shape[0] % n:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"does not divide over {n} members")
    src = pieces.reshape(n, pieces.shape[0] // n,
                         *pieces.shape[1:]).contiguous()
    if _host_staged("all_to_all", axis_name, src, group):
        out = _pinned_empty(src.shape, src.dtype)
        dist.all_to_all_single(out, _pinned(src), group=group)
        out = out.to(x.device)
    elif dist.is_initialized():
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=group)
    else:
        out = src.clone()
    # out[j] is member j's piece for this member, in x's layout along
    # split_axis moved to the front
    recv = [out[j].movedim(0, split_axis) for j in range(n)]
    return torch.cat(recv, dim=concat_axis)


def broadcast(x: torch.Tensor, axis_name=None, src: int = 0
              ) -> torch.Tensor:
    """Member ``src``'s ``x`` on every member (reference comm.py:285);
    ``src`` is the rank within the axis's group."""
    _record("broadcast", axis_name, x)
    group = group_of(axis_name)
    out = x.clone().contiguous()
    if dist.is_initialized():
        glob = dist.get_global_rank(group, src) if group is not None else src
        dist.broadcast(out, src=glob, group=group)
    return out


class PendingExchange:
    """Point-to-point receives in flight: :meth:`wait` returns the received
    tensors (on the senders' device: a host-staged receive is copied back
    to it)."""

    def __init__(self, reqs: list, outs: list, device=None, keep=()):
        self._reqs, self._outs, self._device = reqs, outs, device
        self._keep = keep          # the send buffers, alive until wait()

    def wait(self) -> list[torch.Tensor]:
        for req in self._reqs:
            req.wait()
        self._reqs, self._keep = [], ()
        if self._device is None:
            return self._outs
        return [o.to(self._device) for o in self._outs]


def _exchange(sends: list, recvs: list, axis_name, group, op: str
              ) -> PendingExchange:
    """One batch of point-to-point operations: ``sends`` = [(tensor, peer)]
    and ``recvs`` = [(like, peer)] (peers are ranks in ``group``); the i-th
    send of a member pairs with the i-th receive of its peer from it (tag
    i), so two messages between one pair of members cannot cross."""
    to_glob = (lambda r: dist.get_global_rank(group, r)) \
        if group is not None else (lambda r: r)
    device = None
    if sends and _host_staged(op, axis_name, sends[0][0], group):
        device = sends[0][0].device
        sends = [(_pinned(t), p) for t, p in sends]
        outs = [_pinned_empty(t.shape, t.dtype) for t, _ in recvs]
    else:
        outs = [torch.empty_like(t) for t, _ in recvs]
    bufs = [t.contiguous() for t, _ in sends]
    ops = [dist.P2POp(dist.isend, t, to_glob(p), group=group, tag=i)
           for i, (t, (_, p)) in enumerate(zip(bufs, sends))]
    ops += [dist.P2POp(dist.irecv, o, to_glob(p), group=group, tag=i)
            for i, (o, (_, p)) in enumerate(zip(outs, recvs))]
    reqs = dist.batch_isend_irecv(ops) if ops else []
    return PendingExchange(reqs, outs, device, keep=bufs)


def ppermute(x: torch.Tensor, axis_name, perm: list[tuple[int, int]]
             ) -> torch.Tensor:
    """Point-to-point permute: member ``s`` sends to ``d`` for each pair;
    a member nobody sends to gets zeros (``lax.ppermute``)."""
    _record("ppermute", axis_name, x)
    group = group_of(axis_name)
    me = get_rank(group)
    n = get_world_size(group)
    if n == 1:
        return x.clone() if (0, 0) in perm else torch.zeros_like(x)
    sends = [(x, d) for s, d in perm if s == me]
    recvs = [(x, s) for s, d in perm if d == me]
    got = _exchange(sends, recvs, axis_name, group, "ppermute").wait()
    return got[0] if got else torch.zeros_like(x)


def ring_shift(xs: Sequence[torch.Tensor], shifts: Sequence[int], axis_name,
               async_op: bool = False):
    """Ring shifts over the axis in one batch: ``xs[i]`` goes to the member
    ``shifts[i]`` places on, and each member receives the ``xs[i]`` of the
    member ``shifts[i]`` places back. Returns the received tensors, or with
    ``async_op`` a :class:`PendingExchange` (the sends and receives run
    while the caller computes; its ``wait()`` gives them)."""
    group = group_of(axis_name)
    n = get_world_size(group)
    for x in xs:
        _record("ppermute", axis_name, x)
    if n == 1:
        pending = PendingExchange([], [x.clone() for x in xs])
    else:
        me = get_rank(group)
        pending = _exchange([(x, (me + k) % n) for x, k in zip(xs, shifts)],
                            [(x, (me - k) % n) for x, k in zip(xs, shifts)],
                            axis_name, group, "ppermute")
    return pending if async_op else pending.wait()


def send_recv_next(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Shift +1 around the axis ring (pipeline forward activations; ring
    attention's K/V rotation). Differentiable: the cotangent goes the
    other way round the ring."""
    if _recording(x):
        return _RingShift.apply(x, axis_name, 1)
    return ring_shift([x], [1], axis_name)[0]


def send_recv_prev(x: torch.Tensor, axis_name) -> torch.Tensor:
    """Shift -1 around the axis ring (pipeline backward grads);
    differentiable as :func:`send_recv_next`."""
    if _recording(x):
        return _RingShift.apply(x, axis_name, -1)
    return ring_shift([x], [-1], axis_name)[0]


# --------------------------------------------------------------------------
# collectives with gradients (the transposes XLA gives the JAX package's)
# --------------------------------------------------------------------------

def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all`; the backward is the inverse exchange."""

    @staticmethod
    def forward(ctx, x, axis_name, split_axis: int, concat_axis: int):
        ctx.args = (axis_name, split_axis, concat_axis)
        return _all_to_all(x, axis_name, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        axis_name, split_axis, concat_axis = ctx.args
        return (_all_to_all(g.contiguous(), axis_name, concat_axis,
                            split_axis), None, None, None)


class _AllGather(torch.autograd.Function):
    """Tiled :func:`all_gather`; the backward is a reduce-scatter (sum)
    along the gathered dim."""

    @staticmethod
    def forward(ctx, x, axis_name, axis: int):
        ctx.args = (axis_name, axis)
        return _all_gather(x, axis_name, axis, True)

    @staticmethod
    def backward(ctx, g):
        axis_name, axis = ctx.args
        return reduce_scatter(g, axis_name, axis=axis), None, None


class _RingShift(torch.autograd.Function):
    """A ring shift by ``k``; the backward shifts the cotangent by -k."""

    @staticmethod
    def forward(ctx, x, axis_name, k: int):
        ctx.args = (axis_name, k)
        return ring_shift([x], [k], axis_name)[0]

    @staticmethod
    def backward(ctx, g):
        axis_name, k = ctx.args
        return ring_shift([g.contiguous()], [-k], axis_name)[0], None, None


class _AllReduceMean(torch.autograd.Function):
    """The mean over a group, with the gradient passed through: every
    member's upstream gradient is the same (the loss is a function of the
    mean), so each member's share of d(mean)/dx_r, summed by the engine's
    mean over members, is the upstream gradient itself."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def all_reduce_mean_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """:class:`_AllReduceMean` (a no-op in a world of one)."""
    if not dist.is_initialized() or dist.get_world_size(group) == 1:
        return x
    return _AllReduceMean.apply(x, group)


# --------------------------------------------------------------------------
# Megatron's conjugate operators over the tensor axis
# --------------------------------------------------------------------------

#: the tensor all-reduces of :func:`copy_to_tensor` / :func:`reduce_from_tensor`
#: (forward and backward): calls, bytes and host seconds inside them
tensor_allreduce = {"calls": 0, "bytes": 0, "seconds": 0.0}


def _tensor_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis`` (a new tensor), counted in
    :data:`tensor_allreduce`. gloo takes CUDA tensors for ``all_reduce``
    itself (:data:`GLOO_DEVICE_OPS`): nothing is staged."""
    t0 = time.perf_counter()
    out = all_reduce(x.contiguous(), axis)
    tensor_allreduce["calls"] += 1
    tensor_allreduce["bytes"] += x.numel() * x.element_size()
    tensor_allreduce["seconds"] += time.perf_counter() - t0
    return out


class _CopyToTensor(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the axis."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _tensor_sum(g, ctx.axis), None


class _ReduceFromTensor(torch.autograd.Function):
    """The sum over the axis forward; identity backward."""

    @staticmethod
    def forward(ctx, x, axis):
        return _tensor_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tensor(x: torch.Tensor, axis: str = "tensor") -> torch.Tensor:
    """Megatron's ``f``: the replicated stream entering column-parallel
    products. Identity forward; the backward all-reduces (sums) the
    gradient over ``axis``, each member holding its columns' share. A
    no-op on an axis of one."""
    if axis_size(axis) == 1:
        return x
    return _CopyToTensor.apply(x, axis)


def reduce_from_tensor(x: torch.Tensor, axis: str = "tensor") -> torch.Tensor:
    """Megatron's ``g``: the partial sums of a row-parallel product summed
    over ``axis`` (an all-reduce); identity backward, every member's
    upstream gradient being the same. A no-op on an axis of one."""
    if axis_size(axis) == 1:
        return x
    if _recording(x):
        return _ReduceFromTensor.apply(x, axis)
    return _tensor_sum(x, axis)


# --------------------------------------------------------------------------
# The data-parallel scope of a training step
# --------------------------------------------------------------------------

@dataclass
class DataParallel:
    """The group a step's rows are split over, with this member's rank."""
    group: object
    size: int
    rank: int


_dp: DataParallel | None = None


@contextlib.contextmanager
def data_parallel_scope(group, size: int, rank: int):
    """While a step's forward and backward run, the statistics the JAX
    engine takes over the whole global micro-batch (the loss's count of
    labelled tokens, the MoE gating means) are taken over ``group``. A
    process global, not a thread's: on CUDA the backward, and the forward
    that remat runs again inside it, run on autograd's device thread. A
    no-op for a group of one."""
    global _dp
    prev = _dp
    _dp = DataParallel(group, size, rank) if size > 1 else None
    try:
        yield
    finally:
        _dp = prev


def current_data_parallel() -> DataParallel | None:
    return _dp


# --------------------------------------------------------------------------
# The sequence-parallel scope of a training step
# --------------------------------------------------------------------------

@dataclass
class SequenceParallel:
    """The mesh axis a step's sequence dim is split over: ``size`` members,
    this one holding global positions ``[rank * S_local, (rank + 1) *
    S_local)``."""
    axis: str
    size: int
    rank: int


_sp: SequenceParallel | None = None


@contextlib.contextmanager
def sequence_parallel_scope(axis: str, size: int, rank: int):
    """While a step's forward and backward run, each rank holds a
    contiguous slice of every row's tokens: the model places them at their
    global positions and runs attention over the whole sequence through
    Ulysses' all-to-alls over ``axis`` (``models/transformer.py``). A
    process global, as :func:`data_parallel_scope` is (autograd's device
    thread runs the backward and remat's forwards); a no-op for a size of
    one."""
    global _sp
    prev = _sp
    _sp = SequenceParallel(axis, size, rank) if size > 1 else None
    try:
        yield
    finally:
        _sp = prev


def current_sequence_parallel() -> SequenceParallel | None:
    return _sp


# --------------------------------------------------------------------------
# The tensor-parallel scope of a training step
# --------------------------------------------------------------------------

@dataclass
class TensorParallel:
    """The mesh axis a step's model is sharded over, Megatron-style:
    ``size`` members, this one holding slice ``rank`` of every sharded
    parameter (heads, FFN columns, vocab rows)."""
    axis: str
    size: int
    rank: int


_tp: TensorParallel | None = None


@contextlib.contextmanager
def tensor_parallel_scope(axis: str, size: int, rank: int):
    """While a step's forward and backward run, the model's modules hold
    this member's slices and run their Megatron layers over ``axis``
    (``models/transformer.py``): :func:`copy_to_tensor` before a
    column-parallel product, :func:`reduce_from_tensor` after a row-parallel
    one, the loss over vocab-sharded logits. A process global, as
    :func:`sequence_parallel_scope` is; a no-op for a size of one."""
    global _tp
    prev = _tp
    _tp = TensorParallel(axis, size, rank) if size > 1 else None
    try:
        yield
    finally:
        _tp = prev


def current_tensor_parallel() -> TensorParallel | None:
    return _tp
