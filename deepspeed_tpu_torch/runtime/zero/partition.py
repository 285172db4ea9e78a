"""ZeRO stages 1-3 over a process group: the flat buffers, the gathers and
releases, and the gradient reduce-scatters.

The JAX package has no module for this: XLA emits the collectives its
planner's shardings imply. Here they are written on ``torch.distributed``'s
collectives (NCCL on the card, gloo on the CPU), over the layout of
:mod:`.planner`:

- every rank keeps its partition of the fp32 master and of the optimizer's
  moments, one flat tensor each (on the host under ZeRO-Offload:
  ``host_opt``, ``runtime/zero/offload.py``);
- each segment has one compute-dtype buffer; the parameters' ``.data`` are
  views into it. After an update each rank casts its master chunk and the
  buffer is all-gathered in place of the old values (stages 1-2, and the
  persistent segments of stage 3);
- stage 3's partitioned segments keep only the rank's chunk; the buffer is
  gathered when its unit runs and released after, by shrinking its storage
  to nothing (``untyped_storage().resize_(0)``), never by reassigning
  ``.data``: tensors autograd saved for the backward are views of the same
  storage, and the gather before the unit's backward revives them. A block
  is gathered by a forward pre-hook and released by a forward post-hook
  outside the backward; its outputs pass through an identity function whose
  backward gathers it again (the forward remat runs again inside the
  backward gathers it too). The root unit (embeddings, final norm,
  unembedding, tied or not) stays gathered from the start of a forward to
  the end of its backward;
- stage 1 sums full fp32 gradients over the micro-batches and
  reduce-scatters them once; stages 2-3 reduce-scatter a unit's gradients,
  cast to fp32, as soon as autograd has accumulated every one of them
  (``register_post_accumulate_grad_hook``, counted per unit) and free them:
  full fp32 gradients never live across micro-batches.

Every collective runs in the same order on every rank: the forward and the
backward visit the units in one order everywhere. Each gather, gradient
reduce-scatter and post-update gather runs inside a ``torch.profiler``
range (``zero.gather``, ``zero.reduce_scatter``, ``zero.all_gather``), so
a profile can sum the device time ZeRO adds, copies included.
"""
from __future__ import annotations

import contextlib
import weakref

import torch
import torch.distributed as dist

from torch.profiler import record_function

from ...comm.comm import _gather_into, _scatter_into
from ...ops.optimizers import OptState, Optimizer
from .planner import ZeroPlan


class _PreBackwardGather(torch.autograd.Function):
    """Identity on a unit's outputs; its backward gathers the unit before
    the unit's own backward runs."""

    @staticmethod
    def forward(ctx, zero, unit, *xs):
        ctx.zero, ctx.unit = zero, unit
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.zero.gather(ctx.unit)
        return (None, None, *grads)


class ZeroRuntime:
    """The partitioned state of one engine (see the module docstring).
    ``params`` are the model's parameters in the plan's order, holding
    their fp32 values; on return their ``.data`` are views of the compute
    buffers, in ``dtype``. ``tensor`` = (the tensor group, whether each
    parameter is sharded over it) at tensor > 1: each tensor rank
    partitions its own slices over ``group``, and the gradient norm and
    LAMB's per-tensor norms sum a sharded parameter's squares over the
    tensor ranks (a replicated one counted once)."""

    def __init__(self, plan: ZeroPlan, params: list[torch.nn.Parameter],
                 dtype: torch.dtype, optimizer: Optimizer, group,
                 device: torch.device, modules: dict[int, torch.nn.Module]
                 | None = None, host_opt=None, tensor=None):
        self.tensor_group, self.sharded = tensor if tensor is not None \
            else (None, None)
        self.plan, self.params, self.dtype = plan, params, dtype
        self.optimizer, self.group, self.device = optimizer, group, device
        self.world, self.rank = plan.world, plan.rank
        self.stage = plan.stage
        self.host_opt = host_opt
        P = plan.partition_numel
        self.master = torch.zeros(P, dtype=torch.float32,
                                  device="cpu" if host_opt is not None
                                  else device)
        self.grad = torch.zeros(P, dtype=torch.float32, device=device)
        self.full: list[torch.Tensor] = []
        self.local: list[torch.Tensor] = []
        self.live: list[bool] = []
        with torch.no_grad():
            for seg in plan.segments:
                buf = torch.zeros(seg.padded, dtype=dtype, device=device)
                for i, off, n in zip(seg.params, seg.offsets, seg.numels):
                    p = params[i]
                    flat = p.data.reshape(-1)
                    for start, length, po in plan.pieces(i):
                        self.master[po:po + length] = \
                            flat[start:start + length].float()
                    buf[off:off + n] = flat.to(dtype)
                    p.data = buf[off:off + n].view(p.shape)
                lo = self.rank * seg.chunk
                if seg.persistent:
                    self.local.append(buf[lo:lo + seg.chunk])
                else:
                    self.local.append(buf[lo:lo + seg.chunk].clone())
                self.full.append(buf)
                self.live.append(True)
        for s, seg in enumerate(plan.segments):
            if not seg.persistent:
                self._release_segment(s)
        self.index_of = {id(p): i for i, p in enumerate(params)}
        for p in params:
            p._zero_owner = weakref.ref(self)
        if host_opt is not None:
            # ZeRO-Offload: the master and the moments stay on the host
            # (runtime/zero/offload.py), NVMe-backed ones between steps
            host_opt.attach(self, self.master)
            flats = host_opt._flats
            self.master = flats.get("master")
            self.mu, self.nu = flats.get("mu"), flats.get("nu")
        else:
            st = optimizer.init([self.master])
            self.mu = st.mu[0] if st.mu is not None else None
            self.nu = st.nu[0] if st.nu is not None else None
        self.step = 0
        # stage 2-3: per-unit counts of accumulated gradients
        self._unit_params = [[i for s in segs for i in plan.segments[s].params
                              if params[i].requires_grad]
                             for segs in plan.units]
        self._count = [0] * len(plan.units)
        self._flushed = [False] * len(plan.units)
        self.in_backward = False
        self._handles = []
        if self.stage >= 2:
            for u, idx in enumerate(self._unit_params):
                for i in idx:
                    self._handles.append(
                        params[i].register_post_accumulate_grad_hook(
                            lambda p, _u=u: self._on_grad(_u)))
        if self.stage >= 3 and modules:
            for u, mod in modules.items():
                if any(not plan.segments[s].persistent
                       for s in plan.units[u]):
                    self._handles.append(mod.register_forward_pre_hook(
                        lambda m, a, _u=u: self.gather(_u)))
                    self._handles.append(mod.register_forward_hook(
                        lambda m, a, out, _u=u: self._after_forward(_u, out)))
        keys = plan.unit_keys
        self.root = keys.index(None) if None in keys else None
        self.counts = {"gathers": 0, "releases": 0, "reduce_scatters": 0}

    # ------------------------------------------------------------------
    # gathers and releases (stage 3)
    def _release_segment(self, s: int) -> None:
        self.full[s].untyped_storage().resize_(0)
        self.live[s] = False

    def gather(self, unit: int) -> None:
        """Gather ``unit``'s partitioned segments that are released."""
        for s in self.plan.units[unit]:
            if self.live[s]:
                continue
            buf = self.full[s]
            with record_function("zero.gather"):
                buf.untyped_storage().resize_(buf.numel()
                                              * buf.element_size())
                _gather_into(buf, self.local[s], self.group)
            self.live[s] = True
            self.counts["gathers"] += 1

    def release(self, unit: int) -> None:
        for s in self.plan.units[unit]:
            if not self.plan.segments[s].persistent and self.live[s]:
                self._release_segment(s)
                self.counts["releases"] += 1

    def _after_forward(self, unit: int, out):
        if self.in_backward:
            return None
        self.release(unit)
        if not torch.is_grad_enabled():
            return None
        items = out if isinstance(out, tuple) else (out,)
        idx = [k for k, x in enumerate(items)
               if isinstance(x, torch.Tensor) and x.requires_grad]
        if not idx:
            return None
        wrapped = _PreBackwardGather.apply(self, unit,
                                           *[items[k] for k in idx])
        items = list(items)
        for k, w in zip(idx, wrapped):
            items[k] = w
        return tuple(items) if isinstance(out, tuple) else items[0]

    def begin_forward(self) -> None:
        """Gather the root unit (stage 3)."""
        if self.stage >= 3 and self.root is not None:
            self.gather(self.root)

    def end_forward_no_grad(self) -> None:
        if self.stage >= 3 and self.root is not None:
            self.release(self.root)

    @contextlib.contextmanager
    def gathered(self, units=None):
        """Every partitioned segment of ``units`` (all by default) gathered
        for the block; those that were released are released after."""
        units = range(len(self.plan.units)) if units is None else units
        was = list(self.live)
        for u in units:
            self.gather(u)
        try:
            yield
        finally:
            for s, live in enumerate(was):
                if not live and self.live[s]:
                    self._release_segment(s)

    @torch.no_grad()
    def write_back(self, idx: list[int], before: list[torch.Tensor],
                   src: int) -> None:
        """``zero.GatheredParameters``'s exit with ``modifier_rank=src``:
        rank ``src``'s values of parameters ``idx`` (gathered) broadcast to
        every rank, then written into the compute chunks and, wherever a
        value changed, into the fp32 master."""
        for i, old in zip(idx, before):
            p = self.params[i]
            if self.world > 1:
                dist.broadcast(p.data, src=dist.get_global_rank(
                    self.group, src) if self.group is not None else src,
                    group=self.group)
            new = p.data.reshape(-1)
            changed = new != old.reshape(-1)
            s, _ = self.plan.where[i]
            seg = self.plan.segments[s]
            for start, ln, po in self.plan.pieces(i):
                m = self.master[po:po + ln]
                m.copy_(torch.where(changed[start:start + ln],
                                    new[start:start + ln].float(),
                                    m.to(new.device)).to(m.device))
                lo = po - seg.part_offset
                self.local[s][lo:lo + ln].copy_(new[start:start + ln])

    # ------------------------------------------------------------------
    # gradients
    def begin_accumulation(self) -> None:
        self.grad.zero_()
        self._count = [0] * len(self.plan.units)
        self._flushed = [False] * len(self.plan.units)

    def _segment_grads(self, s: int, grads, scale: float | None):
        """The fp32 flat gradient of segment ``s`` (padding zero): from
        ``grads[i]`` when given, else the parameters' ``.grad``."""
        seg = self.plan.segments[s]
        buf = torch.zeros(seg.padded, dtype=torch.float32,
                          device=self.device)
        for i, off, n in zip(seg.params, seg.offsets, seg.numels):
            g = grads[i] if grads is not None else self.params[i].grad
            if g is not None:
                buf[off:off + n] = g.reshape(-1)
        if scale is not None:
            buf.div_(scale)
        return buf

    def _scatter_add(self, s: int, buf: torch.Tensor) -> None:
        seg = self.plan.segments[s]
        out = torch.empty(seg.chunk, dtype=torch.float32, device=self.device)
        _scatter_into(out, buf, self.group)
        self.counts["reduce_scatters"] += 1
        self.grad[seg.part_offset:seg.part_offset + seg.chunk].add_(out)

    def _reduce_unit(self, unit: int) -> None:
        with record_function("zero.reduce_scatter"):
            for s in self.plan.units[unit]:
                self._scatter_add(s, self._segment_grads(s, None,
                                                         self._scale))
        for i in self._unit_params[unit]:
            self.params[i].grad = None
        self._flushed[unit] = True
        if self.stage >= 3:
            self.release(unit)

    def _on_grad(self, unit: int) -> None:
        if not self.in_backward:
            return
        self._count[unit] += 1
        if self._count[unit] == len(self._unit_params[unit]):
            self._reduce_unit(unit)

    @contextlib.contextmanager
    def backward(self, scale: float | None):
        """Around one micro-batch's backward (stages 2-3): units whose
        gradients were not all accumulated (a parameter without a
        gradient) are reduced at its end, in unit order, and the root is
        released. ``scale`` is the fp16 loss scale to divide out."""
        self._scale = scale
        self._count = [0] * len(self.plan.units)
        self._flushed = [False] * len(self.plan.units)
        self.in_backward = True
        try:
            yield
        finally:
            self.in_backward = False
        for u in range(len(self.plan.units)):
            if not self._flushed[u]:
                self._reduce_unit(u)
        if self.stage >= 3 and self.root is not None:
            self.release(self.root)

    def reduce_full(self, grads: list[torch.Tensor]) -> None:
        """Stage 1: reduce-scatter summed full fp32 gradients (one per
        parameter) into the partition."""
        with record_function("zero.reduce_scatter"):
            for s in range(len(self.plan.segments)):
                self._scatter_add(s, self._segment_grads(s, grads, None))

    # ------------------------------------------------------------------
    # the update
    def _lamb_reduce(self, pieces):
        owners = torch.tensor([i for i, _, _ in pieces], device=self.device)
        n = len(self.params)

        def reduce(w_sq, u_sq):
            tot = torch.zeros(n, 2, dtype=torch.float32, device=self.device)
            tot.index_add_(0, owners, torch.stack([w_sq, u_sq], dim=1))
            dist.all_reduce(tot, group=self.group)
            if self.tensor_group is not None:
                sharded = torch.tensor(self.sharded, device=self.device)
                both = tot * sharded[:, None]
                dist.all_reduce(both, group=self.tensor_group)
                tot = torch.where(sharded[:, None], both, tot)
            return tot[owners, 0], tot[owners, 1]

        return reduce

    def update(self, lr: float) -> None:
        """The optimizer on this rank's partition, then the compute
        parameters recast from it (gathered for persistent segments). With
        a host optimizer (ZeRO-Offload) the host walks the partition and
        copies the new compute chunks in."""
        if self.host_opt is not None:
            self.host_opt.step(self, lr)
            self.step = self.host_opt.step_count
            if self.world > 1:
                self.regather_persistent()
            return
        opt = self.optimizer
        if opt.elementwise:
            view = lambda t: None if t is None else self._segments(t)
            st = OptState(self.step, view(self.mu), view(self.nu))
            st = opt.update(view(self.grad), st, view(self.master), lr=lr)
        else:
            pieces = [(i, po, ln) for i in range(len(self.params))
                      for _, ln, po in self.plan.pieces(i)]
            view = lambda t: [t[po:po + ln] for _, po, ln in pieces]
            st = OptState(self.step, view(self.mu), view(self.nu))
            st = opt.update(view(self.grad), st, view(self.master), lr=lr,
                            sq_norm_reduce=self._lamb_reduce(pieces))
        self.step = st.step
        self.refresh_params()

    @torch.no_grad()
    def refresh_params(self) -> None:
        """Every segment's compute chunk from the master; persistent
        segments gathered."""
        with record_function("zero.all_gather"):
            for s, seg in enumerate(self.plan.segments):
                chunk = self.master[seg.part_offset:seg.part_offset
                                    + seg.chunk]
                if seg.persistent:
                    _gather_into(self.full[s], chunk.to(self.dtype),
                                 self.group)
                else:
                    self.local[s].copy_(chunk)

    @torch.no_grad()
    def regather_persistent(self) -> None:
        """Persistent segments gathered from their local chunks (after a
        checkpoint loaded the chunks)."""
        for s, seg in enumerate(self.plan.segments):
            if seg.persistent:
                _gather_into(self.full[s], self.local[s].clone(), self.group)

    def _segments(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """``flat`` (partition-shaped) as one view per segment chunk: an
        elementwise op over it keeps its full-size temporaries one segment
        at a time (over the whole partition at once they took 13 GB at the
        8-layer train spec)."""
        return [flat[seg.part_offset:seg.part_offset + seg.chunk]
                for seg in self.plan.segments]

    # ------------------------------------------------------------------
    # reductions over the group
    def grad_sq_norm(self) -> torch.Tensor:
        if self.tensor_group is None:
            sq = torch.stack([torch.sum(torch.square(g))
                              for g in self._segments(self.grad)]).sum()
            dist.all_reduce(sq, group=self.group)
            return sq
        # (sharded, replicated) squares of the partition, piece by piece
        parts = [[], []]
        for i in range(len(self.params)):
            for _, ln, po in self.plan.pieces(i):
                parts[not self.sharded[i]].append(
                    torch.sum(torch.square(self.grad[po:po + ln])))
        zero = torch.zeros((), device=self.device)
        sq = torch.stack([torch.stack(p).sum() if p else zero
                          for p in parts])
        dist.all_reduce(sq, group=self.group)
        sharded = sq[0].clone()
        dist.all_reduce(sharded, group=self.tensor_group)
        return sharded + sq[1]

    def grads_finite(self) -> torch.Tensor:
        ok = torch.stack([torch.isfinite(g).all()
                          for g in self._segments(self.grad)]).all()
        ok = ok.to(torch.int32)
        dist.all_reduce(ok, op=dist.ReduceOp.MIN, group=self.group)
        return ok.bool()

    def gather_compute(self, s: int) -> torch.Tensor:
        """Segment ``s``'s compute values, gathered into a new buffer."""
        buf = torch.empty(self.plan.segments[s].padded, dtype=self.dtype,
                          device=self.device)
        _gather_into(buf, self.local[s].contiguous(), self.group)
        return buf

    def full_segments(self, flat: torch.Tensor) -> list[torch.Tensor]:
        out = []
        for seg in self.plan.segments:
            buf = torch.empty(seg.padded, dtype=flat.dtype,
                              device=self.device)
            _gather_into(buf, flat[seg.part_offset:seg.part_offset
                                   + seg.chunk].to(self.device).contiguous(),
                         self.group)
            out.append(buf)
        return out

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
        if self.host_opt is not None:
            self.host_opt.close()
        self.full = self.local = []
        self.master = self.grad = self.mu = self.nu = None
