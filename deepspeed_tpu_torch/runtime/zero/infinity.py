"""ZeRO-Infinity parameter offload: host-resident parameters, streamed a
layer at a time.

Counterpart of ``deepspeed_tpu/runtime/zero/infinity.py``
(``LayerStreamTrainer``, ``NVMeParamPlaceholder``; reference
``runtime/swap_tensor/partitioned_param_swapper.py:37``,
``runtime/zero/stage3.py:1910``). The model's parameters never live on the
card as a whole:

- the fp32 master and the moments live in the host optimizer
  (:class:`~.offload.HostOffloadOptimizer`, one state per parameter); a
  compute-dtype cache of every parameter lives in pinned host memory, or on
  NVMe (``offload_param.device == "nvme"``), where the module's parameters
  hold no storage between uses and :meth:`LayerStreamTrainer.params_view`
  hands out :class:`NVMeParamPlaceholder` leaves that raise on any value
  access;
- the model runs group by group (``pre``: the embeddings; ``layer_i``;
  ``head``: the final norm and the unembedding, with the embedding table
  when it is tied). A group is staged host → device on a copy stream
  ``buffer_count`` groups ahead of its use, its parameters' ``.data``
  pointed at the staged tensors while it runs, and released after;
- NVMe reads run one window ahead of the staging: while group i computes
  with groups [i, i+k) staged, the reads for [i+k, i+2k) are in flight on
  the async-I/O engine (hits and misses counted, as are the staging's);
- the forward walk keeps only each block's input. The backward walk
  stages each block again, recomputes it with gradients and backpropagates
  through it (K4's forward and backward launch as under remat "full");
  each layer's gradients start a non-blocking device-to-host copy into
  pinned memory and are added into the fp32 host sums only once they are
  ``buffer_count`` layers old, so the host never waits on a copy the next
  layer's backward could hide;
- :meth:`LayerStreamTrainer.apply_grads` scales, clips and steps the host
  optimizer group by group, then refreshes the compute cache.

Blocks run as the JAX walk runs them: in eval mode (``deterministic=True``:
no dropout, MoE routing at its eval capacity), their MoE losses added to
the loss. At data parallelism above 1 each layer's gradients are averaged
over the group before their copy to the host, as XLA does inside the JAX
layer program; the loss's labelled-token count is the group's
(``comm.data_parallel_scope``, opened by the engine). ``peak_staged_bytes``
counts staged parameters, ``peak_hbm_bytes`` adds the gradients riding the
copy queue.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ...models.loss import cross_entropy_lm, shift_labels
from ...utils.logging import logger
from ...utils.naming import safe_filename


class NVMeParamPlaceholder:
    """Stands in for a parameter whose bytes live on NVMe in
    :meth:`LayerStreamTrainer.params_view`. It carries the true shape and
    dtype, but any value access raises instead of reading zeros: fetch the
    values through ``host_params_tree()`` (the checkpoint path does)."""

    __slots__ = ("shape", "dtype", "_key")

    def __init__(self, shape, dtype: torch.dtype, key: str):
        self.shape = tuple(shape)
        self.dtype = dtype
        self._key = key

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def nbytes(self) -> int:
        return self.size * torch.empty(0, dtype=self.dtype).element_size()

    def _raise(self, *a, **k):
        raise RuntimeError(
            f"parameter '{self._key}' is NVMe-resident (offload_param."
            f"device='nvme'): params_view() carries shape/dtype "
            f"placeholders only. Read values through "
            f"engine._param_stream.host_params_tree() — note it loads the "
            f"FULL model into host RAM.")

    __array__ = _raise
    __getitem__ = _raise
    __iter__ = _raise
    __float__ = _raise
    __int__ = _raise
    __bool__ = _raise
    __add__ = __radd__ = __mul__ = __rmul__ = _raise
    __sub__ = __rsub__ = __truediv__ = __rtruediv__ = _raise
    __matmul__ = __rmatmul__ = _raise

    def __repr__(self):
        return (f"NVMeParamPlaceholder(key={self._key!r}, "
                f"shape={self.shape}, dtype={self.dtype})")


def group_of(name: str) -> str:
    top = name.split(".", 1)[0]
    if top.startswith("layer_"):
        return top
    if top in ("ln_final", "unembed", "unembed_b"):
        return "head"
    return "pre"          # embed / pos_embed / ln_embed


class LayerStreamTrainer:
    """Trains a ``TransformerLM`` whose parameters live on the host."""

    def __init__(self, model, config, host_opt, compute_dtype: torch.dtype,
                 device: torch.device, dp_group=None, dp_world: int = 1):
        self.model = model
        self.mcfg = m = model.config
        self.host_opt = host_opt
        self.dtype = compute_dtype
        self.device = device
        self.dp_group, self.dp_world = dp_group, dp_world
        if getattr(m, "dropout", 0):
            logger.warning("offload_param path runs deterministic — dropout "
                           "is disabled on the streamed layer walk")
        if not m.causal:
            raise ValueError("offload_param streaming supports causal LMs "
                             "(TransformerLM) only")
        poff = config.zero_optimization.offload_param
        self.lookahead = max(1, int(getattr(poff, "buffer_count", 4)))
        self.nvme = poff.device == "nvme"
        self.aio = host_opt.aio if self.nvme else None
        self.nvme_dir = host_opt.nvme_dir if self.nvme else None
        self.cuda = device.type == "cuda"
        self.params = dict(model.named_parameters())
        self.groups = (["pre"] + [f"layer_{i}" for i in range(m.num_layers)]
                       + ["head"])
        self.members: dict[str, list[str]] = {g: [] for g in self.groups}
        for name in self.params:
            self.members[group_of(name)].append(name)
        if m.tie_embeddings:
            self.members["head"].append("embed")   # the head reads it too
        self.shapes = {n: tuple(p.shape) for n, p in self.params.items()}
        self.cache: dict[str, torch.Tensor] = {}
        self.total_param_bytes = 0
        self.peak_staged_bytes = 0
        self.peak_hbm_bytes = 0
        self._staged: dict[str, tuple[dict, object, int]] = {}
        self._live_bytes = 0
        self._grad_live_bytes = 0
        self._grad_acc: dict[str, torch.Tensor] = {}
        self._grad_pending: list[tuple] = []
        self._inflight: dict[str, tuple] = {}
        self.nvme_prefetch_hits = 0
        self.nvme_prefetch_misses = 0
        #: uses of a group its lookahead had staged already / had not
        self.stage_hits = 0
        self.stage_misses = 0
        if self.cuda:
            self._h2d = torch.cuda.Stream(device)
            self._d2h = torch.cuda.Stream(device)

    # ------------------------------------------------------------------
    # host state
    def _host_tensor(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype, pin_memory=self.cuda)

    def init_from_master(self, masters: dict[str, torch.Tensor]) -> None:
        """Build the compute cache from fp32 host values by name (the host
        optimizer takes the masters themselves from the engine)."""
        if self.nvme:
            self._drain_inflight()
        with torch.no_grad():
            for name, m in masters.items():
                t = self._host_tensor(self.shapes[name], self.dtype)
                t.copy_(m.reshape(self.shapes[name]))
                self.cache[name] = t
        self.total_param_bytes = sum(t.numel() * t.element_size()
                                     for t in self.cache.values())
        for name, p in self.params.items():
            p.requires_grad_(True)
            p.grad = None
        if self.nvme:
            reqs = [self.aio.async_pwrite(t, self._param_path(n))
                    for n, t in self.cache.items()]
            for r in reqs:
                self.aio.wait(r)
            self.cache = {}
        self._park_all()
        logger.info(
            f"ZeRO-Infinity param offload: {len(self.groups)} groups, "
            f"{self.total_param_bytes / 1e6:.0f} MB of parameters on the host "
            f"({'nvme' if self.nvme else 'cpu'}), lookahead={self.lookahead}")

    def _park(self, name: str) -> None:
        """Point a parameter back at its host value (in NVMe mode a tensor
        of its shape whose storage holds nothing)."""
        p = self.params[name]
        if not self.nvme:
            p.data = self.cache[name]
            return
        t = torch.empty(self.shapes[name], dtype=self.dtype)
        t.untyped_storage().resize_(0)
        p.data = t

    def _park_all(self) -> None:
        for name in self.params:
            self._park(name)

    def _param_path(self, name: str) -> str:
        return os.path.join(self.nvme_dir, f"param.{safe_filename(name)}.bin")

    def _disk_members(self, g: str) -> list[str]:
        """A group's parameters as stored: the tied embedding rides with
        ``pre``."""
        if self.mcfg.tie_embeddings and g == "head":
            return [n for n in self.members[g] if n != "embed"]
        return self.members[g]

    def _issue_fetch(self, g: str) -> list:
        out = []
        for name in self._disk_members(g):
            buf = self._host_tensor(self.shapes[name], self.dtype)
            out.append((name, buf, self.aio.async_pread(
                buf, self._param_path(name))))
        return out

    def _prefetch_host(self, g: str) -> None:
        """Start ``g``'s NVMe reads ahead of its staging (no-op in cpu mode,
        or when it is staged or in flight)."""
        if not self.nvme or g in self._staged or g in self._inflight:
            return
        if self.mcfg.tie_embeddings and g == "head":
            self._prefetch_host("pre")
        self._inflight[g] = self._issue_fetch(g)

    def _fetch_group(self, g: str) -> dict:
        inflight = self._inflight.pop(g, None)
        if inflight is not None:
            self.nvme_prefetch_hits += 1
        else:
            self.nvme_prefetch_misses += 1
            inflight = self._issue_fetch(g)
        out = {}
        for name, buf, req in inflight:
            self.aio.wait(req)
            out[name] = buf
        if self.mcfg.tie_embeddings and g == "head":
            out["embed"] = self._host_group("pre")["embed"]
        return out

    def _drain_inflight(self) -> None:
        """Complete outstanding reads: nothing may rewrite a file a read is
        still filling."""
        for g in list(self._inflight):
            for _, _, req in self._inflight.pop(g):
                self.aio.wait(req)

    def _host_group(self, g: str) -> dict:
        if self.nvme:
            return self._fetch_group(g)
        return {n: self.cache[n] for n in self.members[g]}

    # ------------------------------------------------------------------
    # staging
    def _stage(self, g: str) -> None:
        if g in self._staged:
            return
        host = self._host_group(g)
        ev = None
        if self.cuda:
            with torch.cuda.stream(self._h2d):
                dev = {n: t.to(self.device, non_blocking=True)
                       for n, t in host.items()}
                ev = torch.cuda.Event()
                ev.record(self._h2d)
        else:
            dev = {n: t.clone() for n, t in host.items()}
        nbytes = sum(t.numel() * t.element_size() for t in dev.values())
        self._staged[g] = (dev, ev, nbytes)
        self._live_bytes += nbytes
        self.peak_staged_bytes = max(self.peak_staged_bytes, self._live_bytes)
        self.peak_hbm_bytes = max(self.peak_hbm_bytes,
                                  self._live_bytes + self._grad_live_bytes)

    def _use(self, g: str) -> None:
        """Point ``g``'s parameters at its staged tensors; the compute
        stream waits for their copy."""
        if g in self._staged:
            self.stage_hits += 1
        else:
            self.stage_misses += 1
        self._stage(g)
        dev, ev, _ = self._staged[g]
        if self.cuda and ev is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(ev)
            for t in dev.values():
                t.record_stream(cur)
            self._staged[g] = (dev, None, self._staged[g][2])
        for name, t in dev.items():
            self.params[name].data = t

    def _release(self, g: str) -> None:
        if g in self._staged:
            _, _, nbytes = self._staged.pop(g)
            self._live_bytes -= nbytes
            for name in self.members[g]:
                self._park(name)

    # ------------------------------------------------------------------
    # the groups' computations
    def _pre(self, ids, positions):
        m, dt, P = self.mcfg, self.dtype, self.params
        x = P["embed"].to(dt)[ids]
        if m.position_embedding == "learned":
            x = x + P["pos_embed"].to(dt)[positions]
        if m.embed_norm:
            x = self.model.ln_embed(x)
        return x

    def _head(self, x, labels):
        m, dt, P = self.mcfg, self.dtype, self.params
        x = self.model.ln_final(x)
        if m.tie_embeddings:
            logits = torch.einsum("bse,ve->bsv", x, P["embed"].to(dt))
        else:
            logits = x @ P["unembed"].to(dt)
        if m.unembed_bias:
            logits = logits + P["unembed_b"].to(dt)
        return cross_entropy_lm(logits, labels)

    # ------------------------------------------------------------------
    # gradient plumbing
    def _grads_of(self, g: str) -> dict:
        out = {}
        for name in self.members[g]:
            p = self.params[name]
            if p.grad is not None:
                gr = p.grad
                if self.dp_world > 1:
                    torch.distributed.all_reduce(gr, group=self.dp_group)
                    gr.div_(self.dp_world)
                out[name] = gr
            p.grad = None
        return out

    def _enqueue_grads(self, grads: dict) -> None:
        """Start the non-blocking device-to-host copy of a group's
        gradients into pinned buffers, which :meth:`_drain_grads` adds in
        once the copy's event is ``buffer_count`` groups old. The device
        tensors are marked as used by the copy stream, so their memory is
        reused only after the copy (``peak_hbm_bytes`` still counts them
        until the drain: an upper bound)."""
        nbytes = sum(t.numel() * t.element_size() for t in grads.values())
        ev = None
        if self.cuda:
            self._d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(self._d2h):
                host = {}
                for n, t in grads.items():
                    host[n] = self._host_tensor(t.shape, t.dtype)
                    host[n].copy_(t, non_blocking=True)
                    t.record_stream(self._d2h)
                ev = torch.cuda.Event()
                ev.record(self._d2h)
        else:
            host = grads
        self._grad_pending.append((host, ev, nbytes))
        self._grad_live_bytes += nbytes
        self.peak_hbm_bytes = max(self.peak_hbm_bytes,
                                  self._live_bytes + self._grad_live_bytes)

    def _drain_grads(self, keep: int = 0) -> None:
        while len(self._grad_pending) > keep:
            host, ev, nbytes = self._grad_pending.pop(0)
            if ev is not None:
                ev.synchronize()
            for name, h in host.items():
                g = h.reshape(-1).to(torch.float32, copy=True)
                if name in self._grad_acc:
                    self._grad_acc[name].add_(g)
                else:
                    self._grad_acc[name] = g
            self._grad_live_bytes -= nbytes

    # ------------------------------------------------------------------
    def _prepare_micro(self, mb: dict):
        if "token_type_ids" in mb:
            raise NotImplementedError(
                "offload_param streaming does not plumb token_type_ids")
        ids = mb["input_ids"].to(self.device)
        labels = mb.get("labels")
        labels = shift_labels(ids) if labels is None else \
            labels.to(self.device)
        B, S = ids.shape
        positions = torch.arange(S, device=self.device).expand(B, S)
        return ids, labels, positions

    @torch.no_grad()
    def micro_forward(self, mb: dict, keep_activations: bool = False):
        """Streamed forward: ``(loss, None, inputs)``, or with
        ``keep_activations`` ``(aux_total, block inputs, inputs)`` with the
        head staged."""
        self.model.eval()
        L = self.mcfg.num_layers
        k = self.lookahead
        ids, labels, positions = self._prepare_micro(mb)
        self._prefetch_host("pre")
        for j in range(min(2 * k, L)):
            self._prefetch_host(f"layer_{j}")
        self._stage("pre")
        for j in range(min(k, L)):
            self._stage(f"layer_{j}")
        self._use("pre")
        x = self._pre(ids, positions)
        self._release("pre")
        xs = [x] if keep_activations else None
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for i in range(L):
            self._use(f"layer_{i}")
            x, aux = getattr(self.model, f"layer_{i}")(x, positions, None)
            if aux is not None:
                aux_total = aux_total + aux
            if keep_activations:
                xs.append(x)
            self._release(f"layer_{i}")
            pf = i + 2 * k
            self._prefetch_host(f"layer_{pf}" if pf < L else "head")
            if i + k < L:
                self._stage(f"layer_{i + k}")
        self._stage("head")
        if keep_activations:
            return aux_total, xs, (ids, labels, positions)
        self._use("head")
        loss = self._head(x, labels)
        self._release("head")
        return loss + aux_total, None, (ids, labels, positions)

    def micro_fwd_bwd(self, mb: dict) -> torch.Tensor:
        """One micro-batch: the streamed forward, then the streamed
        backward with the gradients queued to the host."""
        L = self.mcfg.num_layers
        k = self.lookahead
        aux_total, xs, (ids, labels, positions) = self.micro_forward(
            mb, keep_activations=True)
        self._use("head")
        xl = xs[L].detach().requires_grad_(True)
        with torch.enable_grad():
            loss = self._head(xl, labels)
            loss.backward()
        dx = xl.grad
        self._enqueue_grads(self._grads_of("head"))
        self._release("head")
        xs[L] = None
        for j in range(min(2 * k, L)):
            self._prefetch_host(f"layer_{L - 1 - j}")
        for i in reversed(range(L)):
            g = f"layer_{i}"
            self._stage(g)
            for j in range(1, k):
                if i - j >= 0:
                    self._stage(f"layer_{i - j}")
            pf = i - 2 * k
            self._prefetch_host(f"layer_{pf}" if pf >= 0 else "pre")
            self._use(g)
            x = xs[i].detach().requires_grad_(True)
            with torch.enable_grad():
                y, aux = getattr(self.model, f"layer_{i}")(x, positions,
                                                           None)
                outs, cots = [y], [dx]
                if aux is not None:
                    outs.append(aux)
                    cots.append(torch.ones_like(aux))
                torch.autograd.backward(outs, cots)
            dx = x.grad
            self._enqueue_grads(self._grads_of(g))
            self._release(g)
            xs[i + 1] = None
            self._drain_grads(keep=k)
        self._use("pre")
        with torch.enable_grad():
            x0 = self._pre(ids, positions)
            x0.backward(dx)
        self._enqueue_grads(self._grads_of("pre"))
        self._release("pre")
        self._drain_grads(keep=0)
        return loss.detach() + aux_total

    # ------------------------------------------------------------------
    def apply_grads(self, gas: int, lr: float, clip: float | None) -> None:
        """The accumulation boundary: scale by 1/gas, clip by the global
        norm, the host step group by group, and the cache refreshed."""
        self._drain_grads(keep=0)
        if self.cuda:
            self._h2d.synchronize()       # no staging copy reads the cache
        self._drain_inflight()
        inv = 1.0 / gas
        for g in self._grad_acc.values():
            g.mul_(inv)
        if clip:
            sq = sum(float(torch.sum(g * g)) for g in self._grad_acc.values())
            scale = min(1.0, clip / (float(np.sqrt(sq)) + 1e-6))
            if scale < 1.0:
                for g in self._grad_acc.values():
                    g.mul_(scale)
        first = True
        for grp in self.groups:
            keys = [n for n in self._disk_members(grp) if n in self._grad_acc]
            if not keys:
                continue
            new = self.host_opt.step_keys(
                {n: self._grad_acc[n] for n in keys}, lr, bump_step=first)
            first = False
            self._refresh(new)
        self._grad_acc.clear()

    @torch.no_grad()
    def _refresh(self, masters: dict[str, torch.Tensor]) -> None:
        if not self.nvme:
            for name, m in masters.items():
                self.cache[name].copy_(m.view(self.shapes[name]))
            return
        reqs, keep = [], []
        for name, m in masters.items():
            buf = m.view(self.shapes[name]).to(self.dtype)
            keep.append(buf)
            reqs.append(self.aio.async_pwrite(buf, self._param_path(name)))
        for r in reqs:
            self.aio.wait(r)

    # ------------------------------------------------------------------
    def host_params_tree(self) -> dict[str, torch.Tensor]:
        """Every parameter's compute-dtype value on the host, by name (NVMe
        mode reads the whole model from disk)."""
        if not self.nvme:
            return dict(self.cache)
        out = {}
        for g in self.groups:
            for name, t in self._fetch_group(g).items():
                out.setdefault(name, t)
        return out

    def params_view(self) -> dict:
        """The parameters as a JAX-layout nested dict: the live host cache
        (cpu mode) or :class:`NVMeParamPlaceholder` leaves (NVMe)."""
        out: dict = {}
        for name in self.params:
            node = out
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = self.cache[name] if not self.nvme else \
                NVMeParamPlaceholder(self.shapes[name], self.dtype, name)
        return out

    @contextlib.contextmanager
    def materialized(self, engine, changed: bool = False):
        """The engine's per-parameter views for a checkpoint: the module's
        parameters on their host values, ``engine._master`` and
        ``engine.opt_state`` over the host optimizer's state. ``changed``
        (a load): the host optimizer, the cache and NVMe take the values
        back after."""
        from ...ops.optimizers import OptState

        ho = self.host_opt
        leaves = {n: ho.leaf(n) for n in engine._names}
        if self.nvme:
            host = self.host_params_tree()
            for n, p in self.params.items():
                p.data = host[n]
        engine._master = [leaves[n].master.view(self.shapes[n])
                          for n in engine._names]
        engine.opt_state = OptState(
            step=ho.step_count,
            mu=[leaves[n].mu.view(self.shapes[n]) for n in engine._names]
            if "mu" in ho.slots else None,
            nu=[leaves[n].nu.view(self.shapes[n]) for n in engine._names]
            if "nu" in ho.slots else None)
        try:
            yield
        finally:
            if changed:
                with torch.no_grad():
                    for n, p in self.params.items():
                        if not engine.mixed_precision:
                            leaves[n].master.copy_(p.data.reshape(-1))
                        ho.load_leaf(n, leaves[n])
                    if self.nvme:
                        self._refresh({n: p.data.float().reshape(-1)
                                       for n, p in self.params.items()})
            engine._master = None
            engine.opt_state = None
            self._park_all()
