"""ZeRO-Offload / ZeRO-Infinity host optimizer.

Counterpart of ``deepspeed_tpu/runtime/zero/offload.py``
(``HostOffloadOptimizer``; reference
``runtime/zero/stage_1_and_2.py:1190`` with ``cpu_adam`` and
``runtime/swap_tensor/partitioned_optimizer_swapper.py``):

- ``device="cpu"``: the fp32 master and the moments live in host memory,
  ordinary (pageable) tensors; the host library's SIMD step updates them
  (``ops/cpu_optimizer.py``) and only compute-dtype parameters go back to
  the card;
- ``device="nvme"``: the state also lives in files under
  ``nvme_path/pid<pid>``, read ``buffer_count`` pieces ahead of the walk
  and written back asynchronously through the async-I/O engine
  (``ops/aio.py``); between steps no host buffer holds it;
- Twin-Flow (``ratio`` < 1, reference blogs/deepspeed-offloadpp): a
  ``1 - ratio`` share of the state, chosen leaf by leaf in the JAX
  package's key order under the same element budget, stays on the card and
  updates with the port's ``FusedAdam`` while the host walks its share.

Two callers. The engine's ZeRO runtime (``runtime/zero/partition.py``)
offloads its flat fp32 partition: :meth:`attach` lays the host state over
the partition (one run per segment, Twin-Flow's device pieces cut out),
and :meth:`step` walks it in tiles of at most ``tile`` elements through a
ring of **pinned** staging buffers — the device-to-host copy of tile t+1's
fp32 gradients overlaps the host step of tile t; the library casts the
updated master to bf16 into a pinned buffer whose host-to-device copy, on
a stream of its own, overlaps the next tile's step. A host read of a
staging buffer waits on the event of the copy that fills it, and a
buffer is refilled only after the event of the copy that drained it.
With ZeRO stages 1-3 each rank's host state is its own partition; Adam is
elementwise, so the bits do not depend on how the state is partitioned.
The layer streamer (``runtime/zero/infinity.py``) keeps a state per
parameter (:meth:`init_leaves`, :meth:`step_keys`).

:attr:`last_step` holds the host step's split (seconds, bytes, the copies'
device time by CUDA events and the share of it hidden behind host work);
``io_read_bytes`` / ``io_written_bytes`` count the NVMe traffic.
"""
from __future__ import annotations

import contextlib
import os
import time

import torch

from ...ops.aio import AsyncIOHandle
from ...ops.cpu_optimizer import HostOptState, build_cpu_optimizer, f32_to_bf16
from ...utils.logging import logger
from ...utils.naming import safe_filename

#: elements a staging tile holds (128 MB of fp32 gradients)
TILE = 1 << 25
#: staging buffers in each ring
RING = 3


def jax_key(name: str) -> tuple[str, ...]:
    """A parameter's position in the JAX package's leaf order (flax trees
    flatten with sorted keys at every level)."""
    return tuple(name.split("."))


def device_share(names: list[str], numels: list[int], ratio: float
                 ) -> set[int]:
    """Twin-Flow's device leaves: greedily, in the JAX key order, every
    leaf that still fits a ``(1 - ratio)`` share of all elements
    (``offload.py:81-91`` of the JAX package)."""
    total = sum(numels)
    budget = (1.0 - ratio) * total
    used, out = 0, set()
    for i in sorted(range(len(names)), key=lambda i: jax_key(names[i])):
        if used + numels[i] <= budget:
            used += numels[i]
            out.add(i)
    return out


class HostOffloadOptimizer:
    def __init__(self, opt_type: str, opt_params: dict, offload_cfg,
                 compute_dtype: torch.dtype, device: torch.device):
        self.cpu_opt = build_cpu_optimizer(opt_type, opt_params)
        self.opt_spec = (opt_type, opt_params)
        self.device_kind = offload_cfg.device            # "cpu" | "nvme"
        self.compute_dtype = compute_dtype
        self.device = device
        self.tile = TILE
        self.ratio = float(getattr(offload_cfg, "ratio", 1.0))
        if not (0.0 <= self.ratio <= 1.0):
            raise ValueError(f"offload ratio must be in [0, 1], got "
                             f"{self.ratio}")
        self.lookahead = max(1, int(getattr(offload_cfg, "buffer_count", 4)))
        self.step_count = 0
        self.state: dict[str, HostOptState] = {}
        self.aio: AsyncIOHandle | None = None
        self.nvme_dir: str | None = None
        if self.device_kind == "nvme":
            base = offload_cfg.nvme_path or os.path.join(
                os.path.expanduser("~"), ".cache", "deepspeed_tpu_torch",
                "nvme_swap")
            self.nvme_dir = os.path.join(base, f"pid{os.getpid()}")
            os.makedirs(self.nvme_dir, exist_ok=True)
            self.aio = AsyncIOHandle()
        self.io_read_bytes = 0
        self.io_written_bytes = 0
        self.last_step: dict = {}
        #: test hook: GPU cycles each staging copy's stream sleeps before
        #: the copy (a deliberately late stream must not change a bit)
        self.delay_copies = 0
        # partition mode
        self._runs: list[tuple[str, int, int, int]] = []  # key, seg, lo, n
        self._flats: dict[str, torch.Tensor] = {}
        self._dev_pieces: list[tuple[int, int, int]] = []  # seg, po, n
        self._dev_master: list[torch.Tensor] = []
        self._dev_opt = None
        self._dev_state = None
        self._rings = None
        self._streams = None

    @property
    def nvme(self) -> bool:
        return self.device_kind == "nvme"

    @property
    def slots(self) -> tuple[str, ...]:
        return ("master",) + tuple(self.cpu_opt.SLOTS)

    # ------------------------------------------------------------------
    # NVMe staging
    def _path(self, key: str, slot: str) -> str:
        return os.path.join(self.nvme_dir, f"{safe_filename(key)}.{slot}.bin")

    def swap_files(self) -> list[str]:
        return sorted(os.listdir(self.nvme_dir)) if self.nvme_dir else []

    def _spill(self, key: str, st: HostOptState) -> None:
        reqs = []
        self._write_back(key, st, reqs)
        for r in reqs:
            self.aio.wait(r)

    def _issue_fetch(self, key: str) -> dict:
        n = self.state[key].numel
        out = {}
        for slot in self.slots:
            buf = torch.empty(n, dtype=torch.float32)
            out[slot] = (buf, self.aio.async_pread(buf, self._path(key, slot)))
            self.io_read_bytes += n * 4
        return out

    def _absorb_fetch(self, key: str, bufs: dict) -> HostOptState:
        st = self.state[key]
        for slot, (buf, req) in bufs.items():
            self.aio.wait(req)
            setattr(st, slot, buf)
        return st

    def _write_back(self, key: str, st: HostOptState, reqs: list) -> None:
        """Start writing ``st``'s buffers to their files (the requests keep
        them alive) and drop the state's references."""
        for slot, buf in st.buffers().items():
            reqs.append(self.aio.async_pwrite(buf, self._path(key, slot)))
            self.io_written_bytes += buf.numel() * 4
        st.drop_buffers()

    # ------------------------------------------------------------------
    # per-parameter state (the layer streamer)
    def init_leaves(self, masters: dict[str, torch.Tensor]) -> None:
        """Take flat fp32 host masters by key (the streamer's parameter
        names); moments start at zero; NVMe spills each."""
        for key, m in masters.items():
            st = self.cpu_opt.init_state(m.detach().reshape(-1).float()
                                         .contiguous())
            self.state[key] = st
            if self.nvme:
                self._spill(key, st)

    def step_keys(self, grads: dict[str, torch.Tensor], lr: float,
                  bump_step: bool = True) -> dict[str, torch.Tensor]:
        """The host step over the leaves in ``grads`` (flat fp32 host
        tensors); returns their flat fp32 masters, valid until the next
        call. NVMe reads run ``buffer_count`` leaves ahead."""
        if bump_step:
            self.step_count += 1
        keys = list(grads)
        missing = [k for k in keys if k not in self.state]
        if missing:
            raise KeyError(f"offload state missing for {missing[:3]}...")
        inflight = {}
        if self.nvme:
            for k in keys[:self.lookahead]:
                inflight[k] = self._issue_fetch(k)
        out, writes = {}, []
        for i, key in enumerate(keys):
            st = self.state[key]
            if self.nvme:
                st = self._absorb_fetch(key, inflight.pop(key))
                if i + self.lookahead < len(keys):
                    nxt = keys[i + self.lookahead]
                    inflight[nxt] = self._issue_fetch(nxt)
            self.cpu_opt.step(st, grads[key].reshape(-1), self.step_count,
                              lr=lr)
            out[key] = st.master
            if self.nvme:
                self._write_back(key, st, writes)
        for r in writes:
            self.aio.wait(r)
        return out

    def leaf(self, key: str) -> HostOptState:
        """A leaf's state with its buffers in host memory (read from NVMe
        into fresh buffers, which the state does not keep)."""
        st = self.state[key]
        if self.nvme:
            st = HostOptState(master=None, numel=st.numel)
            for slot in self.slots:
                buf = torch.empty(st.numel, dtype=torch.float32)
                self.aio.sync_pread(buf, self._path(key, slot))
                self.io_read_bytes += buf.numel() * 4
                setattr(st, slot, buf)
        return st

    def load_leaf(self, key: str, st: HostOptState) -> None:
        """Replace a leaf's state (a checkpoint load); NVMe spills it."""
        self.state[key] = st
        if self.nvme:
            self._spill(key, st)

    # ------------------------------------------------------------------
    # the ZeRO runtime's flat partition
    def attach(self, zero, master: torch.Tensor) -> None:
        """Lay the host state over ``zero``'s partition. ``master`` is the
        partition's fp32 master on the host, taken as is in cpu mode and
        spilled run by run (then dropped) in NVMe mode."""
        plan = zero.plan
        dev_leaves = set()
        if self.ratio < 1.0:
            dev_leaves = device_share(
                plan.names, [p.numel() for p in zero.params], self.ratio)
        cut: dict[int, list[tuple[int, int]]] = {}
        for i in sorted(dev_leaves):
            for _, ln, po in plan.pieces(i):
                s, _ = plan.where[i]
                self._dev_pieces.append((s, po, ln))
                cut.setdefault(s, []).append((po, ln))
        for s, seg in enumerate(plan.segments):
            lo, hi = seg.part_offset, seg.part_offset + seg.chunk
            for po, ln in sorted(cut.get(s, [])) + [(hi, 0)]:
                if po > lo:
                    self._runs.append((f"s{s}.{lo}", s, lo, po - lo))
                lo = max(lo, po + ln)
        if not self.nvme:
            self._flats["master"] = master
            for slot in self.cpu_opt.SLOTS:
                self._flats[slot] = torch.zeros_like(master)
        for key, _, lo, n in self._runs:
            st = HostOptState(master=master[lo:lo + n], numel=n)
            for slot in self.cpu_opt.SLOTS:
                setattr(st, slot, self._flats[slot][lo:lo + n]
                        if not self.nvme else torch.zeros(n))
            self.state[key] = st
            if self.nvme:
                self._spill(key, st)
        if self._dev_pieces:
            from ...ops.optimizers import build_optimizer

            self._dev_master = [master[po:po + n].to(self.device)
                                for _, po, n in self._dev_pieces]
            self._dev_opt = build_optimizer(*self.opt_spec)
            self._dev_state = self._dev_opt.init(self._dev_master)
            n_dev = sum(n for _, _, n in self._dev_pieces)
            logger.info(f"Twin-Flow: {len(dev_leaves)} leaves "
                        f"({n_dev / max(plan.partition_numel, 1):.0%} of the "
                        f"partition) update on the device, "
                        f"{len(self._runs)} runs on the host")

    def host_elements(self) -> int:
        return sum(n for _, _, _, n in self._runs)

    def device_elements(self) -> int:
        return sum(n for _, _, n in self._dev_pieces)

    def _tiles(self):
        for key, s, lo, n in self._runs:
            for a in range(0, n, self.tile):
                yield key, s, lo, a, min(self.tile, n - a)

    def _staging(self):
        """Two rings of pinned buffers (fp32 gradients, compute-dtype
        parameters) and the two copy streams, made at the first step."""
        if self._rings is None:
            n = min(self.tile, max((n for *_, n in self._runs), default=1))
            pin = self.device.type == "cuda"
            self._rings = (
                [torch.empty(n, dtype=torch.float32, pin_memory=pin)
                 for _ in range(RING)],
                [torch.empty(n, dtype=self.compute_dtype, pin_memory=pin)
                 for _ in range(RING)])
            if pin:
                self._streams = (torch.cuda.Stream(self.device),
                                 torch.cuda.Stream(self.device))
        return self._rings

    def _cast(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        if dst.dtype == torch.bfloat16 and self.cpu_opt.native:
            f32_to_bf16(src, dst)
        else:
            dst.copy_(src)

    def step(self, zero, lr: float) -> None:
        """One update of the partition from ``zero.grad``; the compute
        chunks (``zero.local``) receive the new parameters."""
        self.step_count += 1
        t_start = time.perf_counter()
        cuda = self.device.type == "cuda"
        gring, pring = self._staging()
        if cuda:
            cur = torch.cuda.current_stream(self.device)
            d2h, h2d = self._streams
            d2h.wait_stream(cur)
            h2d.wait_stream(cur)
        if self._dev_pieces:
            # Twin-Flow: the device share's update queues on the compute
            # stream first and runs while the host walks its own share
            grads = [zero.grad[po:po + n] for _, po, n in self._dev_pieces]
            self._dev_state = self._dev_opt.update(
                grads, self._dev_state._replace(step=self.step_count - 1),
                self._dev_master, lr=lr)
            with torch.no_grad():
                for (s, po, n), m in zip(self._dev_pieces, self._dev_master):
                    lo = po - zero.plan.segments[s].part_offset
                    zero.local[s][lo:lo + n].copy_(m)
        tiles = list(self._tiles())
        T = len(tiles)
        ev_d, ev_h = [None] * T, [None] * T
        starts_d, starts_h = [None] * T, [None] * T
        inflight, writes = {}, []
        runs = [r[0] for r in self._runs]
        run_at = {k: i for i, k in enumerate(runs)}
        tm = {"wait_d2h": 0.0, "adam": 0.0, "cast": 0.0, "wait_h2d": 0.0,
              "nvme_wait": 0.0}

        def issue_d2h(t):
            key, s, lo, a, n = tiles[t]
            src = zero.grad[lo + a:lo + a + n]
            dst = gring[t % RING][:n]
            if not cuda:
                dst.copy_(src)
                return
            with torch.cuda.stream(d2h):
                if self.delay_copies:
                    torch.cuda._sleep(self.delay_copies)
                starts_d[t] = torch.cuda.Event(enable_timing=True)
                starts_d[t].record(d2h)
                dst.copy_(src, non_blocking=True)
                ev_d[t] = torch.cuda.Event(enable_timing=True)
                ev_d[t].record(d2h)

        if self.nvme:
            for k in runs[:self.lookahead]:
                inflight[k] = self._issue_fetch(k)
        if T:
            issue_d2h(0)
        for t, (key, s, lo, a, n) in enumerate(tiles):
            if t + 1 < T:
                issue_d2h(t + 1)
            st = self.state[key]
            if self.nvme and a == 0:
                t0 = time.perf_counter()
                st = self._absorb_fetch(key, inflight.pop(key))
                i = run_at[key] + self.lookahead
                if i < len(runs):
                    inflight[runs[i]] = self._issue_fetch(runs[i])
                tm["nvme_wait"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            if cuda:
                ev_d[t].synchronize()
            t1 = time.perf_counter()
            piece = HostOptState(**{k: getattr(st, k)[a:a + n]
                                    for k in self.slots}, numel=n)
            self.cpu_opt.step(piece, gring[t % RING][:n], self.step_count,
                              lr=lr)
            t2 = time.perf_counter()
            if cuda and t >= RING:
                ev_h[t - RING].synchronize()
            t3 = time.perf_counter()
            buf = pring[t % RING][:n]
            self._cast(piece.master, buf)
            t4 = time.perf_counter()
            at = lo - zero.plan.segments[s].part_offset + a
            dst = zero.local[s][at:at + n]
            if cuda:
                with torch.cuda.stream(h2d):
                    if self.delay_copies:
                        torch.cuda._sleep(self.delay_copies)
                    starts_h[t] = torch.cuda.Event(enable_timing=True)
                    starts_h[t].record(h2d)
                    dst.copy_(buf, non_blocking=True)
                    ev_h[t] = torch.cuda.Event(enable_timing=True)
                    ev_h[t].record(h2d)
            else:
                dst.copy_(buf)
            tm["wait_d2h"] += t1 - t0
            tm["adam"] += t2 - t1
            tm["wait_h2d"] += t3 - t2
            tm["cast"] += t4 - t3
            if self.nvme and a + n == self._runs[run_at[key]][3]:
                self._write_back(key, st, writes)
        t0 = time.perf_counter()
        if cuda:
            for e in ev_h[-RING:]:
                if e is not None:
                    e.synchronize()
            cur.wait_stream(h2d)
        t1 = time.perf_counter()
        for r in writes:
            self.aio.wait(r)
        tm["wait_h2d"] += t1 - t0
        tm["nvme_wait"] += time.perf_counter() - t1
        elems = self.host_elements()
        self.last_step = {
            "seconds": time.perf_counter() - t_start, **tm,
            "tiles": T, "host_elements": elems,
            "device_elements": self.device_elements(),
            "d2h_bytes": elems * 4,
            "h2d_bytes": elems * torch.empty(0, dtype=self.compute_dtype
                                             ).element_size()}
        if cuda and T:
            self.last_step["d2h_ms"] = sum(
                a.elapsed_time(b) for a, b in zip(starts_d, ev_d))
            self.last_step["h2d_ms"] = sum(
                a.elapsed_time(b) for a, b in zip(starts_h, ev_h))

    # ------------------------------------------------------------------
    # the whole partition's state, for checkpoints and ``engine.master``
    @contextlib.contextmanager
    def materialized(self, zero, changed: bool = False):
        """``zero.master`` / ``mu`` / ``nu`` as whole host flats for the
        block, Twin-Flow's device share copied in (NVMe: read from disk).
        ``changed``: the block wrote them (a checkpoint load): the device
        share and NVMe take them back after."""
        P = zero.plan.partition_numel
        if self.nvme:
            flats = {slot: torch.empty(P, dtype=torch.float32)
                     for slot in self.slots}
            for key, _, lo, n in self._runs:
                st = self.leaf(key)
                for slot in self.slots:
                    flats[slot][lo:lo + n].copy_(getattr(st, slot))
        else:
            flats = self._flats
        if self._dev_pieces:
            moments = {"mu": self._dev_state.mu, "nu": self._dev_state.nu}
            for k, (_, po, n) in enumerate(self._dev_pieces):
                flats["master"][po:po + n].copy_(self._dev_master[k])
                for slot in self.cpu_opt.SLOTS:
                    if moments.get(slot) is not None:
                        flats[slot][po:po + n].copy_(moments[slot][k])
        zero.master = flats["master"]
        zero.mu, zero.nu = flats.get("mu"), flats.get("nu")
        try:
            yield
        finally:
            if changed:
                with torch.no_grad():
                    for k, (_, po, n) in enumerate(self._dev_pieces):
                        self._dev_master[k].copy_(flats["master"][po:po + n])
                        for slot, ms in (("mu", self._dev_state.mu),
                                         ("nu", self._dev_state.nu)):
                            if ms is not None and slot in flats:
                                ms[k].copy_(flats[slot][po:po + n])
                if self.nvme:
                    for key, _, lo, n in self._runs:
                        st = HostOptState(
                            **{s: flats[s][lo:lo + n].clone()
                               for s in self.slots}, numel=n)
                        self.load_leaf(key, st)
            if self.nvme:
                zero.master = zero.mu = zero.nu = None

    def close(self) -> None:
        self._rings = self._streams = None
        self._flats = {}
        self.state = {}
        self._dev_master = []
        self._dev_state = None
        if self.aio is not None:
            self.aio.close()
