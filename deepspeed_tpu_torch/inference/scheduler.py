"""Continuous-batching scheduler (Dynamic SplitFuse).

The port's copy of ``deepspeed_tpu/inference/scheduler.py``. Long prompts
are cut into chunks so every forward step carries near-constant work; the
scheduler emits pure steps — a prefill plan ([rows, T] prompt chunks) or a
decode plan ([max_seqs, 1]) — and the engine alternates them with decode
windows. With ``pack`` (token-budget packing), a plan carries exactly the
rows that have work and each row's chunk grows along the page-aligned chunk
chain (:meth:`program_shape_menu` lists every shape it can emit).

Every plan is packed by the host library's atom builder
(``csrc/atoms.cpp``, ``dstpu_build_atoms``), as the JAX scheduler packs
when its library loads; the library is built at first use and a failed
build raises (``ops/native.py``). :meth:`SplitFuseScheduler._python_build`
is the same packing in Python, the plain version the tests hold the native
one against; nothing on the serving path calls it.

Telemetry as in the JAX scheduler: plan building runs under a
``sched_plan`` span beside the ``serving_queue_depth`` gauge, and each
dispatched row and each commit lands a lifecycle event on its request's
timeline (``prefill_chunk`` / ``decode_step`` / ``commit``). Importing
this module loads no telemetry code; a scheduler's construction does.

:class:`SpecAcceptTracker` is the scheduler-side half of speculative
decoding: per-request draft depth adapted to the acceptance rate.
"""
from __future__ import annotations

import numpy as np

from .ragged import SequenceDescriptor, StateManager, StepPlan


class SplitFuseScheduler:
    def __init__(self, state: StateManager, chunk: int, pack: bool = False):
        self.state = state
        self.chunk = chunk
        # process-wide telemetry (telemetry/); configure() mutates the
        # instance in place, so caching the reference here stays live.
        # Imported here: loading this module loads no telemetry code
        from ..telemetry import get_telemetry

        self._telem = get_telemetry()
        # per-request lifecycle tracing (telemetry/reqtrace.py): the
        # scheduler emits the per-row dispatch/commit transitions —
        # engine_v2 overrides this with its (possibly pinned-off) handle
        self._reqtrace = self._telem.reqtrace
        #: plans packed by the host library's atom builder
        self.native_plans = 0
        #: token-budget prefill packing: when fewer than max_seqs rows have
        #: work, the plan carries exactly those rows and each row's chunk
        #: grows along the chunk chain to keep rows x T near-constant
        self.pack = pack
        #: packed prefill plans' rows are padded up to a multiple of this
        #: (the engine sets the ring degree under ``tp_overlap``, so every
        #: prefill plan's rows divide the tensor axis); padded rows are
        #: empty, like a full plan's idle rows. 1 = exactly the rows with
        #: work
        self.row_multiple = 1

    def _desc(self, kind: str, T: int, entries,
              use_last_slots=(), n_rows: int | None = None) -> StepPlan:
        S = n_rows if n_rows is not None else self.state.max_seqs
        bs = self.state.block_size
        max_blocks = self.state.max_blocks_per_seq
        packed = S != self.state.max_seqs
        plan = StepPlan(
            kind=kind,
            token_ids=np.zeros((S, T), np.int32),
            positions=np.zeros((S, T), np.int32),
            slot_map=np.zeros((S, T), np.int32),     # trash block slot 0
            active=np.zeros((S, T), np.uint8),
            block_tables=np.zeros((S, max_blocks), np.int32),
            seq_lens=np.zeros(S, np.int32),
            sample_idx=np.zeros(S, np.int32),
            do_sample=np.zeros(S, np.uint8),
            use_last=np.zeros(S, np.uint8),
            row_slots=np.zeros(S, np.int32),
            uids=[-1] * S,
        )
        # row r of a packed plan serves entries[r]; full plans keep
        # row == slot
        row_of = {seq.slot: (r if packed else seq.slot)
                  for r, (seq, *_) in enumerate(entries)}
        for s in use_last_slots:
            plan.use_last[row_of[s]] = 1
        if entries:
            self._native_build(plan, T, entries, row_of)
        for seq, *_ in entries:
            s = row_of[seq.slot]
            plan.uids[s] = seq.uid
            plan.row_slots[s] = seq.slot
        # empty rows get DISTINCT unused slots: the last-token scatter by
        # row_slots must never carry duplicate indices
        if packed or len(entries) < S:
            used = {seq.slot for seq, *_ in entries}
            free = (s for s in range(self.state.max_seqs) if s not in used)
            for r in range(S):
                if plan.uids[r] < 0:
                    plan.row_slots[r] = next(free)
        return plan

    def _native_build(self, plan: StepPlan, T: int, entries,
                      row_of: dict) -> None:
        """Pack the plan's arrays with ``dstpu_build_atoms`` (the host
        library's ``csrc/atoms.cpp``). The builder indexes rows by the
        first meta field: the plan row (``row_of[slot]``)."""
        import ctypes

        from ..ops.native import load_library

        lib = load_library()
        tokens, blocks, meta = [], [], []
        for seq, toks, start_pos, sample in entries:
            meta.extend((row_of[seq.slot], len(toks), start_pos, int(sample),
                         len(seq.blocks), len(tokens), len(blocks)))
            tokens.extend(toks)
            blocks.extend(seq.blocks)
        tok = np.asarray(tokens, np.int32)
        blk = np.asarray(blocks, np.int32)
        met = np.asarray(meta, np.int32)
        pp = lambda a: a.ctypes.data_as(ctypes.c_void_p)   # noqa: E731
        rc = lib.dstpu_build_atoms(
            len(entries), pp(tok), pp(met), pp(blk),
            plan.token_ids.shape[0], T, self.state.max_blocks_per_seq,
            self.state.block_size,
            pp(plan.token_ids), pp(plan.positions), pp(plan.slot_map),
            pp(plan.active), pp(plan.block_tables), pp(plan.seq_lens),
            pp(plan.sample_idx), pp(plan.do_sample))
        if rc != 0:
            raise ValueError(
                f"atom builder: entry {rc - 1} violates plan-shape "
                f"invariants (meta {meta[(rc - 1) * 7:rc * 7]})")
        self.native_plans += 1

    def _python_build(self, plan: StepPlan, T: int, entries,
                      row_of: dict) -> None:
        """The same packing as :meth:`_native_build` in numpy: the plain
        version the tests hold the native builder against."""
        bs = self.state.block_size
        max_blocks = self.state.max_blocks_per_seq
        for seq, toks, start_pos, sample in entries:
            s = row_of[seq.slot]
            n = len(toks)
            if n > T or len(seq.blocks) > max_blocks:
                raise ValueError(f"plan row {s}: {n} tokens / "
                                 f"{len(seq.blocks)} blocks exceed the plan's "
                                 f"[{T}] / [{max_blocks}]")
            pos = np.arange(start_pos, start_pos + n)
            blocks = np.asarray(seq.blocks, np.int32)
            plan.token_ids[s, :n] = toks
            plan.positions[s, :n] = pos
            # rolling-buffer slot formula (the mod is a no-op for linear
            # tables)
            plan.slot_map[s, :n] = blocks[(pos // bs) % max_blocks] * bs \
                + pos % bs
            plan.active[s, :n] = 1
            plan.block_tables[s, :len(blocks)] = blocks
            plan.seq_lens[s] = start_pos + n
            plan.sample_idx[s] = n - 1
            plan.do_sample[s] = sample

    def pending_kinds(self) -> tuple[bool, bool]:
        """(has_prefill, has_decode) over the scheduled view."""
        has_prefill = has_decode = False
        for seq in self.state.seqs.values():
            if seq.sched_done or seq.slot < 0:
                continue
            if seq.pending_sched > 1:
                has_prefill = True
            else:
                has_decode = True
            if has_prefill and has_decode:
                break
        return has_prefill, has_decode

    def program_shape_menu(self) -> list[tuple[int, int]]:
        """Every (T, n_rows) prefill-plan shape :meth:`next_step` can emit
        under the current packing config (mirrors the packing math)."""
        S_max = self.state.max_seqs
        shapes = {(self.chunk, S_max)}
        if not self.pack:
            return sorted(shapes)
        for k in range(1, S_max):
            n_rows = self._pad_rows(k)
            for T in self._chunk_chain(n_rows):
                shapes.add((T, n_rows))
        return sorted(shapes)

    def _pad_rows(self, k: int) -> int:
        """A packed plan's rows for ``k`` pending sequences: ``k`` rounded
        up to ``row_multiple``, at most the table's width."""
        m = self.row_multiple
        if m <= 1:
            return k
        return min(-(-k // m) * m, self.state.max_seqs)

    def _chunk_chain(self, n_rows: int) -> list[int]:
        """The T values a packed ``n_rows``-row prefill plan may carry: the
        budget chunk halved toward the configured chunk, stopping before any
        value that is not page-aligned (a chunk must start on a page)."""
        bs = self.state.block_size
        out = [self.chunk]
        if self.chunk % bs == 0:
            T = self.chunk * (self.state.max_seqs // n_rows)
            while T >= self.chunk and T % bs == 0:
                out.append(T)
                T //= 2
        return out

    def queue_depth(self) -> int:
        """Sequences with unscheduled work — the serving backlog gauge."""
        return sum(1 for seq in self.state.seqs.values()
                   if not seq.sched_done)

    def load_summary(self) -> dict:
        """Compact load view for a serving replica's heartbeat: live
        sequences, backlog (prompt tokens not yet scheduled + decode budget
        remaining), sequences a migration pins (they hold capacity but
        schedule nothing) and the prefill/decode pending split."""
        live = queued = pending_tokens = migrating = 0
        for seq in self.state.seqs.values():
            live += 1
            if seq.frozen:
                migrating += 1
                continue
            if seq.sched_done:
                continue
            queued += 1
            pending_tokens += max(seq.pending_sched - 1, 0) \
                + max(seq.max_new_tokens - seq.n_generated
                      - seq.n_inflight, 0)
        has_prefill, has_decode = self.pending_kinds()
        return {"live": live, "queued": queued,
                "pending_tokens": pending_tokens,
                "migrating": migrating,
                "pending_prefill": has_prefill,
                "pending_decode": has_decode}

    def next_step(self, prefer: str | None = None) -> StepPlan | None:
        """Plan-building entry point (see :meth:`_next_step_inner`).
        Telemetry wrapper: plan construction runs under a ``sched_plan``
        span and the queue-depth gauge updates per call."""
        telem = self._telem
        if not telem.enabled:
            return self._next_step_inner(prefer)
        telem.registry.gauge(
            "serving_queue_depth",
            help="sequences with unscheduled work").set(self.queue_depth())
        with telem.span("sched_plan") as sp:
            plan = self._next_step_inner(prefer)
            if plan is not None:
                sp.set(kind=plan.kind, rows=plan.token_ids.shape[0],
                       T=plan.token_ids.shape[1])
        return plan

    def _next_step_inner(self, prefer: str | None = None) -> StepPlan | None:
        """Build the next step plan from the scheduled view, or None if
        nothing can run. Mixed prefill/decode load alternates pure steps;
        ``prefer="decode"`` emits the decode plan when both kinds exist. A
        decode row whose last token is still on the device carries a
        placeholder with ``use_last`` set."""
        st = self.state
        prefill: list[SequenceDescriptor] = []
        decode: list[SequenceDescriptor] = []
        for seq in st.seqs.values():
            if seq.sched_done:
                continue
            (prefill if seq.pending_sched > 1 else decode).append(seq)

        # blocks were reserved for prompt + max_new_tokens at admit, so
        # neither branch can exhaust the pool here
        if prefill and not (decode and prefer == "decode"):
            k = min(len(prefill), st.max_seqs)
            n_rows = st.max_seqs
            T = self.chunk
            if self.pack and k < st.max_seqs:
                n_rows = self._pad_rows(k)
                chain = self._chunk_chain(n_rows)
                if len(chain) > 1:
                    # don't pad a row wider than the largest pending prompt
                    maxpend = max(s.pending_sched for s in prefill)
                    T = next((t for t in sorted(chain) if t >= maxpend),
                             max(chain))
            entries = []
            for seq in prefill[:n_rows]:
                n = min(T, seq.pending_sched)
                toks = seq.tokens[seq.kv_next:seq.kv_next + n]
                # sample only when this chunk consumes the last pending token
                entries.append((seq, toks, seq.kv_next,
                                n == seq.pending_sched))
            return self._desc("prefill", T, entries, (), n_rows=n_rows)

        if decode:
            decode = decode[:st.max_seqs]
            entries = [(seq, [0] if seq.n_inflight else seq.tokens[-1:],
                        seq.kv_next, True) for seq in decode]
            use_last = [seq.slot for seq in decode if seq.n_inflight]
            return self._desc("decode", 1, entries, use_last)
        return None

    def mark_dispatched(self, plan: StepPlan) -> None:
        """Advance the scheduled view for every row of a dispatched plan
        (``commit`` is the readback-time half). Each real row lands one
        lifecycle event on its request timeline (reqtrace): the prefill
        chunk's token count and plan width, or the decode step."""
        rt = self._reqtrace
        trace = rt.enabled
        T = plan.token_ids.shape[1]
        for s, uid in enumerate(plan.uids):
            if uid < 0:
                continue
            seq = self.state.seqs[uid]
            n = int(plan.active[s].sum())
            seq.n_sched = seq.kv_next + n
            if plan.do_sample[s]:
                seq.n_inflight += 1
            if trace:
                if plan.kind == "prefill":
                    rt.event(uid, "prefill_chunk", tokens=n, T=T,
                             rows=len(plan.uids))
                else:
                    rt.event(uid, "decode_step", tokens=n)
        plan.dispatched = True

    def commit(self, plan: StepPlan,
               sampled: dict[int, int]) -> dict[int, list[int]]:
        """Advance sequence state after a step ran. ``sampled``: uid → token
        for every row that had do_sample. Returns uid → tokens accepted by
        each sequence's stop criteria."""
        rt = self._reqtrace
        accepted: dict[int, list[int]] = {}
        for s, uid in enumerate(plan.uids):
            if uid < 0:
                continue
            seq = self.state.seqs.get(uid)
            if seq is None:         # flushed while the commit was pending
                continue
            if plan.dispatched and plan.do_sample[s]:
                seq.n_inflight -= 1
            accepted[uid] = seq.commit_generated(
                [sampled[uid]] if plan.do_sample[s] and uid in sampled
                else [], int(plan.active[s].sum()))
            if rt.enabled and accepted[uid]:
                rt.event(uid, "commit", tokens=len(accepted[uid]))
        return accepted


class SpecAcceptTracker:
    """Per-request accept-rate tracking that adapts speculative draft depth
    (``deepspeed_tpu/inference/scheduler.py``'s tracker).

    Each uid keeps an EMA of its draft-token acceptance rate. Depth shrinks
    one step when the EMA falls below ``shrink_below`` (at the floor of 1 a
    verify step is an ordinary decode) and grows back toward
    ``base_depth`` above ``grow_above``. While prefill chunks are pending
    the returned depth is also capped at ``mixed_cap``, so a waiting first
    chunk never sits behind a max-depth verify round."""

    def __init__(self, base_depth: int, min_depth: int = 1,
                 alpha: float = 0.5, shrink_below: float = 0.35,
                 grow_above: float = 0.75):
        self.base_depth = max(1, base_depth)
        self.min_depth = max(1, min_depth)
        self.alpha = alpha
        self.shrink_below = shrink_below
        self.grow_above = grow_above
        self._rate: dict[int, float] = {}
        self._depth: dict[int, int] = {}

    def rate(self, uid: int) -> float:
        return self._rate.get(uid, 1.0)

    def depth(self, uid: int, prefill_pending: bool = False,
              mixed_cap: int = 0) -> int:
        d = self._depth.get(uid, self.base_depth)
        if prefill_pending and mixed_cap:
            d = min(d, mixed_cap)
        return max(self.min_depth, d)

    def observe(self, uid: int, proposed: int,
                accepted: int) -> tuple[int, int] | None:
        """Record one verify round (``proposed`` candidates, ``accepted``
        of them matched). Returns ``(old, new)`` when the uid's depth
        adapted, else None. Rounds that proposed nothing carry no signal
        and are skipped."""
        if proposed <= 0:
            return None
        r = accepted / proposed
        ema = self._rate.get(uid)
        ema = r if ema is None else self.alpha * r + (1 - self.alpha) * ema
        self._rate[uid] = ema
        old = self._depth.get(uid, self.base_depth)
        new = old
        if ema < self.shrink_below:
            new = max(self.min_depth, old - 1)
        elif ema > self.grow_above:
            new = min(self.base_depth, old + 1)
        if new != old:
            self._depth[uid] = new
            return (old, new)
        self._depth.setdefault(uid, old)
        return None

    def forget(self, uid: int) -> None:
        self._rate.pop(uid, None)
        self._depth.pop(uid, None)
