"""Host-side ragged batching state: blocked KV allocator + sequence manager.

The port's copy of ``deepspeed_tpu/inference/ragged.py`` (reference
inference/v2/ragged/: ``BlockedAllocator``, ``DSSequenceDescriptor``,
``DSStateManager``, ``RaggedBatchWrapper``). Device-agnostic numpy
bookkeeping: the allocator hands out fixed-size KV blocks of the device
pool, sequences own block lists, and each step's plan is plain int32
arrays the forward consumes.

Carried: the allocator, ``SequenceDescriptor`` with its committed and
scheduled views, the refcounted admit/release API over the shared-prefix
cache (with the weight-swap skew guard: ``admit_wv``, release never
publishing across a weight version, ``flush_prefix_cache``), the
rollback-aware provisional API of speculative decoding with the draft
mirror's ``rewind``, the KV-page migration API (``migrate_out`` /
``export_ack`` / ``export_abort`` / ``migrate_in_begin`` /
``import_commit`` / ``abort_import``), the prefix snapshot/adopt pair of
radix pulls and the full-pool ``audit()``. The request tracer
(``telemetry/reqtrace.py``, attached by the engine as ``reqtrace``) gets
the JAX package's lifecycle events: admit, release, the speculative
commit / rollback / rewind, migrate_out / migrate_in (carrying the
migration's ``trace`` id) and the two legs of a radix pull.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


class BlockedAllocator:
    """Free-list allocator over ``num_blocks`` KV blocks. Block 0 is
    reserved as the trash block — padded tokens write their (masked) KV
    there."""

    TRASH = 0

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError("need at least 2 blocks (one is reserved)")
        self.num_blocks = num_blocks
        self._free: list[int] = list(range(1, num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def allocate(self, n: int) -> list[int]:
        if n > len(self._free):
            raise RuntimeError(f"KV pool exhausted: want {n}, "
                               f"free {len(self._free)}")
        out, self._free = self._free[:n], self._free[n:]
        return out

    def free(self, blocks: list[int]) -> None:
        for b in blocks:
            if b == self.TRASH or b < 0 or b >= self.num_blocks:
                raise ValueError(f"bad block id {b}")
        self._free.extend(blocks)


@dataclass
class SequenceDescriptor:
    """Per-uid state. Two views coexist so the engine can plan ahead of
    readbacks:

    - committed: ``tokens`` / ``n_computed`` / ``n_generated`` advance when
      sampled tokens reach the host (``commit_generated``).
    - scheduled: ``n_sched`` (KV scheduled into the pool) and
      ``n_inflight`` (sampled tokens only on the device) advance at
      dispatch time; the scheduler plans from this view.

    The first ``n_shared_blocks`` entries of ``blocks`` are read-only
    pages owned by the prefix trie; ``n_computed`` starts at the cached
    token boundary so the scheduler never recomputes or writes them.
    """
    uid: int
    tokens: list[int]                 # full token history (prompt + generated)
    slot: int = -1                    # batch slot while scheduled
    n_computed: int = 0               # tokens whose KV is already in the pool
    blocks: list[int] = field(default_factory=list)
    max_new_tokens: int = 0
    n_generated: int = 0
    done: bool = False
    eos_id: int | None = None         # stop criterion besides max_new_tokens
    n_sched: int = 0                  # KV tokens scheduled (dispatch-time)
    n_inflight: int = 0               # sampled tokens not yet read back
    n_shared_blocks: int = 0          # leading trie-owned (read-only) pages
    prefix_hit_tokens: int = 0        # prompt tokens served from the trie
    #: prefix-cache weight version at admit: a sequence that lived across a
    #: weight swap computed its KV (partly) under the OLD weights, so its
    #: release frees its pages instead of publishing them
    admit_wv: int = 0
    #: speculative candidate tokens whose KV may land in this sequence's
    #: owned tail pages ahead of acceptance; only the provisional API of
    #: StateManager mutates it
    n_provisional: int = 0
    #: KV-page migration: None, "out" (an exported bundle is in flight: the
    #: pages are pinned, release refused until the importer acks or the
    #: export aborts) or "in" (created by ``migrate_in_begin``, pages still
    #: arriving until ``import_commit``). Only the migration API of
    #: StateManager mutates it
    migrating: str | None = None

    @property
    def frozen(self) -> bool:
        """True while a migration pins this sequence: never schedulable."""
        return self.migrating is not None

    @property
    def pending_tokens(self) -> int:
        """Tokens not yet run through the model. > 1 → still prefilling;
        == 1 → the next step decodes the last token."""
        return len(self.tokens) - self.n_computed

    # --- scheduled (speculative) view -------------------------------------
    @property
    def kv_next(self) -> int:
        """First token index whose KV is not yet scheduled."""
        return max(self.n_computed, self.n_sched)

    @property
    def len_sched(self) -> int:
        """Sequence length including in-flight (device-only) tokens."""
        return len(self.tokens) + self.n_inflight

    @property
    def pending_sched(self) -> int:
        """Tokens not yet scheduled through the model. > 1 → prefilling;
        == 1 → decode-ready."""
        return self.len_sched - self.kv_next

    @property
    def gen_remaining_sched(self) -> int:
        """Generation budget not yet scheduled."""
        return self.max_new_tokens - self.n_generated - self.n_inflight

    @property
    def sched_done(self) -> bool:
        """Nothing left to dispatch (committed-done, budget in flight, or
        frozen by a page migration — every plan builder gates on this)."""
        return self.done or self.frozen or self.gen_remaining_sched <= 0

    def commit_generated(self, new_tokens: list[int],
                         n_computed: int) -> list[int]:
        """Append sampled tokens, advance the computed-KV counter and apply
        the stop criteria (max_new_tokens, and eos when configured — a
        window may sample past the eos; the surplus is truncated here)."""
        if self.done:
            return []
        if self.eos_id is not None and new_tokens:
            for i, t in enumerate(new_tokens):
                if t == self.eos_id:
                    new_tokens = new_tokens[:i + 1]
                    self.done = True
                    break
        self.tokens.extend(new_tokens)
        self.n_computed = min(self.n_computed + n_computed, len(self.tokens))
        self.n_generated += len(new_tokens)
        if self.n_generated >= self.max_new_tokens:
            self.done = True
        return new_tokens


class StateManager:
    """Tracks live sequences and owns the allocator.

    THE refcounted alloc/free API: every block-list mutation goes through
    :meth:`admit` / :meth:`release`. With a
    :class:`~.prefix_cache.PrefixCache` attached, admit points new
    sequences at cached read-only pages (refcount++), release publishes
    computed full pages into the trie instead of freeing them, and
    allocation under pressure reclaims LRU unreferenced cached pages —
    never referenced ones (the engine's flush commits a uid's dispatched
    steps before release runs)."""

    def __init__(self, num_blocks: int, block_size: int, max_seqs: int,
                 max_blocks_per_seq: int):
        self.allocator = BlockedAllocator(num_blocks)
        self.block_size = block_size
        self.max_seqs = max_seqs
        # static block-table width; the physical slot of absolute position
        # p is (p // bs) % max_blocks_per_seq (a no-op while p // bs stays
        # below the width, i.e. for every linear table)
        self.max_blocks_per_seq = max_blocks_per_seq
        self.seqs: dict[int, SequenceDescriptor] = {}
        self._free_slots = list(range(max_seqs))
        #: shared-prefix trie (attach_prefix_cache); None = no sharing
        self.prefix_cache = None
        # node chains live sequences hold refs on (uid → list[PageNode])
        self._shared_nodes: dict[int, list] = {}
        # node chains pinned by an in-flight prefix snapshot (handle → list)
        self._pull_pins: dict[int, list] = {}
        self._pull_ctr = 0
        #: per-request lifecycle tracer (telemetry/reqtrace.py, duck-typed:
        #: ``.enabled`` + ``.event(uid, kind, **fields)``) — engine_v2
        #: attaches it; None = no tracing (bare StateManager users)
        self.reqtrace = None
        # pages the last _alloc call reclaimed from the prefix LRU (admit
        # folds this into its lifecycle event for attribution)
        self._last_evicted = 0
        # an import's migration trace id, carried to its migrate_in event
        self._mig_trace: dict[int, str | None] = {}

    def attach_prefix_cache(self, cache) -> None:
        """Enable shared-prefix serving (before the first admit)."""
        if self.seqs:
            raise RuntimeError("attach_prefix_cache before admitting")
        self.prefix_cache = cache

    def flush_prefix_cache(self) -> int:
        """Evict EVERY unreferenced cached page back to the free list (the
        weight swap's skew guard: a page computed under the old weights must
        not seed a new request's prefill). Pinned pages stay with their live
        sequences and fall to the LRU once released. ``demote=False``: old-
        weight pages never go to the KV tier. Returns pages reclaimed."""
        if self.prefix_cache is None:
            return 0
        reclaimed = self.prefix_cache.evict(len(self.prefix_cache),
                                            demote=False)
        if reclaimed:
            self.allocator.free(reclaimed)
        return len(reclaimed)

    def _blocks_for(self, n_tokens: int) -> int:
        return min(-(-n_tokens // self.block_size), self.max_blocks_per_seq)

    def _alloc(self, n: int) -> list[int]:
        """Allocation that tops the free list up from the prefix LRU under
        pressure (unreferenced cached pages only)."""
        self._last_evicted = 0
        short = n - self.allocator.free_blocks
        if short > 0 and self.prefix_cache is not None:
            reclaimed = self.prefix_cache.evict(short)
            if reclaimed:
                self.allocator.free(reclaimed)
                self._last_evicted = len(reclaimed)
        return self.allocator.allocate(n)

    def can_admit(self, prompt_len: int, max_new_tokens: int = 0) -> bool:
        """Admission requires the WORST-CASE block budget (prompt + all
        generated tokens) free right now — blocks are reserved at admit.
        Unreferenced cached prefix pages count as free. With a prefix cache
        attached, sequences that could wrap the block table are refused (a
        wrap would rewrite blocks the trie shares)."""
        need = self._blocks_for(prompt_len + max_new_tokens)
        avail = self.allocator.free_blocks
        if self.prefix_cache is not None:
            if -(-(prompt_len + max_new_tokens) // self.block_size) \
                    > self.max_blocks_per_seq:
                return False
            avail += self.prefix_cache.evictable_blocks
        return bool(self._free_slots) and avail >= need

    def admit(self, uid: int, tokens: list[int], max_new_tokens: int,
              eos_id: int | None = None) -> SequenceDescriptor:
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already live")
        if not tokens:
            raise ValueError("empty prompt")
        if not self._free_slots:
            raise RuntimeError("no free sequence slots")
        if self.prefix_cache is not None and \
                -(-(len(tokens) + max_new_tokens) // self.block_size) \
                > self.max_blocks_per_seq:
            raise ValueError(
                f"prefix cache requires non-wrapping tables: "
                f"{len(tokens)} + {max_new_tokens} tokens exceed "
                f"{self.max_blocks_per_seq} x {self.block_size}")
        seq = SequenceDescriptor(uid=uid, tokens=list(tokens),
                                 max_new_tokens=max_new_tokens,
                                 eos_id=eos_id,
                                 slot=self._free_slots.pop(0))
        bs = self.block_size
        shared_nodes: list = []
        if self.prefix_cache is not None:
            # the LAST prompt token is always recomputed (its forward
            # produces the first sample's logits): cap the hit one short
            shared_nodes = self.prefix_cache.match(
                tokens, max_tokens=min(len(tokens) - 1,
                                       self.max_blocks_per_seq * bs))
            # pin BEFORE allocating: _alloc under pressure evicts refs==0
            # pages, and the matched chain must not be among them
            if shared_nodes:
                self.prefix_cache.acquire(shared_nodes)
        n_need = self._blocks_for(len(tokens) + max_new_tokens)
        try:
            fresh = self._alloc(n_need - len(shared_nodes))
        except RuntimeError:
            if shared_nodes:
                self.prefix_cache.release(shared_nodes)
            self._free_slots.insert(0, seq.slot)
            raise
        if shared_nodes:
            self._shared_nodes[uid] = shared_nodes
            seq.n_shared_blocks = len(shared_nodes)
            seq.n_computed = len(shared_nodes) * bs
            seq.prefix_hit_tokens = seq.n_computed
        seq.blocks = [n.block for n in shared_nodes] + fresh
        if self.prefix_cache is not None:
            seq.admit_wv = self.prefix_cache.weight_version
        self.seqs[uid] = seq
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            # the admit transition carries the prefix-cache hit extent and
            # the reservation — the timeline's "where did this request
            # start from" ground truth
            rt.event(uid, "admit", prompt=len(tokens),
                     max_new=max_new_tokens, blocks=len(seq.blocks),
                     prefix_hit=seq.prefix_hit_tokens,
                     shared_blocks=seq.n_shared_blocks,
                     evicted=self._last_evicted, slot=seq.slot)
        return seq

    def release(self, uid: int) -> None:
        """Free a sequence's slot and pages. With a prefix cache attached,
        computed full pages are published into the trie instead of freed
        and shared pages drop their refcount — unless the weights swapped
        while the sequence lived, when its owned pages are freed instead.
        Callers must have committed in-flight steps referencing this uid
        first. Refused while a migration pins the sequence."""
        if self.seqs[uid].frozen:
            raise RuntimeError(
                f"uid {uid} is pinned by an in-flight migration "
                f"({self.seqs[uid].migrating!r}): settle it via "
                f"export_ack/export_abort/abort_import before release")
        seq = self.seqs.pop(uid)
        published = 0
        if self.prefix_cache is not None and seq.slot >= 0:
            shared = self._shared_nodes.pop(uid, None)
            if seq.admit_wv != self.prefix_cache.weight_version:
                if shared:
                    self.prefix_cache.release(shared)
                owned = seq.blocks[seq.n_shared_blocks:]
                if owned:
                    self.allocator.free(owned)
            else:
                to_free = self.prefix_cache.publish(
                    seq.tokens, seq.blocks, seq.n_shared_blocks,
                    min(seq.n_computed, len(seq.tokens)))
                published = len(seq.blocks) - len(to_free)
                if to_free:
                    self.allocator.free(to_free)
        elif seq.blocks:
            self.allocator.free(seq.blocks)
        if seq.slot >= 0:
            self._free_slots.append(seq.slot)
            self._free_slots.sort()
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            # release closes the timeline (and settles the tenant's KV
            # page-seconds integral inside the tracer)
            rt.event(uid, "release", pages=len(seq.blocks),
                     published=published, generated=seq.n_generated)

    # --- speculative decoding: the rollback-aware provisional API --------
    # Candidate KV only ever lands in the sequence's OWNED tail pages and
    # inside the block budget reserved at admit, so provisioning never
    # allocates and a rejected candidate is erased by bookkeeping alone.

    def provision(self, uid: int, n: int) -> None:
        """Mark ``n`` candidate tokens as provisionally scheduled for a
        decode-ready sequence (refused past the generation budget)."""
        seq = self.seqs[uid]
        if n < 0:
            raise ValueError(f"negative provisional count {n}")
        if seq.pending_tokens != 1:
            raise RuntimeError(
                f"uid {uid} is not decode-ready (pending "
                f"{seq.pending_tokens}); speculative steps verify from "
                f"the committed last token")
        rem = seq.max_new_tokens - seq.n_generated
        if n > max(rem - 1, 0):
            raise RuntimeError(
                f"uid {uid}: {n} provisional tokens + bonus exceed the "
                f"remaining generation budget {rem}")
        seq.n_provisional = n

    def commit_speculative(self, uid: int, accepted: list[int]) -> list[int]:
        """Fold a verify step's accepted tokens into the committed view and
        clear the provisional marker. Returns the tokens surviving the stop
        criteria."""
        seq = self.seqs[uid]
        n = len(accepted)
        if n < 1:
            raise ValueError("a verify step always accepts >= 1 token")
        if n > seq.n_provisional + 1:
            raise RuntimeError(
                f"uid {uid}: accepting {n} tokens but only "
                f"{seq.n_provisional} were provisioned (+1 bonus)")
        seq.n_provisional = 0
        out = seq.commit_generated(list(accepted), n)
        seq.n_sched = seq.n_computed
        seq.n_inflight = 0
        rt = self.reqtrace
        if rt is not None and rt.enabled and out:
            rt.event(uid, "commit", tokens=len(out), spec=True)
        return out

    def rollback_provisional(self, uid: int) -> None:
        """Discard a provisioned-but-unverified tree."""
        seq = self.seqs.get(uid)
        if seq is not None:
            had = seq.n_provisional
            seq.n_provisional = 0
            rt = self.reqtrace
            if rt is not None and rt.enabled and had:
                rt.event(uid, "rollback", provisional=had)

    def rewind(self, uid: int, tokens: list[int]) -> None:
        """Reset a sequence's history to ``tokens`` (the draft-model
        proposer's mirror sync: the target's accept/reject decision is
        ground truth). Computed KV of the common prefix stays valid; KV past
        the cut is overwritten as the draft re-decodes. Blocks never change
        hands: the admit-time reservation must cover the new history."""
        seq = self.seqs[uid]
        if not tokens:
            raise ValueError("cannot rewind to an empty history")
        if seq.n_shared_blocks:
            shared = seq.n_shared_blocks * self.block_size
            if (len(tokens) <= shared
                    or tokens[:shared] != seq.tokens[:shared]):
                raise RuntimeError(
                    f"uid {uid}: rewind would rewrite shared prefix pages")
        if self._blocks_for(len(tokens)) > len(seq.blocks):
            raise RuntimeError(
                f"uid {uid}: rewind target of {len(tokens)} tokens "
                f"exceeds the {len(seq.blocks)}-block reservation")
        keep = 0
        for a, b in zip(seq.tokens, tokens):
            if a != b:
                break
            keep += 1
        seq.tokens = list(tokens)
        # the last token is always re-run (its forward gives the next
        # logits), and the kept KV is floored to a page boundary, as in the
        # JAX package (whose page-merge program needs page-aligned resume
        # chunks; the partial page is recomputed to the same KV)
        keep = min(seq.n_computed, keep, len(tokens) - 1)
        seq.n_computed = keep - keep % self.block_size
        seq.n_sched = seq.n_computed
        seq.n_inflight = 0
        seq.n_provisional = 0
        # the budget restarts from the rewound history, capped so it never
        # outruns the admit-time block reservation
        cap = len(seq.blocks) * self.block_size
        seq.n_generated = max(0, seq.max_new_tokens - (cap - len(tokens)))
        seq.done = False
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            rt.event(uid, "rewind", to_len=len(tokens),
                     kept_kv=seq.n_computed)

    # --- KV-page migration: the refcounted export/import/abort API -------
    # Ownership never changes hands mid-transfer: the exporter's pages stay
    # owned by the (frozen) source sequence until the importer acks, and the
    # importer's pages are ordinary owned blocks until ``import_commit``
    # seeds the prefix trie from them. An abort on either side is pure
    # bookkeeping. These six methods are the only mutators of ``migrating``.

    def migrate_out(self, uid: int, trace: str | None = None) -> dict:
        """Pin a live sequence for export and return its page-chain
        snapshot: token history, committed-KV extent, and the pool blocks
        holding it (full pages + the partial tail extent). Callers must
        have committed in-flight steps referencing this uid first (the
        committed view IS the pool content then). The sequence stays live,
        frozen until ``export_ack`` or ``export_abort``."""
        seq = self.seqs[uid]
        if seq.frozen:
            raise RuntimeError(f"uid {uid} is already migrating "
                               f"({seq.migrating!r})")
        if seq.done:
            raise RuntimeError(f"uid {uid} is done: nothing to migrate")
        if seq.n_provisional:
            raise RuntimeError(
                f"uid {uid} has a provisional speculative tree in flight "
                f"— commit or roll it back before migrating")
        if seq.n_inflight:
            raise RuntimeError(
                f"uid {uid} has {seq.n_inflight} sampled tokens in "
                f"flight — drain the pipeline before migrating")
        bs = self.block_size
        if -(-(len(seq.tokens) + seq.max_new_tokens - seq.n_generated)
             // bs) > self.max_blocks_per_seq:
            # a wrap-capable sequence's rolling table reuses page slots in
            # place: the linear page chain of a bundle does not exist
            raise RuntimeError(
                f"uid {uid} can wrap its block table "
                f"(rolling-ring regime): page migration requires linear "
                f"tables")
        n_full = seq.n_computed // bs
        tail_rows = seq.n_computed - n_full * bs
        seq.migrating = "out"
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            rt.event(uid, "migrate_out", pages=n_full, tail=tail_rows,
                     tokens=len(seq.tokens), trace=trace)
        return {
            "uid": uid, "tokens": list(seq.tokens),
            "n_computed": seq.n_computed,
            "n_generated": seq.n_generated,
            "max_new_tokens": seq.max_new_tokens,
            "eos_id": seq.eos_id, "block_size": bs,
            "page_blocks": list(seq.blocks[:n_full]),
            "tail_block": seq.blocks[n_full] if tail_rows else None,
            "tail_rows": tail_rows,
        }

    def export_ack(self, uid: int) -> None:
        """The importer owns the stream now: unfreeze and mark the source
        done, so the caller's flush releases it (publishing its computed
        pages into the LOCAL trie)."""
        seq = self.seqs[uid]
        if seq.migrating != "out":
            raise RuntimeError(f"uid {uid} has no export in flight")
        seq.migrating = None
        seq.done = True

    def export_abort(self, uid: int) -> None:
        """Transfer failed or was refused: unfreeze. The sequence resumes
        exactly where it stopped (no block changed hands)."""
        seq = self.seqs[uid]
        if seq.migrating != "out":
            raise RuntimeError(f"uid {uid} has no export in flight")
        seq.migrating = None

    def migrate_in_begin(self, uid: int, tokens: list[int],
                         n_computed: int, n_generated: int,
                         max_new_tokens: int, eos_id: int | None = None,
                         trace: str | None = None) -> SequenceDescriptor:
        """Reserve a slot + the FULL remaining block budget for an arriving
        sequence before the first payload byte lands. The sequence is
        created frozen (``migrating="in"``): the caller writes the bundle's
        KV into the returned descriptor's blocks, then ``import_commit``
        seeds the prefix trie and unfreezes — or ``abort_import`` hands
        every block back."""
        if uid in self.seqs:
            raise ValueError(f"uid {uid} already live")
        if not tokens:
            raise ValueError("empty token chain")
        if not 0 <= n_computed <= len(tokens) - 1:
            raise ValueError(
                f"n_computed {n_computed} outside [0, {len(tokens) - 1}] "
                f"(the last token is always recomputed)")
        if n_generated > max_new_tokens:
            raise ValueError(f"n_generated {n_generated} exceeds the "
                             f"budget {max_new_tokens}")
        if not self._free_slots:
            raise RuntimeError("no free sequence slots")
        bs = self.block_size
        remaining = max_new_tokens - n_generated
        if -(-(len(tokens) + remaining) // bs) > self.max_blocks_per_seq:
            raise RuntimeError(
                f"import of {len(tokens)} + {remaining} tokens would wrap "
                f"the {self.max_blocks_per_seq} x {bs} block table")
        seq = SequenceDescriptor(uid=uid, tokens=list(tokens),
                                 max_new_tokens=max_new_tokens,
                                 eos_id=eos_id,
                                 slot=self._free_slots.pop(0))
        try:
            fresh = self._alloc(self._blocks_for(len(tokens) + remaining))
        except RuntimeError:
            self._free_slots.insert(0, seq.slot)
            raise
        seq.blocks = fresh
        seq.n_computed = n_computed
        seq.n_sched = n_computed
        seq.n_generated = n_generated
        seq.migrating = "in"
        self._mig_trace[uid] = trace
        self.seqs[uid] = seq
        return seq

    def import_commit(self, uid: int) -> None:
        """Payload landed: seed the local prefix trie from the imported full
        pages (they become shared trie nodes this sequence references;
        pages already cached dedup, the fresh copy going back to the
        allocator) and unfreeze."""
        seq = self.seqs[uid]
        if seq.migrating != "in":
            raise RuntimeError(f"uid {uid} has no import in flight")
        bs = self.block_size
        n_full = seq.n_computed // bs
        if self.prefix_cache is not None and n_full > 0:
            nodes, dups = self.prefix_cache.adopt(
                seq.tokens, seq.blocks[:n_full], n_full * bs)
            if len(nodes) != n_full:    # pragma: no cover — adopt contract
                raise RuntimeError(
                    f"uid {uid}: adopted {len(nodes)} trie pages, "
                    f"expected {n_full}")
            self._shared_nodes[uid] = nodes
            seq.n_shared_blocks = n_full
            seq.blocks = [n.block for n in nodes] + seq.blocks[n_full:]
            seq.prefix_hit_tokens = 0     # imported, not served from cache
            if dups:
                self.allocator.free(dups)
        if self.prefix_cache is not None:
            # skew-gated imports only land same-version bundles
            seq.admit_wv = self.prefix_cache.weight_version
        seq.migrating = None
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            rt.event(uid, "migrate_in", pages=n_full,
                     tokens=len(seq.tokens), shared=seq.n_shared_blocks,
                     trace=self._mig_trace.pop(uid, None))
        else:
            self._mig_trace.pop(uid, None)

    def abort_import(self, uid: int) -> None:
        """Transfer died before commit: free the whole reservation and the
        slot (the trie was never touched)."""
        seq = self.seqs.get(uid)
        if seq is None:
            return
        if seq.migrating != "in":
            raise RuntimeError(f"uid {uid} has no import in flight")
        self.seqs.pop(uid)
        self._mig_trace.pop(uid, None)
        if seq.blocks:
            self.allocator.free(seq.blocks)
        seq.blocks = []
        if seq.slot >= 0:
            self._free_slots.append(seq.slot)
            self._free_slots.sort()

    # --- radix pulls: prefix snapshot (export) and adopt (import) --------
    # Gang prefill reuses both legs: each member exports its merged chain
    # (snapshot_prefix), the next adopts it (adopt_prefix) and prefills
    # only its own segment on top.

    def snapshot_prefix(self, tokens, trace: str | None = None) -> dict | None:
        """Match and PIN the longest cached chain prefixing ``tokens`` so
        its payloads can be read while nothing evicts them. Returns
        ``{"handle", "blocks", "n_tokens"}`` or None on a miss; the caller
        must ``release_prefix(handle)`` once the payload is copied out."""
        if self.prefix_cache is None:
            return None
        nodes = self.prefix_cache.match(tokens)
        if not nodes:
            return None
        self.prefix_cache.acquire(nodes)
        self._pull_ctr += 1
        handle = self._pull_ctr
        self._pull_pins[handle] = nodes
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            rt.event(-1, "kv_pull", dir="out", pages=len(nodes),
                     trace=trace)
        return {"handle": handle, "blocks": [n.block for n in nodes],
                "n_tokens": len(nodes) * self.block_size}

    def release_prefix(self, handle: int) -> None:
        """Drop a prefix snapshot's pins (pages stay cached, LRU-able)."""
        nodes = self._pull_pins.pop(handle, None)
        if nodes:
            self.prefix_cache.release(nodes)

    def adopt_prefix(self, tokens, n_tokens: int,
                     trace: str | None = None) -> list[tuple[int, int]]:
        """Allocate a block per full page of ``tokens[:n_tokens]`` and
        insert the chain into the trie UNREFERENCED. Pages already cached
        dedup. Returns ``(page index, block)`` for the freshly inserted
        pages — the caller writes the payload into exactly those blocks.
        Raises RuntimeError when the pool cannot fit the chain."""
        bs = self.block_size
        n_full = min(n_tokens, len(tokens)) // bs
        if self.prefix_cache is None or n_full == 0:
            return []
        blocks = self._alloc(n_full)
        nodes, dups = self.prefix_cache.adopt(tokens, blocks, n_full * bs)
        self.prefix_cache.release(nodes)
        if dups:
            self.allocator.free(dups)
        fresh = [(j, nodes[j].block) for j in range(n_full)
                 if nodes[j].block == blocks[j]]
        rt = self.reqtrace
        if rt is not None and rt.enabled:
            rt.event(-1, "kv_pull", dir="in", pages=n_full,
                     fresh=len(fresh), trace=trace)
        return fresh

    def audit(self) -> None:
        """FULL-POOL audit: every non-trash block is owned by exactly one of
        {free list, prefix trie, one sequence's owned tail}; shared table
        entries point at live trie nodes; per-node refcounts equal the live
        sharers (sequences plus snapshot pins). Raises AssertionError on any
        leak, double-own or refcount drift; also a bad migration state, an
        importing sequence that already shares trie pages, or an exported
        one with work in flight."""
        free = list(self.allocator._free)
        if len(set(free)) != len(free):
            raise AssertionError("free list holds duplicate blocks")
        owners: dict[int, str] = {b: "free" for b in free}
        trie_blocks: set[int] = set()
        if self.prefix_cache is not None:
            self.prefix_cache.check()
            trie_blocks = self.prefix_cache.blocks()
            for b in trie_blocks:
                if b in owners:
                    raise AssertionError(f"block {b} in free list AND trie")
                owners[b] = "trie"
        ref_counts: dict[int, int] = {}
        for uid, seq in self.seqs.items():
            if seq.migrating not in (None, "out", "in"):
                raise AssertionError(
                    f"uid {uid}: bad migration state {seq.migrating!r}")
            if seq.migrating == "in" and seq.n_shared_blocks:
                raise AssertionError(
                    f"uid {uid}: importing sequence already shares "
                    f"{seq.n_shared_blocks} trie pages (seeding must "
                    f"happen at import_commit)")
            if seq.migrating == "out" and (seq.n_inflight
                                           or seq.n_provisional):
                raise AssertionError(
                    f"uid {uid}: exported sequence has in-flight work "
                    f"(inflight {seq.n_inflight}, provisional "
                    f"{seq.n_provisional}) — pages are not bit-stable")
            if seq.n_provisional < 0:
                raise AssertionError(
                    f"uid {uid}: negative provisional count "
                    f"{seq.n_provisional}")
            if seq.n_provisional:
                first = len(seq.tokens) - 1
                if first < seq.n_shared_blocks * self.block_size:
                    raise AssertionError(
                        f"uid {uid}: provisional slot {first} falls inside "
                        f"a shared prefix page")
                last = first + seq.n_provisional
                if last >= len(seq.blocks) * self.block_size:
                    raise AssertionError(
                        f"uid {uid}: provisional tokens reach slot {last} "
                        f"past the {len(seq.blocks)}-block reservation")
            for j, b in enumerate(seq.blocks):
                if j < seq.n_shared_blocks:
                    if b not in trie_blocks:
                        raise AssertionError(
                            f"uid {uid} shares block {b} not owned by the "
                            f"trie (stale page)")
                    ref_counts[b] = ref_counts.get(b, 0) + 1
                elif b in owners:
                    raise AssertionError(
                        f"block {b} owned by uid {uid} AND {owners[b]}")
                else:
                    owners[b] = f"uid {uid}"
        for nodes in self._pull_pins.values():
            for node in nodes:
                if node.block not in trie_blocks:
                    raise AssertionError(
                        f"pull pin on block {node.block} the trie no "
                        f"longer owns")
                ref_counts[node.block] = ref_counts.get(node.block, 0) + 1
        if self.prefix_cache is not None:
            for node in self.prefix_cache._nodes():
                expect = ref_counts.get(node.block, 0)
                if node.refs != expect:
                    raise AssertionError(
                        f"refcount drift on block {node.block}: trie says "
                        f"{node.refs}, {expect} live sequence(s) share it")
        n_all = self.allocator.num_blocks - 1     # block 0 is the trash slot
        if len(owners) != n_all:
            missing = set(range(1, self.allocator.num_blocks)) - set(owners)
            raise AssertionError(f"leaked blocks (owned by nobody): "
                                 f"{sorted(missing)}")


@dataclass
class StepPlan:
    """One scheduled forward step (the RaggedBatchWrapper analogue): plain
    int32 arrays of static shape [rows, T]."""
    kind: str                         # 'prefill' | 'decode'
    token_ids: np.ndarray             # [S, T] int32
    positions: np.ndarray             # [S, T] int32 (pad → 0)
    slot_map: np.ndarray              # [S, T] int32 → pool token slot (block*bs+off)
    active: np.ndarray                # [S, T] uint8 — real tokens
    block_tables: np.ndarray          # [S, max_blocks] int32
    seq_lens: np.ndarray              # [S] int32, length incl. this step's tokens
    sample_idx: np.ndarray            # [S] int32 index into T of last real token
    do_sample: np.ndarray             # [S] uint8 — emit a token for this slot
    use_last: np.ndarray = None       # [S] uint8 — col-0 token comes from the
    #                                   device-resident last-sampled array
    row_slots: np.ndarray = None      # [S] int32 — physical slot per plan row
    uids: list[int] = field(default_factory=list)   # uid per row (-1 = empty)
    dispatched: bool = False          # mark_dispatched ran
