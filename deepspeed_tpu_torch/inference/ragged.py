"""Host-side ragged batching state: blocked KV allocator + sequence manager.

The port's copy of ``deepspeed_tpu/inference/ragged.py`` (reference
inference/v2/ragged/: ``BlockedAllocator``, ``DSSequenceDescriptor``,
``DSStateManager``, ``RaggedBatchWrapper``). Device-agnostic numpy
bookkeeping: the allocator hands out fixed-size KV blocks of the device
pool, sequences own block lists, and each step's plan is plain int32
arrays the forward consumes.

Carried: the allocator, ``SequenceDescriptor`` with its committed and
scheduled views, the refcounted admit/release API over the shared-prefix
cache, the rollback-aware provisional API of speculative decoding with
the draft mirror's ``rewind``, the prefix snapshot/adopt pair of radix pulls and the full-pool ``audit()``.
The KV-page migration API (disaggregated serving) and the weight hot-swap
skew guard arrive with their slices.
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
    #: speculative candidate tokens whose KV may land in this sequence's
    #: owned tail pages ahead of acceptance; only the provisional API of
    #: StateManager mutates it
    n_provisional: int = 0

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
        """Nothing left to dispatch (committed-done or budget in flight)."""
        return self.done or self.gen_remaining_sched <= 0

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

    def attach_prefix_cache(self, cache) -> None:
        """Enable shared-prefix serving (before the first admit)."""
        if self.seqs:
            raise RuntimeError("attach_prefix_cache before admitting")
        self.prefix_cache = cache

    def _blocks_for(self, n_tokens: int) -> int:
        return min(-(-n_tokens // self.block_size), self.max_blocks_per_seq)

    def _alloc(self, n: int) -> list[int]:
        """Allocation that tops the free list up from the prefix LRU under
        pressure (unreferenced cached pages only)."""
        short = n - self.allocator.free_blocks
        if short > 0 and self.prefix_cache is not None:
            reclaimed = self.prefix_cache.evict(short)
            if reclaimed:
                self.allocator.free(reclaimed)
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
        self.seqs[uid] = seq
        return seq

    def release(self, uid: int) -> None:
        """Free a sequence's slot and pages. With a prefix cache attached,
        computed full pages are published into the trie instead of freed
        and shared pages drop their refcount. Callers must have committed
        in-flight steps referencing this uid first."""
        seq = self.seqs.pop(uid)
        if self.prefix_cache is not None and seq.slot >= 0:
            self._shared_nodes.pop(uid, None)
            to_free = self.prefix_cache.publish(
                seq.tokens, seq.blocks, seq.n_shared_blocks,
                min(seq.n_computed, len(seq.tokens)))
            if to_free:
                self.allocator.free(to_free)
        elif seq.blocks:
            self.allocator.free(seq.blocks)
        if seq.slot >= 0:
            self._free_slots.append(seq.slot)
            self._free_slots.sort()

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
        return out

    def rollback_provisional(self, uid: int) -> None:
        """Discard a provisioned-but-unverified tree."""
        seq = self.seqs.get(uid)
        if seq is not None:
            seq.n_provisional = 0

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

    # --- radix pulls: prefix snapshot (export) and adopt (import) --------

    def snapshot_prefix(self, tokens) -> dict | None:
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
        return {"handle": handle, "blocks": [n.block for n in nodes],
                "n_tokens": len(nodes) * self.block_size}

    def release_prefix(self, handle: int) -> None:
        """Drop a prefix snapshot's pins (pages stay cached, LRU-able)."""
        nodes = self._pull_pins.pop(handle, None)
        if nodes:
            self.prefix_cache.release(nodes)

    def adopt_prefix(self, tokens, n_tokens: int) -> list[tuple[int, int]]:
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
        return [(j, nodes[j].block) for j in range(n_full)
                if nodes[j].block == blocks[j]]

    def audit(self) -> None:
        """FULL-POOL audit: every non-trash block is owned by exactly one of
        {free list, prefix trie, one sequence's owned tail}; shared table
        entries point at live trie nodes; per-node refcounts equal the live
        sharers (sequences plus snapshot pins). Raises AssertionError on any
        leak, double-own or refcount drift."""
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
