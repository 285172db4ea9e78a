"""Content-addressed shared-prefix KV cache: a radix index over the paged
pool (vLLM PagedAttention block sharing plus SGLang RadixAttention's prefix
tree).

The port's copy of ``deepspeed_tpu/inference/prefix_cache.py`` — host
bookkeeping over block ids, free of any device or framework. Every node is
ONE full KV page keyed by the page's token ids under its parent chain, so
the trie path from the root commits to the whole prefix:

- ``match`` walks the trie with a prompt and returns the longest chain of
  cached full pages; the engine points the new sequence's block table at
  those blocks (``acquire`` refs them) and prefill starts at the cached
  page boundary.
- ``publish`` runs at sequence release: full computed pages become trie
  nodes (blocks donated to the cache); pages another sequence already
  published dedup (the duplicate block is returned for freeing).
- Unreferenced nodes form an LRU; ``evict`` reclaims them leaf-first and
  never touches a referenced node.

The JAX package's weight-version skew guard (weight hot-swap), KV-tier
eviction sink and router residency digests belong to later slices of the
port and are not carried here. :class:`~.ragged.StateManager` owns the
allocator and is the only caller.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field


@dataclass
class PageNode:
    """One cached full page: ``key`` = this page's token ids (the chain
    context lives in the path), ``block`` = the pool block holding its KV,
    ``refs`` = live sequences whose block table points at ``block``."""
    key: tuple[int, ...]
    block: int
    parent: "PageNode | None"
    refs: int = 0
    last_used: int = 0
    children: dict[tuple[int, ...], "PageNode"] = field(default_factory=dict)

    @property
    def evictable(self) -> bool:
        # leaf-first: children are only reachable THROUGH this node
        return self.refs == 0 and not self.children


class PrefixCache:
    """Radix index mapping prefix chains → pool block ids (host-side)."""

    def __init__(self, block_size: int):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = block_size
        self.root = PageNode(key=(), block=-1, parent=None, refs=1)
        self._clock = 0              # LRU stamp (monotone per operation)
        self._n_nodes = 0
        # lifetime stats (the engine folds these into its stats dict)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.lookups = 0
        self.inserted_pages = 0
        self.deduped_pages = 0
        self.evicted_pages = 0

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return self._n_nodes

    def _nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    @property
    def cached_blocks(self) -> int:
        """Blocks the trie owns (referenced + LRU)."""
        return self._n_nodes

    @property
    def referenced_blocks(self) -> int:
        return sum(1 for n in self._nodes() if n.refs > 0)

    @property
    def evictable_blocks(self) -> int:
        """Blocks reclaimable under allocation pressure: every refs==0 node
        whose subtree holds no referenced page (eviction cascades
        leaf-first through an unreferenced chain). One post-order pass —
        this sits on the admission path (StateManager.can_admit)."""
        n = 0
        stack = [(c, False) for c in self.root.children.values()]
        pinned: dict[int, bool] = {}        # id(node) -> subtree has refs
        while stack:
            node, expanded = stack.pop()
            if not expanded:
                stack.append((node, True))
                stack.extend((c, False) for c in node.children.values())
                continue
            sub = node.refs > 0 or any(pinned[id(c)]
                                       for c in node.children.values())
            pinned[id(node)] = sub
            if not sub:
                n += 1
        return n

    def blocks(self) -> set[int]:
        """Every block id the trie currently owns (pool audit)."""
        return {n.block for n in self._nodes()}

    # -- the read path ----------------------------------------------------
    def match(self, tokens, max_tokens: int | None = None) -> list[PageNode]:
        """Longest chain of cached full pages prefixing ``tokens``
        (≤ ``max_tokens`` tokens). Read-only: callers that adopt the chain
        must ``acquire`` it in the same host operation."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens,
                                                           len(tokens))
        node, out = self.root, []
        for j in range(limit // bs):
            child = node.children.get(tuple(tokens[j * bs:(j + 1) * bs]))
            if child is None:
                break
            out.append(child)
            node = child
        self.lookups += 1
        self.lookup_tokens += len(tokens)
        self.hit_tokens += len(out) * bs
        return out

    def acquire(self, nodes: list[PageNode]) -> None:
        """A sequence adopted this chain: pin every page."""
        self._clock += 1
        for n in nodes:
            n.refs += 1
            n.last_used = self._clock

    def release(self, nodes: list[PageNode]) -> None:
        """Drop a sequence's pins (refs==0 pages become LRU-evictable)."""
        self._clock += 1
        for n in nodes:
            if n.refs <= 0:
                raise RuntimeError(
                    f"prefix cache refcount underflow on block {n.block}")
            n.refs -= 1
            n.last_used = self._clock

    # -- the write path ---------------------------------------------------
    def _insert(self, node: PageNode, key, block: int) -> PageNode:
        child = PageNode(key=key, block=block, parent=node)
        node.children[key] = child
        self._n_nodes += 1
        self.inserted_pages += 1
        return child

    def publish(self, tokens, blocks: list[int], n_shared: int,
                n_tokens: int) -> list[int]:
        """Fold a released sequence's pages into the trie.

        ``blocks[j]`` holds page ``j`` of ``tokens``; the first ``n_shared``
        pages are existing trie nodes the sequence acquired at admit (their
        refs drop here), the rest are owned. Owned full pages with computed
        KV (``n_tokens`` tokens really are in the pool) are inserted unless
        an identical chain node already exists, in which case the duplicate
        block is surrendered. Returns every block the caller must hand back
        to the allocator: duplicates, partial pages, the unused tail."""
        bs = self.block_size
        n_full = min(n_tokens, len(tokens)) // bs
        if n_full > len(blocks):
            raise ValueError(f"{n_full} computed pages but only "
                             f"{len(blocks)} blocks")
        if n_shared > n_full:
            raise ValueError(f"n_shared {n_shared} exceeds computed full "
                             f"pages {n_full}")
        self._clock += 1
        node = self.root
        to_free: list[int] = []
        for j in range(n_full):
            key = tuple(tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if j < n_shared:
                # the shared pages ARE these nodes by construction — a
                # mismatch means table and trie disagree (stale-serve hazard)
                if child is None or child.block != blocks[j]:
                    raise RuntimeError(
                        f"prefix cache chain mismatch at page {j}: "
                        f"sequence shares block {blocks[j]} but the trie "
                        f"holds {child.block if child else None}")
                child.refs -= 1
                if child.refs < 0:
                    raise RuntimeError(
                        f"prefix cache refcount underflow on block "
                        f"{child.block}")
            elif child is not None:
                to_free.append(blocks[j])        # dedup: surrender our copy
                self.deduped_pages += 1
            else:
                child = self._insert(node, key, blocks[j])
            child.last_used = self._clock
            node = child
        to_free.extend(blocks[n_full:])
        return to_free

    def adopt(self, tokens, blocks: list[int],
              n_tokens: int) -> tuple[list[PageNode], list[int]]:
        """Insert-and-pin a page chain whose payload the caller wrote into
        ``blocks`` (radix pulls): every full page of ``tokens[:n_tokens]``
        becomes a trie node holding the caller's block, unless an identical
        chain page is already cached, in which case the caller's copy is
        surrendered. The whole chain is acquired before returning. Returns
        ``(chain nodes, surrendered duplicate blocks)``."""
        bs = self.block_size
        n_full = min(n_tokens, len(tokens)) // bs
        if n_full > len(blocks):
            raise ValueError(f"{n_full} imported pages but only "
                             f"{len(blocks)} blocks")
        self._clock += 1
        node = self.root
        out: list[PageNode] = []
        to_free: list[int] = []
        for j in range(n_full):
            key = tuple(tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is not None:
                to_free.append(blocks[j])
                self.deduped_pages += 1
            else:
                child = self._insert(node, key, blocks[j])
            child.refs += 1
            child.last_used = self._clock
            out.append(child)
            node = child
        return out, to_free

    # -- eviction ---------------------------------------------------------
    def evict(self, n: int) -> list[int]:
        """Reclaim up to ``n`` blocks, least-recently-used first,
        leaf-first. Referenced pages are never taken; interior pages only
        fall after their whole subtree has. One scan seeds a heap of
        evictable leaves and a parent enters it when its last child falls.
        Returns the freed block ids."""
        out: list[int] = []
        if n <= 0:
            return out
        heap: list[tuple[int, int, PageNode]] = []
        tie = 0                     # PageNode isn't orderable
        for node in self._nodes():
            if node.evictable:
                heapq.heappush(heap, (node.last_used, tie, node))
                tie += 1
        while heap and len(out) < n:
            _, _, victim = heapq.heappop(heap)
            del victim.parent.children[victim.key]
            self._n_nodes -= 1
            self.evicted_pages += 1
            out.append(victim.block)
            parent = victim.parent
            if parent is not self.root and parent.evictable:
                heapq.heappush(heap, (parent.last_used, tie, parent))
                tie += 1
        return out

    # -- audit -------------------------------------------------------------
    def check(self) -> None:
        """Internal-consistency assert: refcounts are non-negative, node
        count matches the tree, block ids are unique."""
        seen: set[int] = set()
        count = 0
        for node in self._nodes():
            count += 1
            if node.refs < 0:
                raise AssertionError(f"negative refs on block {node.block}")
            if node.block in seen:
                raise AssertionError(f"block {node.block} appears twice "
                                     f"in the trie")
            seen.add(node.block)
        if count != self._n_nodes:
            raise AssertionError(f"node count drift: walked {count}, "
                                 f"tracked {self._n_nodes}")

    def stats(self) -> dict:
        return {
            "cached_pages": self._n_nodes,
            "referenced_pages": self.referenced_blocks,
            "hit_tokens": self.hit_tokens,
            "lookup_tokens": self.lookup_tokens,
            "lookups": self.lookups,
            "inserted_pages": self.inserted_pages,
            "deduped_pages": self.deduped_pages,
            "evicted_pages": self.evicted_pages,
        }
