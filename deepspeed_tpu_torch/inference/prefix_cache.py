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
  never touches a referenced node. With an :attr:`PrefixCache.evict_sink`
  (the KV tier, ``inference/kvtier.py``) eviction DEMOTES the victims'
  chains instead of losing them.
- Every node carries the weight version it was computed under (``wv``): a
  weight swap (:meth:`PrefixCache.set_weight_version`) makes older nodes
  invisible to ``match`` and to the residency digest.
- :func:`chain_hashes` / :meth:`PrefixCache.residency_digest` are the
  blake2b chain hashes a serving router matches prompts against; they equal
  the JAX package's for the same tokens.

:class:`~.ragged.StateManager` owns the allocator and is the only caller of
the mutating surface (``bin/check_state_invariants.py``).
"""
from __future__ import annotations

import hashlib
import heapq
import struct
from dataclasses import dataclass, field


def page_hash(parent: int, key) -> int:
    """Stable 64-bit hash of one page under its parent chain: processes must
    agree on it (python's builtin ``hash`` is salted per process), so it is
    blake2b over the parent hash + the page's token ids."""
    h = hashlib.blake2b(digest_size=8)
    h.update(int(parent).to_bytes(8, "little", signed=False))
    h.update(struct.pack(f"<{len(key)}q", *(int(t) for t in key)))
    return int.from_bytes(h.digest(), "little")


def chain_hashes(tokens, block_size: int) -> list[int]:
    """Rolling chain hash at every full-page boundary of ``tokens``:
    ``out[j]`` commits to tokens ``[0, (j+1)*block_size)`` — the wire form
    of the trie's path key."""
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    out: list[int] = []
    h = 0
    for j in range(len(tokens) // block_size):
        h = page_hash(h, tokens[j * block_size:(j + 1) * block_size])
        out.append(h)
    return out


class DemoteError(RuntimeError):
    """A demotion the eviction sink could not store (the tier refused the
    chain, or its crc, version or file I/O failed): eviction proceeds
    without it and recompute covers the chain. Any other exception of a sink
    (a failed device gather) reaches the caller of :meth:`PrefixCache.evict`
    with the trie untouched."""


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
    #: full-path chain hash (:func:`page_hash` over the parent's), computed
    #: once at insert
    chain_hash: int = 0
    #: the cache's :attr:`PrefixCache.weight_version` at insert: a node
    #: whose stamp trails the cache's holds KV computed under OLD weights —
    #: ``match`` and ``residency_digest`` skip it
    wv: int = 0
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
        #: bumped on every digest-affecting mutation (insert/evict)
        self.version = 0
        #: monotonic id of the weights every cached page was computed
        #: under; only :meth:`set_weight_version` writes it
        self.weight_version = 0
        # lifetime stats (the engine folds these into its stats dict)
        self.hit_tokens = 0
        self.lookup_tokens = 0
        self.lookups = 0
        self.inserted_pages = 0
        self.deduped_pages = 0
        self.evicted_pages = 0
        #: KV-tier eviction sink: ``sink(chains)``, ``chains`` a list of
        #: ``(path tokens, path blocks)`` — the full root chain of every
        #: current-version page about to be reclaimed. It runs inside
        #: :meth:`evict` BEFORE any victim leaves the trie, so the device
        #: payloads are intact and a sink that raises leaves the cache as
        #: it was; a :class:`DemoteError` is counted (``demote_errors``) and
        #: eviction proceeds without demotion.
        self.evict_sink = None
        #: per-request lifecycle tracer (telemetry/reqtrace.py, duck-typed)
        #: — engine_v2 attaches it; evictions are pool-level events (the
        #: reclaimed pages had no live owner), so they land in the
        #: tracer's unattributed ring; the admitting request's own
        #: timeline carries the count via its admit event
        self.reqtrace = None
        self.demote_errors = 0

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

    def set_weight_version(self, wid: int) -> None:
        """Record a completed same-shape weight swap: every node inserted
        before it becomes stale (invisible to ``match`` and the digest),
        also pages still pinned by pre-swap sequences. The unpinned ones are
        evicted by ``StateManager.flush_prefix_cache``; pinned stale nodes
        age out through the LRU once released."""
        if wid != self.weight_version:
            self.weight_version = int(wid)
            self.version += 1          # force a digest re-ship

    def residency_digest(self, max_entries: int = 4096) -> list[int]:
        """Chain hashes (:func:`chain_hashes` scheme) of every current-
        version cached page, capped at ``max_entries`` most-recently-used:
        the residency summary a serving replica ships so a router can place
        a request where its longest prefix chain already is."""
        out = [(n.last_used, n.chain_hash) for n in self._nodes()
               if n.wv == self.weight_version]
        if len(out) > max_entries:
            out.sort(reverse=True)               # keep the most recent
            out = out[:max_entries]
        return [h for _, h in out]

    # -- the read path ----------------------------------------------------
    def match(self, tokens, max_tokens: int | None = None) -> list[PageNode]:
        """Longest chain of current-version cached full pages prefixing
        ``tokens`` (≤ ``max_tokens`` tokens). Read-only: callers that adopt
        the chain must ``acquire`` it in the same host operation."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens,
                                                           len(tokens))
        node, out = self.root, []
        for j in range(limit // bs):
            child = node.children.get(tuple(tokens[j * bs:(j + 1) * bs]))
            if child is None or child.wv != self.weight_version:
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

    def cached_depth(self, tokens, max_tokens: int | None = None) -> int:
        """READ-ONLY depth (in pages) of the longest current-version cached
        chain prefixing ``tokens``: no pins, no LRU touch, no stats (the KV
        tier's promote gate must not perturb the cache it warms)."""
        bs = self.block_size
        limit = len(tokens) if max_tokens is None else min(max_tokens,
                                                           len(tokens))
        node, depth = self.root, 0
        for j in range(limit // bs):
            child = node.children.get(tuple(tokens[j * bs:(j + 1) * bs]))
            if child is None or child.wv != self.weight_version:
                break
            depth += 1
            node = child
        return depth

    # -- stale-version subtrees -------------------------------------------
    # Nothing fresh is ever inserted UNDER a stale node (the write paths
    # replace-or-stop instead of walking in), so a stale node's whole
    # subtree is stale, removable as a unit once nothing in it is pinned.

    def _subtree_pinned(self, node: PageNode) -> bool:
        stack = [node]
        while stack:
            n = stack.pop()
            if n.refs > 0:
                return True
            stack.extend(n.children.values())
        return False

    def _remove_subtree(self, parent: PageNode,
                        child: PageNode) -> list[int]:
        """Detach ``child`` and everything under it, returning the freed
        block ids (the caller checked :meth:`_subtree_pinned`)."""
        del parent.children[child.key]
        out: list[int] = []
        stack = [child]
        while stack:
            n = stack.pop()
            out.append(n.block)
            self._n_nodes -= 1
            self.evicted_pages += 1
            stack.extend(n.children.values())
        self.version += 1
        return out

    # -- the write path ---------------------------------------------------
    def _insert(self, node: PageNode, key, block: int) -> PageNode:
        child = PageNode(key=key, block=block, parent=node,
                         wv=self.weight_version,
                         chain_hash=page_hash(node.chain_hash, key))
        node.children[key] = child
        self._n_nodes += 1
        self.inserted_pages += 1
        self.version += 1
        return child

    def publish(self, tokens, blocks: list[int], n_shared: int,
                n_tokens: int) -> list[int]:
        """Fold a released sequence's pages into the trie.

        ``blocks[j]`` holds page ``j`` of ``tokens``; the first ``n_shared``
        pages are existing trie nodes the sequence acquired at admit (their
        refs drop here), the rest are owned. Owned full pages with computed
        KV (``n_tokens`` tokens really are in the pool) are inserted unless
        an identical chain node already exists, in which case the duplicate
        block is surrendered; a stale-version node in the way is replaced
        when its subtree is unpinned, else caching stops there. Returns
        every block the caller must hand back to the allocator."""
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
            elif child is not None and child.wv != self.weight_version:
                # a stale-version subtree: replace it when nothing below is
                # pinned, else stop caching here (a miss, never a
                # cross-version serve)
                if self._subtree_pinned(child):
                    to_free.extend(blocks[j:])
                    return to_free
                to_free.extend(self._remove_subtree(node, child))
                child = self._insert(node, key, blocks[j])
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
        ``blocks`` (migration imports, radix pulls, tier promotes): every
        full page of ``tokens[:n_tokens]`` becomes a trie node holding the
        caller's block, unless an identical chain page is already cached,
        in which case the caller's copy is surrendered. The whole chain is
        acquired before returning. Refused (before any mutation) when a
        pinned stale-version page lies on the chain. Returns ``(chain
        nodes, surrendered duplicate blocks)``."""
        bs = self.block_size
        n_full = min(n_tokens, len(tokens)) // bs
        if n_full > len(blocks):
            raise ValueError(f"{n_full} imported pages but only "
                             f"{len(blocks)} blocks")
        j = self.stale_pin_depth(tokens, n_tokens)
        if j is not None:
            raise RuntimeError(
                f"prefix cache holds a pinned stale-version page "
                f"at depth {j} (weight swap in flight); adopt "
                f"refused")
        self._clock += 1
        node = self.root
        out: list[PageNode] = []
        to_free: list[int] = []
        for j in range(n_full):
            key = tuple(tokens[j * bs:(j + 1) * bs])
            child = node.children.get(key)
            if child is not None and child.wv != self.weight_version:
                to_free.extend(self._remove_subtree(node, child))
                child = None
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

    def stale_pin_depth(self, tokens, n_tokens: int) -> int | None:
        """READ-ONLY: the depth of the first cached page of
        ``tokens[:n_tokens]``'s chain that is stale-version with a pinned
        subtree (``adopt`` refuses such a chain), else None."""
        bs = self.block_size
        scan = self.root
        for j in range(min(n_tokens, len(tokens)) // bs):
            child = scan.children.get(tuple(tokens[j * bs:(j + 1) * bs]))
            if child is None:
                return None
            if child.wv != self.weight_version \
                    and self._subtree_pinned(child):
                return j
            scan = child
        return None

    # -- eviction ---------------------------------------------------------
    def _path(self, node: PageNode) -> list[PageNode]:
        path: list[PageNode] = []
        while node is not None and node is not self.root:
            path.append(node)
            node = node.parent
        return path[::-1]

    def evict(self, n: int, demote: bool = True) -> list[int]:
        """Reclaim up to ``n`` blocks, least-recently-used first,
        leaf-first. Referenced pages are never taken; interior pages only
        fall after their whole subtree has (one scan seeds a heap of
        evictable leaves; a parent enters it when its last child is taken).
        Returns the freed block ids.

        With an :attr:`evict_sink` and ``demote=True``, the full root chain
        of every current-version victim goes to the sink before any victim
        leaves the trie (see :class:`DemoteError`). ``demote=False`` is the
        weight-swap flush (``StateManager.flush_prefix_cache``): stale
        pages drop, never tier."""
        if n <= 0:
            return []
        heap: list[tuple[int, int, PageNode]] = []
        tie = 0                     # PageNode isn't orderable
        for node in self._nodes():
            if node.evictable:
                heapq.heappush(heap, (node.last_used, tie, node))
                tie += 1
        victims: list[PageNode] = []
        left: dict[int, int] = {}   # id(parent) -> children not yet taken
        while heap and len(victims) < n:
            _, _, victim = heapq.heappop(heap)
            victims.append(victim)
            parent = victim.parent
            if parent is not self.root and parent.refs == 0:
                k = left.get(id(parent), len(parent.children)) - 1
                left[id(parent)] = k
                if k == 0:
                    heapq.heappush(heap, (parent.last_used, tie, parent))
                    tie += 1
        sink = self.evict_sink if demote else None
        if sink is not None:
            demoting = [([t for nd in path for t in nd.key],
                         [nd.block for nd in path])
                        for path in (self._path(v) for v in victims
                                     if v.wv == self.weight_version)]
            if demoting:
                try:
                    sink(demoting)
                except DemoteError as e:
                    # demotion is best-effort: recompute covers the chains
                    self.demote_errors += 1
                    from ..utils.logging import logger
                    logger.warning(f"prefix cache: eviction sink failed "
                                   f"({e}); {len(demoting)} chain(s) "
                                   f"evicted without demotion")
        for victim in victims:
            del victim.parent.children[victim.key]
            self._n_nodes -= 1
            self.evicted_pages += 1
            self.version += 1
        out = [v.block for v in victims]
        rt = self.reqtrace
        if rt is not None and rt.enabled and out:
            rt.event(-1, "evict", pages=len(out), cached=self._n_nodes)
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
            "demote_errors": self.demote_errors,
        }
