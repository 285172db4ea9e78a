"""Prefix-cache-aware placement: put a request where its KV already is.

The router hashes an incoming prompt's page-aligned prefix chain
(``inference.prefix_cache.chain_hashes`` — the same structural radix key
the replica-side trie uses) and prefers the replica whose residency
digest holds the LONGEST chain: every matched page is prefill compute
the replica skips and pool pages it shares (SGLang-router-style
cache-aware routing). Two signals feed the decision:

- **digest** (ground truth, lags): each replica heartbeats the chain
  hashes of pages its prefix cache actually holds. Pages enter the trie
  at sequence release, so the digest trails live traffic by one request
  lifetime.
- **sticky map** (estimate, immediate): the router remembers its own
  recent placements by chain hash. Two same-prefix requests arriving
  back-to-back co-locate even before the first releases — exactly the
  burst the shared-prefix cache exists for.

Fallback is least-loaded over the replica heartbeats' load summaries.
A dead/draining replica never appears in ``candidates`` — the caller
(router) filters states first.
"""
from __future__ import annotations

from collections import OrderedDict

from ..inference.prefix_cache import chain_hashes  # noqa: F401  (re-export:
#     the router and tests hash prompts with THE SAME function the
#     replica-side trie digests are built from)


def load_score(load: dict | None) -> float:
    """Scalar backlog estimate from a replica heartbeat's load summary:
    live sequences dominate, queued-but-unscheduled tokens break ties
    (256 tokens ~ one sequence's worth of pending work)."""
    if not load:
        return 0.0
    return float(load.get("live", 0)) \
        + float(load.get("pending_tokens", 0)) / 256.0


def match_pages(chain: list[int], digest) -> int:
    """Longest cached prefix (in pages) of a prompt chain against one
    replica's residency digest. Chain hashes commit to their whole path,
    so membership of ``chain[j]`` alone proves the replica holds all of
    pages ``0..j`` — scan from the deep end."""
    if not digest:
        return 0
    for j in range(len(chain) - 1, -1, -1):
        if chain[j] in digest:
            return j + 1
    return 0


class StickyMap:
    """Bounded LRU of the router's own recent placements, keyed by chain
    hash: chain hash -> replica slot. Purely an estimate (the replica may
    have evicted since), so a hit only biases placement — correctness
    never depends on it."""

    def __init__(self, cap: int = 4096):
        self.cap = cap
        self._m: OrderedDict[int, int] = OrderedDict()
        #: chain-head hash -> times noted/hit. Deliberately NOT cleared
        #: by forget_slot: hotness belongs to the PREFIX, not the slot
        #: that held it — it ranks elastic pre-warm pushes after the
        #: slot is gone (serving/elastic.py).
        self.hits: OrderedDict[int, int] = OrderedDict()

    def _heat_bump(self, h: int) -> None:
        self.hits[h] = self.hits.pop(h, 0) + 1
        while len(self.hits) > self.cap:
            self.hits.popitem(last=False)

    def note(self, chain: list[int], slot: int) -> None:
        for h in chain:
            self._m.pop(h, None)
            self._m[h] = slot
        if chain:
            self._heat_bump(chain[-1])
        while len(self._m) > self.cap:
            self._m.popitem(last=False)

    def heat(self, chain: list[int]) -> int:
        """Hotness of the deepest remembered hash on ``chain`` (0 =
        never seen) — the pre-warm ranking signal."""
        for j in range(len(chain) - 1, -1, -1):
            n = self.hits.get(chain[j])
            if n:
                return n
        return 0

    def lookup(self, chain: list[int],
               allowed: set[int] | None = None) -> tuple[int, int] | None:
        """(slot, matched_pages) for the deepest remembered chain hash.

        ``allowed`` restricts the walk to slots the caller can actually
        use: a deeper entry pointing at an ineligible slot must not
        SHADOW a shallower eligible one. (The concrete case: a request's
        own dispatch noted its full prompt chain at the prefill-role
        replica, one page deeper than the tenant's shared prefix — a
        handoff relay that can only target decode-capable slots would
        otherwise discard the sticky signal entirely and fall back to
        lagging load estimates, splitting same-tenant bundles across
        decode replicas.)"""
        for j in range(len(chain) - 1, -1, -1):
            slot = self._m.get(chain[j])
            if slot is not None and (allowed is None or slot in allowed):
                self._heat_bump(chain[j])
                return slot, j + 1
        return None

    def forget_slot(self, slot: int) -> None:
        """A replica died/restarted: its remembered residency is gone."""
        for h in [h for h, s in self._m.items() if s == slot]:
            del self._m[h]


def best_digest_peer(chain: list[int], handles, exclude_slot: int = -1,
                     weight_version: dict | None = None
                     ) -> tuple[object | None, int]:
    """Deepest residency-digest match for ``chain`` across ``handles``,
    excluding one slot (the replica the request was just placed on).
    Returns ``(handle, matched_pages)`` — the pull-source candidate for
    placement-time radix pulls. Ties break toward the lower slot
    (determinism: chaos tests replay placement). Only the DIGEST counts
    here, never the sticky map: a pull ships real pages, so the source
    must actually hold them.

    ``weight_version`` (the PULLING replica's ``{"id", "digest"}``)
    filters the candidates to same-version peers: during a rolling
    deploy two replicas may serve different weights, and a chain
    computed under one must never seed the other — the skew-safe path
    is to never even attempt the pull (the caller counts the skip and
    the puller recomputes, the always-safe fallback). ``None`` on either
    side skips the filter (pre-versioning peers)."""
    best, pages = None, 0
    for h in handles:
        if h.slot == exclude_slot:
            continue
        hv = getattr(h, "wv", None)
        if weight_version is not None and hv is not None \
                and hv != weight_version:
            continue                     # cross-version peer: never pull
        # a peer can serve a pull from its HBM radix OR its KV tier
        # (inference/kvtier.py — the export leg promotes/extracts from
        # the tier when it runs deeper), so residency is the union
        m = max(match_pages(chain, h.digest),
                match_pages(chain, getattr(h, "tier_digest", None)))
        if m > pages or (m == pages and m > 0 and best is not None
                         and h.slot < best.slot):
            best, pages = h, m
    return best, pages


def transfer_time(pages: int, page_bytes: int, bytes_s: float,
                  overhead_s: float = 0.0) -> float:
    """Estimated seconds to move ``pages`` over a transport/tier rated
    ``bytes_s``, plus a fixed per-transfer overhead (control round
    trips / file opens). Unknown page geometry (``page_bytes`` 0 — no
    bundle seen yet) prices only the overhead, mirroring
    :func:`pull_beats_recompute`'s first-leg optimism."""
    if pages <= 0:
        return 0.0
    return overhead_s + pages * page_bytes / max(bytes_s, 1e-9)


def plan_kv_source(chain_pages: int, hit_pages: int, peer_pages: int,
                   tier_pages: int, page_bytes: int, block_size: int,
                   prefill_tok_s: float, pull_bytes_s: float,
                   tier_bytes_s: float, overhead_s: float = 0.0,
                   min_pages: int = 1, *, push_pages: int = 0,
                   overlap: bool = False) -> str:
    """The KV-sourcing decision for a placed request: ``"pull"`` (ship
    the chain from the deepest same-version peer's HBM radix),
    ``"tier"`` (let the placed replica promote from its own host-RAM/
    NVMe KV tier — inference/kvtier.py), ``"push"`` (a proactive push
    of the chain is ALREADY in flight toward the placed replica —
    serving/push.py — so the put just joins it instead of starting new
    movement), or ``"recompute"``.

    Each option's cost = transfer time for the pages it covers beyond
    the placed replica's HBM hit (``hit_pages``) + prefill time for the
    tokens nothing covers. With ``overlap`` the replica prefills the
    suffix WHILE the transfer lands (transfer/compute overlap), so the
    two legs cost ``max(xfer, prefill)`` instead of their sum — the
    transfer hides behind compute whenever the suffix is long enough.
    The tier rate should be the CONSERVATIVE (NVMe) rate — the router
    cannot see which sub-tier holds the chain, and recompute/tier are
    both safe while a pull burns fleet messages. Options that do not
    beat the placed replica's hit by ``min_pages`` drop out; exact ties
    prefer recompute over tier over push over pull (cheaper machinery
    first — a push join rides movement already paid for, a pull starts
    new movement). Recompute stays the always-safe FALLBACK regardless
    of what this returns — the decision only picks what to TRY first."""
    bs = max(block_size, 1)
    chain_pages = max(chain_pages, hit_pages, peer_pages, tier_pages,
                      push_pages)

    def total(covered: int, rate: float) -> float:
        xfer = transfer_time(covered - hit_pages, page_bytes, rate,
                             overhead_s)
        prefill = (chain_pages - covered) * bs \
            / max(prefill_tok_s, 1e-9)
        if overlap and covered > hit_pages:
            return max(xfer, prefill)
        return xfer + prefill

    best, best_t = "recompute", total(hit_pages, 1.0)
    if tier_pages - hit_pages >= min_pages:
        t = total(tier_pages, tier_bytes_s)
        if t < best_t:
            best, best_t = "tier", t
    if push_pages - hit_pages >= min_pages:
        t = total(push_pages, pull_bytes_s)
        if t < best_t:
            best, best_t = "push", t
    if peer_pages - hit_pages >= min_pages:
        t = total(peer_pages, pull_bytes_s)
        if t < best_t:
            best, best_t = "pull", t
    return best


def pull_beats_recompute(extra_tokens: int, page_bytes: int,
                         block_size: int, prefill_tok_s: float,
                         xfer_bytes_s: float,
                         overhead_s: float = 0.0) -> bool:
    """The pull-vs-recompute cost model: ship the chain only when the
    estimated transfer time (pages over the transport's byte rate, plus
    a fixed per-transfer overhead for the control round-trips) beats the
    estimated prefill time (tokens over the replica's prefill rate).
    Recompute is the always-safe fallback, so every estimate errs toward
    recompute: unknown page geometry (``page_bytes`` 0 — no bundle seen
    yet) assumes the transfer is cheap only for the decision's FIRST leg
    and lets the deadline machinery bound the real cost."""
    if extra_tokens <= 0:
        return False
    prefill_s = extra_tokens / max(prefill_tok_s, 1e-9)
    pages = -(-extra_tokens // max(block_size, 1))
    xfer_s = overhead_s + pages * page_bytes / max(xfer_bytes_s, 1e-9)
    return xfer_s < prefill_s


def gang_segments(chain_pages: int, k: int) -> list[int]:
    """Page-aligned cumulative segment ends for a gang of ``k``: member
    ``i`` prefills pages ``[ends[i-1] .. ends[i])`` (``ends[0]`` from
    page 0; ``ends[-1] == chain_pages``). A chain too short for ``k``
    members yields fewer ends — the caller gangs with ``len(ends)``."""
    seg = -(-max(chain_pages, 0) // max(k, 1))
    ends, e = [], 0
    while e < chain_pages:
        e = min(e + seg, chain_pages)
        ends.append(e)
    return ends


def plan_gang_prefill(chain_pages: int, hit_pages: int, k_max: int,
                      page_bytes: int, block_size: int,
                      prefill_tok_s: float, xfer_bytes_s: float,
                      overhead_s: float = 0.0) -> int:
    """Gang-of-K vs single-replica prefill wall-clock: returns the best
    K, or 1 when no gang strictly beats prefilling on one replica.

    The gang splits the page-aligned prompt chain into K contiguous
    segments; every member prefills its OWN segment concurrently
    (segment KV depends causally only on EARLIER segments — the members
    attend over adopted prefix pages plus their own), then the merged
    root-contiguous chain grows member to member in K-1 staged hops,
    hop i shipping pages ``[0 .. end_i)`` forward::

        single  = (chain_pages - hit_pages) * bs / prefill_tok_s
        gang(K) = ceil(chain_pages / K) * bs / prefill_tok_s
                  + sum_i xfer(end_i)            # K-1 relay hops

    The estimate deliberately ignores the final pinned put's tail
    prefill (at most one partial page plus the last token — identical
    under both plans) and prices hops with the SAME
    :func:`transfer_time` model pulls use, so the probe/constant rates
    feed both decisions. ``hit_pages`` (the best single-replica digest
    hit) only strengthens the single plan: a prompt the fleet has
    mostly cached must never gang."""
    if chain_pages <= 0 or k_max < 2:
        return 1
    bs = max(block_size, 1)
    tok_s = max(prefill_tok_s, 1e-9)
    best_k, best_t = 1, (chain_pages - hit_pages) * bs / tok_s
    for k in range(2, min(k_max, chain_pages) + 1):
        ends = gang_segments(chain_pages, k)
        t = (ends[0] if len(ends) < 2 else max(
            e - s for s, e in zip([0] + ends, ends))) * bs / tok_s
        for end_i in ends[:-1]:
            t += transfer_time(end_i, page_bytes, xfer_bytes_s,
                               overhead_s)
        if t < best_t:
            best_k, best_t = len(ends), t
    return best_k


def pick_replica(candidates: list, chain: list[int],
                 sticky: StickyMap | None = None) -> tuple[object, int]:
    """Choose a replica for a request whose prompt chain is ``chain``.

    ``candidates``: objects with ``.slot`` (int), ``.digest`` (set of
    chain hashes or None) and ``.load`` (heartbeat load dict or None) —
    the router's READY replicas with admission headroom. Returns
    ``(replica, est_hit_pages)`` where the estimate is the matched pages
    backing the decision (the placement-quality counter's numerator).
    Preference order: deepest digest match, then deepest sticky-map
    match, then least loaded; every tie breaks toward the lower load,
    then the lower slot (determinism — chaos tests replay placement)."""
    if not candidates:
        raise ValueError("no candidate replicas")
    best, best_key, best_hit = None, None, 0
    sticky_hit = sticky.lookup(chain, {c.slot for c in candidates}) \
        if sticky is not None else None
    for rep in candidates:
        pages = match_pages(chain, rep.digest)
        s_pages = sticky_hit[1] \
            if sticky_hit is not None and sticky_hit[0] == rep.slot else 0
        # KV-tier residency (kvtier.py) breaks ties behind the HBM
        # signals: a replica that can PROMOTE the chain locally beats
        # one that must recompute it, but never outranks real HBM pages
        # or the sticky estimate (promotes cost a host copy)
        t_pages = match_pages(chain, getattr(rep, "tier_digest", None))
        # digest outranks sticky at any depth (it is ground truth)
        key = (pages, s_pages, t_pages, -load_score(rep.load), -rep.slot)
        if best_key is None or key > best_key:
            best, best_key, best_hit = rep, key, max(pages, s_pages)
    return best, best_hit
