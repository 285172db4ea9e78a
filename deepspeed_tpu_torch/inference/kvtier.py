"""KV tiering: HBM → host RAM → NVMe under the fleet radix.

The port's copy of ``deepspeed_tpu/inference/kvtier.py``, free of any
framework there already. Spill segments (the ``KVT1`` framing below) are
the JAX package's byte for byte: a segment written by either package opens
in the other. The fault points come through the port's
``runtime/resilience.FaultInjector``.

The distributed prefix cache (prefix_cache.py + the serving tier's
placement-time radix pulls) is bounded by aggregate replica HBM: LRU
eviction throws away prefix chains that will recur in minutes, so at
scale the fleet hit rate plateaus and every miss pays a full prefill.
Mooncake (Qin et al., KVCache-centric disaggregated serving) shows a
host-RAM/SSD KV tier behind the placement layer is the single biggest
lever on fleet TTFT; this module is that tier, seeded from the repo's
ZeRO-Infinity-style NVMe swap machinery (runtime/zero/infinity.py — the
same "bounded host buffer in front of an append-style spill file" shape
the parameter offload path uses).

Eviction becomes DEMOTION instead of loss:

- :meth:`KVTier.absorb` ingests a ``kind="prefix"``
  :class:`~.migration.PageBundle` (the exact serialized form
  cross-replica pulls ship: crc'able page payloads, quant-scale sidecar,
  ``weight_version`` stamped) built by the prefix cache's eviction sink
  (``PrefixCache.evict_sink``) and stores one record per page, indexed
  by the page's blake2b chain hash (:func:`~.prefix_cache.chain_hashes`
  — the same key the router's residency digests match on).
- Records live in a bounded host-RAM ring (:class:`HostRing`); overflow
  spills to a segmented NVMe file (:class:`NVMeSpill`) behind it. Pages
  are absorbed DEEPEST-FIRST, so ring/spill eviction trims chains from
  the deep end and the surviving residency stays contiguous-from-root —
  exactly the shape a promote can use.
- :meth:`KVTier.extract` is the promote path: given a prompt, rebuild
  the longest tier-resident chain as a fresh prefix bundle. The caller
  adopts it through the refcounted pull surface
  (``StateManager.adopt_prefix`` + the engine's page scatter —
  ``engine_v2.import_prefix``), so a placement or admission miss warms
  the HBM trie from the tier instead of recomputing. Records promoted
  from NVMe re-enter the RAM ring (they are hot again).

Failure policy — recompute is ALWAYS safe, so every failure here is a
counted degrade, never an error surfaced to serving: a torn or
truncated spill record (crash mid-demote) is detected by the crc +
length gate on tier open and skipped; a crc mismatch at read drops the
record; version skew after a weight hot-swap refuses the whole chain
(:meth:`KVTier.set_weight_version` invalidates stale records); a full
ring without a spill simply drops the oldest pages. The fault points
``tier_torn_spill`` / ``tier_crash_mid_demote``
(runtime/resilience.FaultInjector) drill exactly those paths.

This module is pure host code (bytes in, bytes out): the device half —
reading evicted pages out of the pool and scattering promoted pages
back in — lives with the pool owners (engine_v2 / the toy replica
backend), and block ownership never touches this file at all
(bin/check_state_invariants.py pins the adopt/evict mutators to the
refcounted StateManager API).
"""
from __future__ import annotations

import base64
import json
import os
import struct
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass

from .migration import MigrationError, PageBundle, version_skew
from .prefix_cache import chain_hashes

#: spill record framing: magic | chain hash | meta len | payload len |
#: payload crc32 | header crc32 (over the 24 bytes before it)
_MAGIC = b"KVT1"
_HDR = struct.Struct("<4sQIII")          # magic, hash, mlen, plen, pcrc
_HDR_CRC = struct.Struct("<I")
SPILL_PREFIX = "kvtier_"
SPILL_SUFFIX = ".seg"

#: CPU-guessed transfer-rate fallbacks for the router's pull-vs-promote
#: vs-recompute cost model (serving/placement.plan_kv_source) — used
#: when the startup micro-probe (:func:`measure_tier_rates`) is
#: disabled or fails. Real numbers come from the probe.
GUESS_RAM_BYTES_S = 8e9
GUESS_NVME_BYTES_S = 1.2e9

#: fixed per-promote overhead the sizing model amortizes over the
#: chain: the admit-time probe walk, adopt_prefix bookkeeping, and ONE
#: device scatter dispatch — costs that do NOT scale with chain length
#: (the per-page payload copy is what the tier-rate probe prices)
PROMOTE_FIXED_S = 1e-3

#: conservative prefill-rate guess (tokens/s) when the caller has no
#: measured rate — the same default the router's pull-vs-recompute cost
#: model ships (serving/router.RouterConfig.kv_pull_prefill_tok_s)
GUESS_PREFILL_TOK_S = 2000.0


class KVTierError(RuntimeError):
    """A tier operation failed (callers degrade to recompute)."""


@dataclass
class KVTierConfig:
    #: host-RAM ring payload budget (bytes of page payload resident)
    ram_bytes: int = 64 << 20
    #: spill directory; None = RAM-only tier (overflow drops)
    nvme_dir: str | None = None
    #: total spill budget — oldest segment deleted past it
    nvme_bytes: int = 256 << 20
    #: spill segment rotation size
    segment_bytes: int = 32 << 20
    #: shortest chain worth promoting (pages); shorter probes miss
    min_pages: int = 1

    @classmethod
    def from_dict(cls, d: dict | None) -> "KVTierConfig":
        d = dict(d or {})
        known = {f for f in cls.__dataclass_fields__}
        return cls(**{k: v for k, v in d.items() if k in known})


class HostRing:
    """Bounded host-RAM record store, oldest-out. "Ring" in the bounded-
    bump-cursor sense of serving/shm.py, not a literal shared segment:
    records are python bytes in insertion order, and crossing the byte
    budget pops the OLDEST record to the overflow callback (the NVMe
    spill) — absorb order (deepest page first) makes oldest == deepest,
    so chains demote toward NVMe from the deep end and tier residency
    stays contiguous-from-root."""

    def __init__(self, cap_bytes: int):
        self.cap_bytes = int(cap_bytes)
        self._m: OrderedDict[int, tuple[dict, bytes]] = OrderedDict()
        self.bytes = 0

    def __len__(self) -> int:
        return len(self._m)

    def __contains__(self, h: int) -> bool:
        return h in self._m

    def peek(self, h: int) -> tuple[dict, bytes] | None:
        """Read WITHOUT a recency touch (probe walks chains root-first;
        touching in that order would leave the ROOT as the chain's
        oldest entry and invert the deep-end-first eviction invariant —
        callers that promote re-touch deepest-first via :meth:`touch`)."""
        return self._m.get(h)

    def get(self, h: int) -> tuple[dict, bytes] | None:
        ent = self._m.get(h)
        if ent is not None:
            self._m.move_to_end(h)       # recency: promote keeps it hot
        return ent

    def touch(self, h: int) -> None:
        if h in self._m:
            self._m.move_to_end(h)

    def put(self, h: int, meta: dict, payload: bytes) -> list[tuple]:
        """Insert (replacing any stale copy); returns the ``(hash, meta,
        payload)`` records evicted past the byte budget — the caller
        spills or drops them."""
        old = self._m.pop(h, None)
        if old is not None:
            self.bytes -= len(old[1])
        self._m[h] = (meta, payload)
        self.bytes += len(payload)
        out: list[tuple] = []
        while self.bytes > self.cap_bytes and len(self._m) > 1:
            oh, (om, op) = self._m.popitem(last=False)
            self.bytes -= len(op)
            out.append((oh, om, op))
        return out

    def pop(self, h: int) -> None:
        ent = self._m.pop(h, None)
        if ent is not None:
            self.bytes -= len(ent[1])

    def keys(self):
        return self._m.keys()


class NVMeSpill:
    """Append-only segmented spill file behind the host ring.

    One record per demoted page: crc'd header + json meta + payload
    (framing above). :meth:`_scan` on open rebuilds the in-RAM index
    from whatever survived a crash — a torn or truncated record (crash
    mid-demote) fails the header-crc / length / payload-crc gate, is
    COUNTED and skipped (resyncing to the next record magic), never
    fatal and never served. Rotation past ``segment_bytes`` starts a
    new segment; total bytes past ``cap_bytes`` deletes the OLDEST
    segment and its index entries (the journal.py bounding idea —
    the spill can never outgrow its budget)."""

    def __init__(self, dirpath: str, cap_bytes: int, segment_bytes: int):
        self.dir = dirpath
        self.cap_bytes = int(cap_bytes)
        self.segment_bytes = int(segment_bytes)
        os.makedirs(dirpath, exist_ok=True)
        #: hash -> (segment id, payload offset, meta dict, payload len,
        #: payload crc)
        self._idx: dict[int, tuple[int, int, dict, int, int]] = {}
        self._seg_bytes: dict[int, int] = {}
        self.torn_skipped = 0
        self.evicted_pages = 0
        self._fh = None
        self._cur = 0
        self._scan()

    # -- segment bookkeeping ---------------------------------------------
    def _seg_path(self, seg: int) -> str:
        return os.path.join(self.dir, f"{SPILL_PREFIX}{seg:06d}{SPILL_SUFFIX}")

    def _segments(self) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            if f.startswith(SPILL_PREFIX) and f.endswith(SPILL_SUFFIX):
                try:
                    out.append(int(f[len(SPILL_PREFIX):-len(SPILL_SUFFIX)]))
                except ValueError:
                    continue
        return sorted(out)

    def _scan(self) -> None:
        """Rebuild the index from disk, gating every record on the
        header crc, the declared lengths fitting the file, and the
        payload crc — the tier-open torn-spill gate."""
        for seg in self._segments():
            path = self._seg_path(seg)
            try:
                with open(path, "rb") as f:
                    blob = f.read()
            except OSError:
                self.torn_skipped += 1
                continue
            self._seg_bytes[seg] = len(blob)
            off = 0
            while off < len(blob):
                rec = self._parse_at(blob, off)
                if rec is None:
                    # torn/corrupt record: count it, resync to the next
                    # frame magic (a crash mid-append tears the tail; an
                    # injected tear sits mid-file) — never fatal
                    self.torn_skipped += 1
                    nxt = blob.find(_MAGIC, off + 1)
                    if nxt < 0:
                        break
                    off = nxt
                    continue
                h, meta, pay_off, plen, pcrc, end = rec
                self._idx[h] = (seg, pay_off, meta, plen, pcrc)
                off = end
        segs = self._segments()
        self._cur = (segs[-1] + 1) if segs else 0

    @staticmethod
    def _parse_at(blob: bytes, off: int):
        """One framed record at ``off`` or None if torn: returns
        ``(hash, meta, payload offset, payload len, payload crc,
        record end)``."""
        if off + _HDR.size + _HDR_CRC.size > len(blob):
            return None
        hdr = blob[off:off + _HDR.size]
        magic, h, mlen, plen, pcrc = _HDR.unpack(hdr)
        (hcrc,) = _HDR_CRC.unpack(
            blob[off + _HDR.size:off + _HDR.size + _HDR_CRC.size])
        if magic != _MAGIC or zlib.crc32(hdr) != hcrc:
            return None
        body = off + _HDR.size + _HDR_CRC.size
        end = body + mlen + plen
        if end > len(blob):                 # length gate: truncated tail
            return None
        try:
            meta = json.loads(blob[body:body + mlen].decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        pay_off = body + mlen
        if zlib.crc32(blob[pay_off:end]) != pcrc:
            return None
        return h, meta, pay_off, plen, pcrc, end

    def __contains__(self, h: int) -> bool:
        return h in self._idx

    def __len__(self) -> int:
        return len(self._idx)

    @property
    def bytes(self) -> int:
        return sum(self._seg_bytes.values())

    def _open_cur(self):
        if self._fh is None:
            self._fh = open(self._seg_path(self._cur), "ab")
            self._seg_bytes.setdefault(self._cur, 0)
        return self._fh

    def append(self, h: int, meta: dict, payload: bytes,
               tear: bool = False) -> None:
        """Spill one record. ``tear`` (fault injection,
        ``tier_torn_spill``) writes only a prefix of the record and
        leaves it UNINDEXED — the on-disk shape of a crash mid-demote,
        which the next :meth:`_scan` must detect and skip."""
        mb = json.dumps(meta, separators=(",", ":")).encode("utf-8")
        hdr = _HDR.pack(_MAGIC, h & (1 << 64) - 1, len(mb), len(payload),
                        zlib.crc32(payload))
        rec = hdr + _HDR_CRC.pack(zlib.crc32(hdr)) + mb + payload
        if tear:
            rec = rec[:max(len(rec) // 2, _HDR.size + 2)]
        f = self._open_cur()
        f.write(rec)
        f.flush()
        self._seg_bytes[self._cur] = self._seg_bytes.get(self._cur, 0) \
            + len(rec)
        if not tear:
            pay_off = self._seg_bytes[self._cur] - len(payload)
            self._idx[h] = (self._cur, pay_off, dict(meta), len(payload),
                            zlib.crc32(payload))
        if self._seg_bytes[self._cur] >= self.segment_bytes:
            self._rotate()
        self._enforce_cap()

    def _rotate(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._cur += 1

    def _enforce_cap(self) -> None:
        while self.bytes > self.cap_bytes and len(self._seg_bytes) > 1:
            oldest = min(s for s in self._seg_bytes if s != self._cur) \
                if any(s != self._cur for s in self._seg_bytes) else None
            if oldest is None:
                break
            dropped = [h for h, e in self._idx.items() if e[0] == oldest]
            for h in dropped:
                del self._idx[h]
            self.evicted_pages += len(dropped)
            self._seg_bytes.pop(oldest, None)
            try:
                os.remove(self._seg_path(oldest))
            except OSError:
                pass

    def read(self, h: int) -> tuple[dict, bytes] | None:
        """Fetch + crc-verify one record; a failed read drops the index
        entry (counted torn) and returns None — the caller recomputes."""
        ent = self._idx.get(h)
        if ent is None:
            return None
        seg, off, meta, plen, pcrc = ent
        try:
            with open(self._seg_path(seg), "rb") as f:
                f.seek(off)
                payload = f.read(plen)
        except OSError:
            payload = b""
        if len(payload) != plen or zlib.crc32(payload) != pcrc:
            del self._idx[h]
            self.torn_skipped += 1
            return None
        return meta, payload

    def pop(self, h: int) -> None:
        self._idx.pop(h, None)

    def keys(self):
        return self._idx.keys()

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class KVTier:
    """The two-level eviction sink + promote source over the radix keys.

    One per pool owner (engine / toy replica backend). All mutation
    rides two verbs — :meth:`absorb` (demote a prefix bundle in) and
    :meth:`extract` (promote the longest resident chain out) — which
    bin/check_state_invariants.py pins to the demote/promote wrappers
    next to the refcounted adopt API, the same way trie mutators are
    pinned to StateManager."""

    def __init__(self, cfg: KVTierConfig | dict | None = None,
                 inj=None):
        if not isinstance(cfg, KVTierConfig):
            cfg = KVTierConfig.from_dict(cfg)
        self.cfg = cfg
        self.inj = inj                   # FaultInjector (tier_* points)
        self.ring = HostRing(cfg.ram_bytes)
        self.spill = NVMeSpill(cfg.nvme_dir, cfg.nvme_bytes,
                               cfg.segment_bytes) \
            if cfg.nvme_dir else None
        #: bumped on every membership change — the replica heartbeat
        #: re-ships the tier residency digest only when this moved
        #: (exactly the PrefixCache.version idea)
        self.version = 1 if (self.spill and len(self.spill)) else 0
        #: current serving weight version (``{"id", "digest"}`` or None
        #: = accept anything): records stamped under a DIFFERENT version
        #: are invisible to probe/extract and dropped eagerly on swap —
        #: a post-swap request must never prefill from old-weight KV
        self._wv: dict | None = None
        # lifetime stats (stats() folds the sub-tier views in)
        self.demoted_pages = 0
        self.demote_errors = 0
        self.dropped_pages = 0           # ring overflow with no spill
        self.promotes = 0
        self.promoted_pages = 0
        self.promote_ahead_pages = 0     # prefetch(): NVMe → RAM staging
        self.probe_hits = 0
        self.probe_misses = 0
        self.fallbacks: dict[str, int] = {}
        #: recent promote wall-times, drained into the telemetry
        #: histogram at heartbeat cadence (bounded)
        self.promote_latencies: list[float] = []
        #: CUMULATIVE promote-latency accumulator — the live refinement
        #: of ``min_pages`` (:meth:`refine_min_pages`) reads this, NOT
        #: ``promote_latencies`` (that list is drained-and-cleared into
        #: the telemetry histogram, so it cannot carry a running rate)
        self.promote_obs = {"count": 0, "total_s": 0.0, "pages": 0}
        self.min_pages_refinements = 0
        # loss high-water marks (_note_loss): ANY record loss — ring
        # drop, spill cap eviction, torn/crc drop — must bump `version`
        # so the heartbeat re-ships the SHRUNK digest (a stale digest
        # would advertise phantom residency the router plans around)
        self._loss_marks = (0, self.spill.evicted_pages if self.spill
                            else 0, self.spill.torn_skipped
                            if self.spill else 0)

    def _note_loss(self) -> None:
        marks = (self.dropped_pages,
                 self.spill.evicted_pages if self.spill else 0,
                 self.spill.torn_skipped if self.spill else 0)
        if marks != self._loss_marks:
            self._loss_marks = marks
            self.version += 1

    def _respill(self, h: int, meta: dict, payload: bytes) -> None:
        """A record the RAM ring evicted: spill it unless an identical
        index entry already exists (a hot record that cycled
        RAM→NVMe→RAM→... must not accumulate duplicate on-disk copies —
        dead bytes would eat the nvme_bytes budget and push genuinely
        cold segments out early)."""
        if self.spill is not None:
            if h not in self.spill:
                self.spill.append(h, meta, payload)
        else:
            self.dropped_pages += 1

    # -- membership -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.ring) + (len(self.spill) if self.spill else 0)

    def has(self, h: int) -> bool:
        return h in self.ring or (self.spill is not None
                                  and h in self.spill)

    def _fallback(self, reason: str) -> None:
        self.fallbacks[reason] = self.fallbacks.get(reason, 0) + 1

    def set_weight_version(self, wv: dict | None) -> None:
        """A weight hot-swap committed: stale records must never be
        promoted again. Ring records are dropped eagerly (host RAM is
        the scarce resource); spill records age out through segment
        rotation and are version-gated at read either way."""
        self._wv = dict(wv) if wv else None
        stale = [h for h in list(self.ring.keys())
                 if version_skew(self.ring.peek(h)[0].get("wv"),
                                 self._wv)]
        for h in stale:
            self.ring.pop(h)
        spill_stale = []
        if self.spill is not None:
            spill_stale = [h for h in list(self.spill.keys())
                           if version_skew(
                               self.spill._idx[h][2].get("wv"),
                               self._wv)]
            for h in spill_stale:
                self.spill.pop(h)
        if stale or spill_stale:
            self.version += 1        # the shrunk digest must re-ship

    # -- demote (the eviction sink's ingest) ------------------------------
    def absorb(self, bundle: PageBundle) -> int:
        """Ingest a ``kind="prefix"`` bundle, one record per full page
        keyed by its chain hash, DEEPEST page first (see the class
        note). Pages already resident dedup. Returns pages newly
        absorbed. The ``tier_crash_mid_demote`` fault point dies HARD
        between the spill write and the index update — the torn-spill
        recovery drill."""
        if bundle.kind != "prefix":
            raise KVTierError(f"tier absorbs prefix bundles, not "
                              f"{bundle.kind!r}")
        bundle.validate()
        new = 0
        for j in range(bundle.n_full - 1, -1, -1):
            h = bundle.chain[j]
            if self.has(h):
                continue
            meta = {"pb": bundle.page_bytes, "bs": bundle.block_size,
                    "dtype": bundle.kv_dtype, "wv": bundle.weight_version,
                    "scale": (bundle.scales[j]
                              if bundle.scales is not None else None)}
            if self.inj is not None \
                    and self.inj.countdown("tier_crash_mid_demote"):
                if self.spill is not None:
                    self.spill.append(h, meta, bundle.pages[j], tear=True)
                self.inj.crash_now("tier_crash_mid_demote",
                                   f"demote of page {j}")
            if self.inj is not None \
                    and self.inj.countdown("tier_torn_spill"):
                # the torn-write drill: bytes hit the spill mid-record
                # and the index never learns them — detected (counted,
                # skipped) by the next tier open's scan; without a spill
                # the page is simply dropped (recompute covers it)
                if self.spill is not None:
                    self.spill.append(h, meta, bundle.pages[j], tear=True)
                else:
                    self.dropped_pages += 1
                continue
            for oh, om, op in self.ring.put(h, meta, bundle.pages[j]):
                self._respill(oh, om, op)
            new += 1
        if new:
            self.demoted_pages += new
            self.version += 1
        self._note_loss()
        return new

    # -- promote ----------------------------------------------------------
    def probe(self, chain: list[int]) -> int:
        """Longest contiguous-from-root run of ``chain`` resident in the
        tier (version-compatible records only) — the cheap membership
        walk placement and admission gate on before paying
        :meth:`extract`'s payload reads. Recency-NEUTRAL: a root-first
        walk that touched the LRU would leave the root as the chain's
        oldest record and make eviction trim from the root end,
        breaking the contiguous-from-root promotability invariant."""
        n = 0
        for h in chain:
            ent = self.ring.peek(h)
            if ent is not None:
                if version_skew(ent[0].get("wv"), self._wv):
                    break
            elif self.spill is not None and h in self.spill:
                if version_skew(self.spill._idx[h][2].get("wv"),
                                self._wv):
                    break
            else:
                break
            n += 1
        if n >= max(self.cfg.min_pages, 1):
            self.probe_hits += 1
        else:
            self.probe_misses += 1
        return n

    def prefetch(self, chain: list[int]) -> int:
        """Promote-AHEAD: stage the chain's NVMe-resident records up
        into the host-RAM ring while the caller is waiting on something
        slower (the replica holds a put while its peer pull is in
        flight — that network wait is free time to move local bytes one
        tier up). No bundle is built and nothing is adopted; the only
        effect is that a later :meth:`extract` of the same chain reads
        at RAM rate instead of paying per-page NVMe opens. Walks
        contiguous-from-root like :meth:`probe` and stops at the first
        gap, skew, or torn record — every failure is the usual counted
        degrade (the record simply stays where it was, or drops on a
        crc fail exactly as a promote would have dropped it). Returns
        pages staged RAM-ward."""
        n = 0
        hits: list[int] = []
        for h in chain:
            if self.ring.peek(h) is not None:
                hits.append(h)            # already hot: nothing to stage
                continue
            if self.spill is None or h not in self.spill:
                break
            ent = self.spill.read(h)
            if ent is None:               # counted + dropped by read()
                self._fallback("crc")
                break
            meta, payload = ent
            if version_skew(meta.get("wv"), self._wv):
                self._fallback("version_skew")
                break
            # the record MOVES (same single-copy rule as extract's
            # NVMe branch): pop the spill entry so a later ring
            # eviction re-spills exactly one copy
            self.spill.pop(h)
            for oh, om, op in self.ring.put(h, meta, payload):
                self._respill(oh, om, op)
            hits.append(h)
            n += 1
        # recency DEEPEST first (extract's rule): the root must end
        # newest so ring eviction keeps trimming from the deep end and
        # residency stays contiguous-from-root
        for h in reversed(hits):
            self.ring.touch(h)
        if n:
            self.promote_ahead_pages += n
        self._note_loss()
        return n

    def extract(self, tokens, block_size: int,
                trace_id: str = "") -> PageBundle | None:
        """Rebuild the longest tier-resident chain prefixing ``tokens``
        as a fresh ``kind="prefix"`` bundle (payloads crc-verified on
        the way out; NVMe-resident pages re-enter the RAM ring). None on
        a miss shorter than ``min_pages`` or ANY inconsistency — the
        caller recomputes, always safe. The caller adopts the bundle via
        the refcounted pull surface (StateManager.adopt_prefix + the
        engine scatter), never by touching blocks itself.

        The synchronous form composes the two-phase promote-ahead API:
        :meth:`extract_begin` (mutation-free plan) + :meth:`extract_finish`
        (the payload reads below)."""
        bs = int(block_size)
        n_full = len(tokens) // bs
        if n_full == 0:
            return None
        aligned = [int(t) for t in tokens[:n_full * bs]]
        return self._extract_payload(aligned, bs, trace_id)

    def extract_begin(self, tokens, block_size: int,
                      trace_id: str = "") -> dict | None:
        """Phase one of the two-phase promote (promote-AHEAD pipelining,
        serving-side): a MUTATION-FREE membership walk that plans the
        extract and returns an opaque handle for :meth:`extract_finish`,
        or None when the resident run is shorter than ``min_pages``.
        Nothing is read, moved, or counted here — ring recency, spill
        index, and every stat are untouched — so a crash (or an
        abandoned handle) between begin and finish leaves the tier
        byte-identical to never having begun: recompute covers, the
        audit stays clean. The replica calls begin at admission (the
        router's ``promote_hint``) so the NVMe reads + crc verification
        in finish overlap the put's own admission work instead of
        serializing after it."""
        bs = int(block_size)
        n_full = len(tokens) // bs
        if n_full == 0:
            return None
        aligned = [int(t) for t in tokens[:n_full * bs]]
        n = 0
        for h in chain_hashes(aligned, bs):
            ent = self.ring.peek(h)
            if ent is not None:
                if version_skew(ent[0].get("wv"), self._wv):
                    break
            elif self.spill is not None and h in self.spill:
                if version_skew(self.spill._idx[h][2].get("wv"),
                                self._wv):
                    break
            else:
                break
            n += 1
        if n < max(self.cfg.min_pages, 1):
            return None
        return {"tok": aligned, "bs": bs, "tid": trace_id, "planned": n}

    def extract_finish(self, handle: dict | None) -> PageBundle | None:
        """Phase two: the payload reads, crc verification, NVMe→RAM
        moves, recency touches and bundle build — everything
        :meth:`extract` does after its alignment step. Residency may
        have shrunk since :meth:`extract_begin` (eviction, swap, torn
        records); every inconsistency is the same counted fallback as
        the synchronous path and returns None — the caller recomputes,
        always safe."""
        if handle is None:
            return None
        return self._extract_payload(handle["tok"], handle["bs"],
                                     handle["tid"])

    def _extract_payload(self, aligned: list[int], bs: int,
                         trace_id: str) -> PageBundle | None:
        chain = chain_hashes(aligned, bs)
        pages: list[bytes] = []
        scales: list = []
        geom: tuple | None = None
        wv = None
        hits: list[int] = []
        for h in chain:
            ent = self.ring.peek(h)
            src = "ram"
            if ent is None and self.spill is not None:
                had = h in self.spill
                ent = self.spill.read(h)
                src = "nvme"
                if ent is None and had:
                    # read() counted + dropped the torn record
                    self._fallback("crc")
                    self._note_loss()
            if ent is None:
                break
            meta, payload = ent
            if version_skew(meta.get("wv"), self._wv):
                self._fallback("version_skew")
                break
            g = (int(meta.get("pb", len(payload))), int(meta.get("bs", bs)),
                 str(meta.get("dtype", "")))
            if geom is None:
                geom = g
            if g != geom or g[1] != bs or len(payload) != g[0]:
                self._fallback("geometry")
                break
            wv = meta.get("wv")
            pages.append(payload)
            scales.append(meta.get("scale"))
            hits.append(h)
            if src == "nvme":
                # hot again: the record MOVES to the RAM ring — the
                # spill index entry is popped so a later ring eviction
                # re-spills exactly one copy (on-disk bytes of the old
                # record go dead until segment rotation reclaims them)
                self.spill.pop(h)
                for oh, om, op in self.ring.put(h, meta, payload):
                    self._respill(oh, om, op)
        # recency AFTER the walk, DEEPEST page first, so the root ends
        # newest: ring eviction keeps trimming promoted chains from the
        # deep end and residency stays contiguous-from-root (a
        # root-first touch would invert it)
        for h in reversed(hits):
            self.ring.touch(h)
        self._note_loss()
        if len(pages) < max(self.cfg.min_pages, 1):
            return None
        try:
            bundle = PageBundle.prefix(
                trace_id, aligned[:len(pages) * bs], bs, geom[2], geom[0],
                pages, weight_version=dict(wv) if wv else None)
            if any(s is not None for s in scales):
                bundle.scales = [s if s is not None else "" for s in scales]
            bundle.validate()
        except MigrationError:
            self._fallback("corrupt")
            return None
        self.promotes += 1
        self.promoted_pages += len(pages)
        return bundle

    def note_promote_latency(self, dt_s: float, pages: int = 0) -> None:
        if len(self.promote_latencies) < 512:
            self.promote_latencies.append(float(dt_s))
        self.promote_obs["count"] += 1
        self.promote_obs["total_s"] += float(dt_s)
        self.promote_obs["pages"] += max(int(pages), 0)

    def drain_promote_latencies(self, registry) -> int:
        """Move the recent promote wall-times into the
        ``serving_kv_tier_promote_latency_s`` histogram of ``registry`` (a
        telemetry ``MetricsRegistry``) and clear them; returns how many.
        The serving replica calls this at its heartbeat cadence, as the
        JAX package's replica drains the same list."""
        n = len(self.promote_latencies)
        if n:
            hist = registry.histogram(
                "serving_kv_tier_promote_latency_s",
                help="wall time of a tier promote (extract + adopt + "
                     "scatter)")
            for dt in self.promote_latencies:
                hist.observe(dt)
            self.promote_latencies.clear()
        return n

    def refine_min_pages(self, *, block_size: int,
                         prefill_tok_s: float = GUESS_PREFILL_TOK_S,
                         fixed_s: float = PROMOTE_FIXED_S, cap: int = 64,
                         min_samples: int = 16) -> int | None:
        """Re-size the promote threshold from the LIVE promote-latency
        record instead of the startup micro-probe's byte-rate break-even
        (:func:`auto_min_pages`): the probe prices raw tier reads, but a
        real promote also pays crc checks, payload verification and the
        adopt/scatter — all of which :meth:`note_promote_latency`
        observed end to end. Once ``min_samples`` promotes accumulated,
        the observed per-page promote time replaces the probed rate in
        the same break-even (amortizing each promote's fixed overhead
        into the per-page figure, which biases ``min_pages`` slightly
        HIGH — the safe side: recompute is always correct). Cheap enough
        for heartbeat cadence; returns the applied value, or None while
        the sample budget is unmet. An explicitly configured
        ``min_pages`` stays authoritative — callers only wire this up
        when the startup value was itself auto-sized."""
        obs = self.promote_obs
        if obs["count"] < max(int(min_samples), 1) or obs["pages"] <= 0:
            return None
        t_promote_page = obs["total_s"] / obs["pages"]
        t_recompute_page = block_size / max(float(prefill_tok_s), 1e-9)
        if t_promote_page >= t_recompute_page:
            n = int(cap)
        else:
            import math
            n = max(1, min(int(cap), math.ceil(
                fixed_s / (t_recompute_page - t_promote_page))))
        if n != self.cfg.min_pages:
            self.cfg.min_pages = n
            self.min_pages_refinements += 1
        return n

    # -- introspection ----------------------------------------------------
    def residency_digest(self, max_entries: int = 4096) -> list[int]:
        """Chain hashes of tier-resident pages, RAM (hottest) first —
        shipped next to the HBM digest in the replica heartbeat so the
        router's placement and pull-vs-promote-vs-recompute cost model
        see tier residency (placement.plan_kv_source)."""
        out = list(self.ring.keys())[::-1]          # newest first
        if self.spill is not None and len(out) < max_entries:
            out.extend(h for h in self.spill.keys() if h not in self.ring)
        return out[:max_entries]

    def stats(self) -> dict:
        return {
            "ram_pages": len(self.ring),
            "ram_bytes": self.ring.bytes,
            "nvme_pages": len(self.spill) if self.spill else 0,
            "nvme_bytes": self.spill.bytes if self.spill else 0,
            "demoted_pages": self.demoted_pages,
            "demote_errors": self.demote_errors,
            "dropped_pages": self.dropped_pages,
            "promotes": self.promotes,
            "promoted_pages": self.promoted_pages,
            "promote_ahead_pages": self.promote_ahead_pages,
            "probe_hits": self.probe_hits,
            "probe_misses": self.probe_misses,
            "fallbacks": dict(self.fallbacks),
            "min_pages": self.cfg.min_pages,
            "min_pages_refinements": self.min_pages_refinements,
            "promote_obs_count": self.promote_obs["count"],
            "torn_skipped": (self.spill.torn_skipped
                             if self.spill else 0),
            "spill_evicted_pages": (self.spill.evicted_pages
                                    if self.spill else 0),
        }

    def close(self, flush: bool = False) -> None:
        """``flush=True`` (graceful shutdown) spills the RAM ring's
        records so a restarted tier reopens warm; a crash loses exactly
        the RAM tier (recompute covers it) and the spill's scan gate
        skips whatever record the crash tore."""
        if self.spill is not None:
            if flush:
                for h in list(self.ring.keys()):
                    meta, payload = self.ring.get(h)
                    if h not in self.spill:
                        self.spill.append(h, meta, payload)
            self.spill.close()


# ---------------------------------------------------------------------------
# startup micro-probe: measure the per-tier byte rates the router's cost
# model runs on (the kv_pull_* constants were CPU-guessed — ROADMAP
# carried-over item). The probe is deliberately tiny (a few MB, a few
# ms): it seeds the ORDER OF MAGNITUDE, the guessed constants stay the
# fallback, and explicit RouterConfig values always win.
# ---------------------------------------------------------------------------

def measure_tier_rates(nvme_dir: str | None = None,
                       size_bytes: int = 4 << 20) -> dict:
    """Measure host-RAM copy bandwidth and (when ``nvme_dir`` is given
    and writable) spill-file read bandwidth. Returns ``{"ram_bytes_s",
    "nvme_bytes_s", "probed"}`` — guessed values with ``probed=False``
    on any failure or absurd reading, so a broken mount can never feed
    the cost model a zero rate."""
    out = {"ram_bytes_s": GUESS_RAM_BYTES_S,
           "nvme_bytes_s": GUESS_NVME_BYTES_S, "probed": False}
    try:
        blob = os.urandom(min(size_bytes, 1 << 20)) \
            * max(size_bytes // min(size_bytes, 1 << 20), 1)
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            bytes(bytearray(blob))
        dt = time.perf_counter() - t0
        ram = reps * len(blob) / max(dt, 1e-9)
        if ram > 1e6:
            out["ram_bytes_s"] = ram
            out["probed"] = True
    except (MemoryError, OSError):
        return out
    if nvme_dir:
        path = os.path.join(nvme_dir, f".kvtier_probe_{os.getpid()}")
        try:
            os.makedirs(nvme_dir, exist_ok=True)
            with open(path, "wb") as f:
                f.write(blob)
                f.flush()
                os.fsync(f.fileno())
            t0 = time.perf_counter()
            with open(path, "rb") as f:
                got = f.read()
            dt = time.perf_counter() - t0
            rate = len(got) / max(dt, 1e-9)
            if len(got) == len(blob) and rate > 1e5:
                out["nvme_bytes_s"] = min(rate, out["ram_bytes_s"])
        except OSError:
            pass                          # guessed fallback stands
        finally:
            try:
                os.remove(path)
            except OSError:
                pass
    return out


def auto_min_pages(rates: dict, *, page_bytes: int, block_size: int,
                   nvme: bool = False,
                   prefill_tok_s: float = GUESS_PREFILL_TOK_S,
                   fixed_s: float = PROMOTE_FIXED_S,
                   cap: int = 64) -> int:
    """Size :attr:`KVTierConfig.min_pages` from MEASURED tier rates
    (:func:`measure_tier_rates`) instead of a guessed constant.

    Promoting an n-page chain costs ``fixed_s + n * page_bytes / rate``;
    recomputing it costs ``n * block_size / prefill_tok_s``. The
    break-even chain length is the smallest integer n where promoting
    wins — shorter tier hits are cheaper to just recompute, so min_pages
    filters them out of the admit probe. When the per-page promote cost
    alone exceeds the per-page recompute cost no chain length ever wins:
    return ``cap`` so only very deep chains promote (never 0 — a zero
    threshold would "promote" empty probe results).

    ``nvme`` selects which measured rate bounds the promote: a spilled
    chain reads at NVMe speed, a RAM-resident one at copy speed.
    """
    rate = float(rates.get("nvme_bytes_s" if nvme else "ram_bytes_s")
                 or 0.0)
    t_promote_page = page_bytes / max(rate, 1e-9)
    t_recompute_page = block_size / max(prefill_tok_s, 1e-9)
    if t_promote_page >= t_recompute_page:
        return cap
    import math
    n = fixed_s / (t_recompute_page - t_promote_page)
    return max(1, min(cap, math.ceil(n)))


def scale_sidecar_encode(arr_bytes: bytes) -> str:
    """Base64 form for per-page quant-scale sidecars riding tier
    records / prefix bundles (the engine's fp8-KV pool is scale-free, so
    this is exercised by pools that carry side-car scales)."""
    return base64.b64encode(arr_bytes).decode("ascii")
