"""Anticipatory KV movement: router-side proactive tier-to-peer pushes.

Every other KV-movement mechanism in the fleet is *reactive* — a
placement miss pays the full cross-replica pull, a tier hit pays the
full NVMe extract, and both serialize in front of TTFT. The
:class:`PushPlanner` closes the loop the other way: it scores prefix
chains by heat (sticky-map hit counts + live sharers, the same ranking
the elastic pre-warm path uses) and, while the fleet is IDLE, ships the
hottest chains to digest-cold decode-capable replicas *before* any
request needs them — so the next placement finds the pages already
resident and the pull machinery has nothing left to move.

Mechanism over policy reuse:

- the transfer itself is the radix pull's ``kind="prefix"`` PageBundle kv_*
  relay (source streams to the router, router relays to the target,
  shm fast path, kv_need resend, version-skew gated) under a ``"p:"``
  id namespace — one more client of the machinery pulls, gang hops and
  elastic pre-warms already share;
- unlike a pre-warm (whose target is a fresh replica that asked to be
  warmed) a push lands on a replica with its own live work, so the
  offer is DECLINABLE: the router sends ``kv_push`` and the target
  answers ``kv_push_ok`` (pull registered, stream it) or
  ``kv_push_no`` (draining / at capacity / busy — the router counts
  the decline and moves on);
- pushes are strictly LOWER priority than demand movement: the planner
  never launches while any demand pull is in flight, never while the
  router's queue-wait estimator says requests are waiting
  (``kv_push_idle_wait_s`` — the idle-aware budget), and is
  rate-limited per the rebalance hysteresis pattern
  (``kv_push_min_interval_s`` between launch rounds, a per-
  (chain, slot) cooldown so a declined/landed push is not re-offered
  every tick);
- with the watchtower on the idle gate also reads the recent
  queue-depth *history* — a burst that drained half a second ago still
  marks the fleet busy for the lookback window, so pushes ride genuine
  troughs instead of instantaneous gaps between arrivals.

A push that is already in flight toward a replica is itself a KV
source: ``placement.plan_kv_source`` prices it (``push_pages``) and a
put placed on the push's target can JOIN the transfer (``pull.join``)
instead of starting a new one — the anticipatory move pays off even
when the request arrives before the pages land.
"""
from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING

from .disagg import DECODE_CAPABLE, MigrationState, role_of
from .placement import best_digest_peer, load_score, match_pages
from ..inference.migration import version_skew
from ..telemetry import sanitize_label_value

if TYPE_CHECKING:                                  # pragma: no cover
    from .router import Router

logger = logging.getLogger(__name__)

#: pages-per-settled-push histogram buckets (prewarm's scale)
_PUSH_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0)

#: how far back the watchtower idle gate looks for queue pressure
_WATCH_LOOKBACK_S = 5.0


class PushPlanner:
    """Owns the router's proactive-push state: candidate scoring, the
    idle/rate gates, the per-push relay state machine (the elastic
    pre-warm shape under ``"p:"`` ids) and the join index demand
    placement prices pushes-in-flight through."""

    def __init__(self, router: "Router"):
        self.r = router
        #: pid -> {"ms": MigrationState(kind="push"), "tgt_epoch",
        #:         "deadline", "pages", "tok", "chain", "phase"}
        #: phase: "offer" (kv_push sent, awaiting ok/no) | "xfer"
        #: (accepted; ms.phase tracks the relay legs)
        self._pushes: dict[str, dict] = {}
        self._pid_ctr = 0
        self._last_launch_t = -1e18
        #: (chain head hash, slot) -> cooldown expiry (hysteresis: a
        #: chain just offered/landed/declined there is not re-offered)
        self._cooldown: dict[tuple[int, int], float] = {}
        self.offers = 0
        self.declines = 0
        self.acks = 0
        self.pages = 0
        self.misses = 0
        self.joins = 0
        self.idle_skips = 0
        self.late_msgs = 0

    # -- gates ------------------------------------------------------------
    def idle(self, now: float) -> bool:
        """The idle-aware budget: True only when no demand movement is
        in flight, the queue-wait estimator is under
        ``kv_push_idle_wait_s`` (None = cold = idle), and — with the
        watchtower on — the recent queue-depth history shows no
        pressure either. Pushes must never steal bandwidth or pool
        pages from work a user is waiting on."""
        r = self.r
        if r._pulls or r._queues and any(r._queues.values()):
            return False
        est = r._est_queue_wait_s()
        if est is not None and est > r.cfg.kv_push_idle_wait_s:
            return False
        if r._watch is not None:
            last = r._watch.last_t()
            if last is not None:
                pts = r._watch.range("serving_router_queue_depth",
                                     t0=last - _WATCH_LOOKBACK_S,
                                     src="router")
                if any(v > 0 for _, v in pts):
                    return False
        return True

    def inflight(self, chain: list[int], slot: int) -> tuple[str | None,
                                                             int]:
        """Deepest push already in flight toward ``slot`` whose chain
        prefixes ``chain``: ``(pid, pages)`` — the join candidate
        ``plan_kv_source`` prices as ``push_pages``."""
        best, pages = None, 0
        for pid, ent in self._pushes.items():
            if ent["ms"].tgt_slot != slot:
                continue
            pc = ent["chain"]
            if len(pc) <= len(chain) and pc == chain[:len(pc)] \
                    and len(pc) > pages:
                best, pages = pid, len(pc)
        return best, pages

    def note_join(self, pid: str, tid: str) -> None:
        """A demand put joined push ``pid``: from here the transfer IS
        demand movement — record it so the ack books the join."""
        ent = self._pushes.get(pid)
        if ent is not None:
            ent["joined"] = tid
        self.joins += 1
        if self.r._telem.enabled:
            self.r._telem.registry.counter(
                "serving_router_kv_push_joined_total",
                help="placed requests that joined a proactive push "
                     "already in flight instead of starting their own "
                     "pull").inc()

    def note_slot_died(self, h) -> None:
        for pid in [p for p, e in self._pushes.items()
                    if (e["ms"].src_slot == h.slot
                        and e["ms"].src_epoch <= h.epoch)
                    or (e["ms"].tgt_slot == h.slot
                        and e["tgt_epoch"] <= h.epoch)]:
            self._fail_push(pid, "slot_died")

    # -- launch -----------------------------------------------------------
    def tick(self, now: float) -> None:
        r = self.r
        self._sweep(now)
        if not r.cfg.kv_push:
            return
        if len(self._pushes) >= r.cfg.kv_push_max_inflight:
            return
        if now - self._last_launch_t < r.cfg.kv_push_min_interval_s:
            return
        if not self.idle(now):
            self.idle_skips += 1
            self._count_skip("busy")
            return
        self._launch(now)

    def _candidates(self) -> list[dict]:
        """Hottest distinct prefix chains the router knows prompt
        tokens for (live AND recently-terminal requests — heat outlives
        the request), ranked sticky-heat + sharers, deepest first on
        ties; chains below ``kv_push_min_heat`` are not hot enough to
        speculate on."""
        r = self.r
        seen: dict[int, dict] = {}
        bs = r._fleet_block_size() or 1
        for req in r._reqs.values():
            chain = req.chain
            if not chain:
                continue
            ent = seen.get(chain[-1])
            if ent is not None:
                ent["n"] += 1
                continue
            seen[chain[-1]] = {
                "chain": list(chain),
                "tok": [int(x) for x in
                        req.rec.prompt[:len(chain) * bs]],
                "n": 1}
        cands = [e for e in seen.values()
                 if e["n"] + r._sticky.heat(e["chain"])
                 >= r.cfg.kv_push_min_heat]
        cands.sort(key=lambda e: (-(e["n"] + r._sticky.heat(e["chain"])),
                                  -len(e["chain"]), e["chain"][-1]))
        return cands[:r.cfg.kv_push_chains]

    def _pick_target(self, chain: list[int], src_slot: int):
        """Digest-COLDEST decode-capable READY replica (union HBM+tier
        digest), least loaded then lowest slot on ties — the replica a
        placement miss would most likely pay a pull on."""
        best, best_key = None, None
        for h in self.r.fleet.ready():
            if h.slot == src_slot or role_of(h) not in DECODE_CAPABLE:
                continue
            m = max(match_pages(chain, h.digest),
                    match_pages(chain, getattr(h, "tier_digest", None)))
            key = (m, load_score(h.load), h.slot)
            if best_key is None or key < best_key:
                best, best_key = h, key
        return best

    def _launch(self, now: float) -> None:
        r = self.r
        n = 0
        for cand in self._candidates():
            if len(self._pushes) + n >= r.cfg.kv_push_max_inflight:
                break
            src, pages = best_digest_peer(cand["chain"], r.fleet.ready())
            if src is None or pages < r.cfg.kv_pull_min_pages:
                continue
            tgt = self._pick_target(cand["chain"], src.slot)
            if tgt is None:
                self._count_skip("no_target")
                continue
            if version_skew(getattr(src, "wv", None),
                            getattr(tgt, "wv", None)):
                continue
            cold = max(match_pages(cand["chain"], tgt.digest),
                       match_pages(cand["chain"],
                                   getattr(tgt, "tier_digest", None)))
            if pages - cold < r.cfg.kv_pull_min_pages:
                continue                 # target already warm enough
            key = (cand["chain"][-1], tgt.slot)
            if self._cooldown.get(key, 0.0) > now:
                continue
            self._cooldown[key] = now + r.cfg.kv_push_hysteresis_s
            bs = tgt.block_size or r._fleet_block_size() or 1
            tok = cand["tok"][:pages * bs]
            self._pid_ctr += 1
            pid = f"p:{r._boots}-{self._pid_ctr}"
            if not tgt.send({"t": "kv_push", "id": pid, "tok": tok,
                             "deadline_s": r.cfg.kv_push_deadline_s}):
                break
            self._pushes[pid] = {
                "ms": MigrationState(meta={}, src_slot=src.slot,
                                     src_epoch=src.epoch,
                                     started_t=now, kind="push",
                                     tgt_slot=tgt.slot),
                "tgt_epoch": tgt.epoch,
                "deadline": now + r.cfg.kv_push_deadline_s,
                "pages": pages, "tok": tok,
                "chain": list(cand["chain"][:pages]),
                "phase": "offer"}
            self.offers += 1
            n += 1
            self.r._fev(pid, "push_offer", src_slot=src.slot,
                        tgt_slot=tgt.slot, pages=pages)
            if r._telem.enabled:
                r._telem.registry.counter(
                    "serving_router_kv_push_offers_total",
                    help="proactive push offers sent to digest-cold "
                         "replicas (target may decline)").inc()
        if n:
            self._last_launch_t = now

    # -- settle / sweep ---------------------------------------------------
    def _fail_push(self, pid: str, reason: str) -> None:
        ent = self._pushes.pop(pid, None)
        if ent is None:
            return
        self.misses += 1
        ms = ent["ms"]
        if ent["phase"] != "offer":
            self.r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                 {"t": "kv_fail", "id": pid})
        logger.info(f"push: {pid} failed ({reason})")
        if self.r._telem.enabled:
            self.r._telem.registry.counter(
                "serving_router_kv_push_fallbacks_total",
                labels={"reason": sanitize_label_value(reason)},
                help="proactive pushes that did not land, by "
                     "structured reason (the target recomputes on "
                     "demand — pushes are pure opportunism)").inc()

    def _count_skip(self, reason: str) -> None:
        if self.r._telem.enabled:
            self.r._telem.registry.counter(
                "serving_router_kv_push_skips_total",
                labels={"reason": sanitize_label_value(reason)},
                help="push launch rounds skipped by the idle-budget / "
                     "target gates").inc()

    def _sweep(self, now: float) -> None:
        for pid in [p for p, e in self._pushes.items()
                    if now >= e["deadline"]]:
            self._fail_push(pid, "deadline")
        for k in [k for k, t in self._cooldown.items() if t <= now]:
            del self._cooldown[k]

    # -- protocol ---------------------------------------------------------
    def on_offer_reply(self, h, msg: dict) -> None:
        """``kv_push_ok`` / ``kv_push_no`` from the offered target."""
        pid = str(msg.get("id", ""))
        ent = self._pushes.get(pid)
        if ent is None or ent["phase"] != "offer" \
                or h.slot != ent["ms"].tgt_slot \
                or h.epoch != ent["tgt_epoch"]:
            self.late_msgs += 1
            return
        if msg["t"] == "kv_push_no":
            self.declines += 1
            self._pushes.pop(pid, None)
            if self.r._telem.enabled:
                self.r._telem.registry.counter(
                    "serving_router_kv_push_declined_total",
                    labels={"reason": sanitize_label_value(
                        str(msg.get("reason", "busy")))},
                    help="push offers the target replica declined "
                         "(draining / capacity / busy)").inc()
            return
        ent["phase"] = "xfer"
        ms = ent["ms"]
        if not self.r._send_to_slot(ms.src_slot, ms.src_epoch,
                                    {"t": "kv_req", "id": pid, "a": 0,
                                     "tok": ent["tok"]}):
            self._fail_push(pid, "source_lost")

    def on_kv(self, h, msg: dict) -> None:
        """kv_* legs of an accepted push ("p:"-prefixed ids): the same
        two-leg source→router→target relay pre-warms use."""
        t = str(msg.get("t", ""))
        pid = str(msg.get("id", ""))
        ent = self._pushes.get(pid)
        if ent is None:
            self.late_msgs += 1
            return
        ms = ent["ms"]
        src_ok = h.slot == ms.src_slot and h.epoch == ms.src_epoch
        tgt_ok = h.slot == ms.tgt_slot and h.epoch == ent["tgt_epoch"]
        r = self.r
        if t == "kv_none":
            if src_ok:
                self._fail_push(pid, "peer_miss")
        elif t == "kv_bundle":
            if src_ok and ms.phase == "recv":
                ms.meta = dict(msg.get("meta") or {})
                ms.shm = msg.get("shm")
        elif t == "kv_chunk":
            if not src_ok:
                return
            ms.add_chunk(msg)
            if ms.phase == "xfer":         # relay fill-in after kv_need
                r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                {**msg, "id": pid, "a": 0})
        elif t == "kv_eof":
            if not src_ok:
                return
            if ms.phase == "xfer":
                r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                {"t": "kv_eof", "id": pid, "a": 0,
                                 "chunks": ms.total})
                return
            ms.total = int(msg.get("chunks", 0))
            if not ms.complete:
                self._fail_push(pid, "torn")
                return
            if version_skew(ms.weight_version,
                            getattr(r.fleet.replicas[ms.tgt_slot],
                                    "wv", None)):
                r._count_version_skew("push")
                self._fail_push(pid, "version_skew")
                return
            ms.phase = "xfer"
            ok = r._send_to_slot(
                ms.tgt_slot, ent["tgt_epoch"],
                {"t": "kv_bundle", "id": pid, "a": 0, "meta": ms.meta,
                 "chunks": ms.total, "shm": ms.shm})
            for i in range(ms.total):
                if not ok:
                    break
                c = ms.chunks.get(i)
                ok = c is not None and r._send_to_slot(
                    ms.tgt_slot, ent["tgt_epoch"],
                    {**c, "id": pid, "a": 0})
            if ok:
                r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                {"t": "kv_eof", "id": pid, "a": 0,
                                 "chunks": ms.total})
            else:
                self._fail_push(pid, "target_lost")
        elif t == "kv_need":
            if not tgt_ok or ms.phase != "xfer":
                return
            ms.resends += 1
            if ms.resends > r.cfg.migration_resend_max:
                self._fail_push(pid, "resend_budget")
                return
            missing = [int(i) for i in (msg.get("missing") or ())]
            if msg.get("relay"):
                ms.relayed = True
                if not r._send_to_slot(ms.src_slot, ms.src_epoch,
                                       {"t": "kv_relay", "id": pid,
                                        "missing": missing}):
                    self._fail_push(pid, "source_lost")
                return
            for i in missing:
                c = ms.chunks.get(i)
                if c is not None:
                    r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                    {**c, "id": pid, "a": 0})
            r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                            {"t": "kv_eof", "id": pid, "a": 0,
                             "chunks": ms.total})
        elif t == "kv_ack":
            if not tgt_ok:
                return
            self._pushes.pop(pid, None)
            pages = int(msg.get("pages", 0))
            if pages > 0:
                self.acks += 1
                self.pages += pages
                self.r._fev(pid, "push_landed", pages=pages)
                if r._telem.enabled:
                    r._telem.registry.counter(
                        "serving_router_kv_push_pages_total",
                        help="radix pages landed on push targets ahead "
                             "of demand").inc(pages)
                    r._telem.registry.histogram(
                        "serving_router_kv_push_pages",
                        buckets=_PUSH_BUCKETS,
                        help="pages adopted per settled proactive "
                             "push").observe(float(pages))
            else:
                self.misses += 1
                if r._telem.enabled:
                    r._telem.registry.counter(
                        "serving_router_kv_push_fallbacks_total",
                        labels={"reason": "adopt_failed"},
                        help="proactive pushes that did not land, by "
                             "structured reason (the target recomputes "
                             "on demand — pushes are pure "
                             "opportunism)").inc()

    def stats(self) -> dict:
        return {"offers": self.offers, "declines": self.declines,
                "acks": self.acks, "pages": self.pages,
                "misses": self.misses, "joins": self.joins,
                "idle_skips": self.idle_skips,
                "late_msgs": self.late_msgs,
                "in_flight": len(self._pushes)}
