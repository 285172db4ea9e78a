"""Elastic fleet actuators: the advisory scale hints become actions.

disagg.ScaleAdvisor has exported ``serving_router_scale_hint{role,
direction}`` since disaggregation landed, and the rebalance policy
acts on *load* imbalance — but nothing ever changed the fleet's
*shape*.  This module closes that loop.  An :class:`ElasticController`
is ticked from the router poll loop and turns sustained hints into
three deadline-bounded actuators, one action in flight at a time:

* **retire** — drain a victim replica (stop admissions by parking it
  DRAINING, ask its in-flight decodes off through the ordinary
  rebalance/handoff machinery), then send ``{"t": "retire"}``: the
  replica flushes its remaining radix into the KV tier's evict sink
  deepest-first — the prefixes stay tier-warm for the peers — and
  exits cleanly.  fleet.maintain classifies the exit RETIRED: the slot
  is parked, not respawned.

* **spawn** — bring a parked (or newly added) slot back through the
  ordinary spawn/breaker machinery, then **pre-warm** it: the hottest
  prefix chains still in flight are pushed into the new replica as
  ordinary kv_bundle transfers relayed from digest-matched peers, so
  its first real requests hit a warm radix instead of a cold one.

* **re_role** — flip a replica prefill<->decode at a quiesce boundary
  (same drain primitive, no process restart) when the advisor wants
  one role up and the other down at the same time.

Preemption is the involuntary twin of retire and lives mostly in the
replica (resilience.PreemptionHandler latch -> emergency drain-flush
-> exit 83) and the fleet (classified ``preempted``: no breaker hit,
no failure budget, eager respawn).  The controller's part is eager
state invalidation — sticky affinity and digests for a preempted slot
are dropped the moment the ``{"t": "preempt"}`` notice arrives, not
when the process dies.

Every phase transition is journaled (kind="elastic", critical) so a
router restart mid-action resumes it — and a replica already asked to
retire is re-parked RETIRED *before* fleet.start() can resurrect it.
"""
from __future__ import annotations

import logging
import time
from typing import TYPE_CHECKING

from .disagg import (DECODE_CAPABLE, PREFILL_CAPABLE, ROLE_DECODE,
                     ROLE_PREFILL, MigrationState, role_of)
from .fleet import DEAD, DRAINING, QUARANTINED, READY, RETIRED, SPAWNING
from .placement import best_digest_peer
from ..inference.migration import version_skew
from ..telemetry import sanitize_label_value

if TYPE_CHECKING:                                   # pragma: no cover
    from .router import Router

logger = logging.getLogger(__name__)

#: action phases, per kind (journaled verbatim)
PH_DRAIN, PH_RETIRE = "drain", "retire"
PH_SPAWN, PH_PREWARM = "spawn", "prewarm"
PH_FLIP = "flip"

_DRAIN_BUCKETS = (0.1, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0)
_PREWARM_BUCKETS = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


class ElasticController:
    """One deadline-bounded fleet-shape action at a time, journaled.

    The router constructs it after journal recovery (``recovered`` is
    the last un-settled action record, if any) and before
    fleet.start() — adoption of a retire that already reached its
    "retire" phase must park the slot RETIRED before start() walks
    the handles, or the restart would resurrect a replica that was
    told to flush and exit ("never resurrect a retiring replica").
    """

    def __init__(self, router: "Router",
                 recovered: dict | None = None) -> None:
        self.r = router
        self.action: dict | None = None   # journal payload (JSON-able)
        self._t0 = 0.0                    # action start (drain duration)
        self._deadline: float | None = None
        self._flip_sent = False
        self._cooldown_until = 0.0
        #: live prewarm transfers: wid -> {"ms": MigrationState,
        #: "tgt_epoch": int, "deadline": float, "pages": int}
        self._prewarms: dict[str, dict] = {}
        self._wid_ctr = 0
        # -- counters (stats() / CLI / bench scorecards) ----------------
        self.actions_total: dict[str, int] = {}     # "kind:outcome" -> n
        self.prewarm_sent = 0
        self.prewarm_acks = 0        # settled with pages > 0
        self.prewarm_pages = 0
        self.prewarm_misses = 0      # settled with pages == 0 or failed
        self.late_msgs = 0           # kv_* for an already-settled wid
        if recovered:
            self._adopt(dict(recovered))

    # -- journal / metrics ----------------------------------------------
    def journal_payload(self) -> dict | None:
        """Current action for the router's snapshot records."""
        return dict(self.action) if self.action else None

    def _journal(self) -> None:
        """Append the action's current phase; crash seam right after —
        recovery must re-adopt from exactly this record."""
        self.r._jrec("elastic", dict(self.action or {}), critical=True)
        inj = self.r._inj
        if inj.countdown("router_crash_mid_elastic"):
            inj.crash_now("router_crash_mid_elastic",
                          f"elastic {self.action}")

    def _count(self, kind: str, outcome: str) -> None:
        key = f"{kind}:{outcome}"
        self.actions_total[key] = self.actions_total.get(key, 0) + 1
        telem = self.r._telem
        if telem.enabled:
            telem.registry.counter(
                "serving_router_scale_actions_total",
                labels={"action": sanitize_label_value(kind),
                        "outcome": sanitize_label_value(outcome)},
                help="elastic fleet actions settled, by kind and "
                     "outcome").inc()

    def _finish(self, now: float, outcome: str) -> None:
        act = self.action or {}
        kind = str(act.get("kind", "?"))
        self.action = None
        self._deadline = None
        self._flip_sent = False
        self._cooldown_until = now + self.r.cfg.elastic_cooldown_s
        self._count(kind, outcome)
        self.r._jrec("elastic", {**act, "outcome": outcome},
                     critical=True)
        if kind == "retire" and outcome == "ok" and self._t0 > 0 \
                and self.r._telem.enabled:
            self.r._telem.registry.histogram(
                "serving_router_elastic_drain_s",
                buckets=_DRAIN_BUCKETS,
                help="retire drain duration: admission stop to replica "
                     "exit").observe(max(0.0, now - self._t0))
        logger.info(f"elastic: {kind} slot {act.get('slot')} -> "
                    f"{outcome}")

    # -- recovery adoption ----------------------------------------------
    def _adopt(self, rec: dict) -> None:
        """Resume a half-done action from the journal (runs in
        Router.__init__, before fleet.start())."""
        kind = str(rec.get("kind", ""))
        slot = int(rec.get("slot", -1))
        fleet = self.r.fleet
        while 0 <= slot and slot >= len(fleet.replicas):
            fleet.add_slot()               # half-spawned added slot
        if not 0 <= slot < len(fleet.replicas):
            return
        if kind == "spawn" and rec.get("role"):
            fleet.cfg.per_slot.setdefault(str(slot), {})["role"] = \
                str(rec["role"])
        if kind == "retire" and rec.get("phase") == PH_RETIRE:
            # The replica was already told to flush-and-exit; whether
            # or not it got the message, this slot must never come
            # back up on restart.
            h = fleet.replicas[slot]
            h.state = RETIRED
            h.retiring = False
            self._count(kind, "ok")
            self.r._jrec("elastic", {**rec, "outcome": "ok"},
                         critical=True)
            logger.info(f"elastic: adopted retire of slot {slot} "
                        f"(parked RETIRED pre-start)")
            return
        self.action = {"kind": kind, "slot": slot,
                       "role": rec.get("role"),
                       "phase": str(rec.get("phase", ""))}
        logger.info(f"elastic: resuming {kind} slot {slot} phase "
                    f"{self.action['phase']} from journal")

    # -- event hooks (called from Router._handle / poll) ----------------
    def on_preempt(self, h) -> None:
        """``{"t": "preempt"}`` notice: latch for fleet classification
        and invalidate routing state eagerly — the replica is flushing
        and will be gone before maintain() sees the exit."""
        h.preempt_latched = True
        self.r._sticky.forget_slot(h.slot)
        h.digest = None
        h.tier_digest = None
        act = self.action
        if act and act.get("kind") == "re_role" \
                and int(act.get("slot", -1)) == h.slot:
            self._finish(time.monotonic(), "preempted")

    def on_re_role_ok(self, h, msg: dict) -> None:
        role = str(msg.get("role", h.role))
        h.role = role
        self.r.fleet.cfg.per_slot.setdefault(
            str(h.slot), {})["role"] = role       # survives respawn
        if h.state == DRAINING:
            h.state = READY
        act = self.action
        if act and act.get("kind") == "re_role" \
                and int(act.get("slot", -1)) == h.slot:
            self._finish(time.monotonic(), "ok")

    def note_slot_died(self, h) -> None:
        """A slot the fleet just classified dead/retired: settle any
        action or prewarm leg touching it."""
        for wid in [w for w, e in self._prewarms.items()
                    if e["ms"].src_slot == h.slot
                    or e["ms"].tgt_slot == h.slot]:
            self._fail_prewarm(wid, "slot_died")
        act = self.action
        if not act or int(act.get("slot", -1)) != h.slot:
            return
        now = time.monotonic()
        kind = act.get("kind")
        if kind == "retire":
            if h.state == RETIRED:
                self._finish(now, "ok")
            else:                 # crashed before the retire handshake
                self._finish(now, "lost")
        elif kind == "re_role":
            self._finish(now, "lost")
        # spawn: the fleet's own breaker/backoff owns the respawn; the
        # action's deadline (or QUARANTINED) settles it in tick().

    # -- the tick --------------------------------------------------------
    def tick(self, now: float) -> None:
        self._sweep_prewarms(now)
        if self.action is not None:
            self._progress(now)
            return
        cfg = self.r.cfg
        if now < self._cooldown_until or self.r._recovering:
            return
        if self.r._deploy is not None and self.r._deploy.active:
            return   # shape changes hold off during a rolling deploy
        adv = self.r._scale
        hold = cfg.elastic_sustain_s
        roles = sorted({role for role, _ in adv.hint_since})
        up = [role for role in roles
              if adv.sustained(role, "up", now, hold)]
        down = [role for role in roles
                if adv.sustained(role, "down", now, hold)]
        if cfg.elastic_re_role and up and down and up[0] != down[0] \
                and {up[0], down[0]} <= {ROLE_PREFILL, ROLE_DECODE}:
            if self._start_re_role(now, frm=down[0], to=up[0]):
                return
        if up and self._start_spawn(now, role=up[0]):
            return
        if down:
            self._start_retire(now, role=down[0])

    def _progress(self, now: float) -> None:
        act = self.action
        kind, phase = act["kind"], act["phase"]
        slot = int(act["slot"])
        if not 0 <= slot < len(self.r.fleet.replicas):
            self._finish(now, "lost")
            return
        h = self.r.fleet.replicas[slot]
        if kind == "retire":
            self._progress_retire(now, h, phase)
        elif kind == "spawn":
            self._progress_spawn(now, h, phase)
        elif kind == "re_role":
            self._progress_re_role(now, h, phase)
        else:                                      # unknown journal kind
            self._finish(now, "failed")

    # -- retire ----------------------------------------------------------
    def _start_retire(self, now: float, role: str) -> bool:
        cfg = self.r.cfg
        ready = self.r.fleet.ready()
        if len(ready) - 1 < max(1, cfg.elastic_min_replicas):
            return False
        pool = [h for h in ready if role_of(h) == role]
        if not pool:
            cap = PREFILL_CAPABLE if role == ROLE_PREFILL \
                else DECODE_CAPABLE
            pool = [h for h in ready if role_of(h) in cap]
        if not pool:
            return False
        # fewest in-flight first; youngest slot breaks the tie so the
        # fleet shrinks from the end it grew.
        victim = min(pool, key=lambda h:
                     (self.r._assigned_n.get(h.slot, 0), -h.slot))
        self.action = {"kind": "retire", "slot": victim.slot,
                       "role": role_of(victim), "phase": PH_DRAIN}
        self._t0 = now
        self._deadline = now + self.r.cfg.elastic_drain_deadline_s
        self._journal()
        victim.state = DRAINING            # admissions stop here
        victim.send({"t": "drain"})        # ...and replayed puts bounce
        self._ask_off(now, victim)
        logger.info(f"elastic: draining slot {victim.slot} for retire "
                    f"({role} down)")
        return True

    def _ask_off(self, now: float, h) -> None:
        """Ask every migratable in-flight decode off the victim via the
        rebalance machinery (_sweep_transfers owns the lifecycle)."""
        for tid, req in self.r._reqs.items():
            if req.status != "assigned" or req.assigned_slot != h.slot \
                    or not req.committed or req.mig is not None \
                    or req.rebalanced or req.rebalance_asked \
                    or tid in self.r._pulls:
                continue
            if self.r._send_to_slot(h.slot, h.epoch,
                                    {"t": "mig_request", "id": tid}):
                req.rebalance_asked = True
                req.rebalance_ask_t = now
                req.last_activity_t = now

    def _progress_retire(self, now: float, h, phase: str) -> None:
        if phase == PH_DRAIN:
            drained = self.r._assigned_n.get(h.slot, 0) == 0
            if drained or (self._deadline is not None
                           and now >= self._deadline):
                self.action["phase"] = PH_RETIRE
                self._deadline = now + \
                    self.r.cfg.elastic_drain_deadline_s
                self._journal()
                self.r.fleet.retire(h.slot)
                self.r._send_to_slot(
                    h.slot, h.epoch,
                    {"t": "retire",
                     "deadline_s": self.r.cfg.elastic_drain_deadline_s})
            elif self._deadline is None:   # adopted: restart the clock
                self._deadline = now + \
                    self.r.cfg.elastic_drain_deadline_s
                if h.state == READY:
                    h.state = DRAINING
                h.send({"t": "drain"})
                self._ask_off(now, h)
        else:                              # PH_RETIRE: wait for the exit
            if h.state == RETIRED:
                self._finish(now, "ok")
            elif self._deadline is not None and now >= self._deadline:
                # flush never completed in time — kill; maintain still
                # classifies it RETIRED (retiring latch), no breaker.
                h.kill()

    # -- spawn + prewarm -------------------------------------------------
    def _start_spawn(self, now: float, role: str) -> bool:
        fleet = self.r.fleet
        slot = -1
        for h in fleet.replicas:
            if h.state == RETIRED:
                slot = h.slot
                break
        if slot < 0:
            cap = self.r.cfg.elastic_max_replicas
            if cap and len(fleet.replicas) < cap:
                slot = fleet.add_slot().slot
            else:
                return False
        # a same-role replica already on its way up covers the hint
        for h in fleet.replicas:
            if h.state == SPAWNING and role_of(h) == role:
                return False
        self.action = {"kind": "spawn", "slot": slot, "role": role,
                       "phase": PH_SPAWN}
        self._t0 = now
        self._deadline = now + self.r.cfg.elastic_spawn_deadline_s
        self._journal()
        logger.info(f"elastic: spawning slot {slot} as {role} "
                    f"({role} up)")
        return True

    def _progress_spawn(self, now: float, h, phase: str) -> None:
        cfg = self.r.cfg
        if self._deadline is None:         # adopted: restart the clock
            self._deadline = now + cfg.elastic_spawn_deadline_s
        if phase == PH_SPAWN:
            if h.state == RETIRED or (h.state == DEAD
                                      and not h.proc and not h.chan):
                self.r.fleet.revive(h.slot, self.action.get("role"))
            elif h.state == READY:
                self.action["phase"] = PH_PREWARM
                self._deadline = now + cfg.elastic_prewarm_deadline_s
                self._journal()
                n = self._launch_prewarms(now, h)
                if n == 0:
                    self._finish(now, "ok")
            elif h.state == QUARANTINED:
                self._finish(now, "breaker")
            elif now >= self._deadline:
                self._finish(now, "timeout")
        else:                              # PH_PREWARM
            mine = [w for w, e in self._prewarms.items()
                    if e["ms"].tgt_slot == h.slot]
            if not mine:
                self._finish(now, "ok")
            elif now >= self._deadline:
                for wid in mine:
                    self._fail_prewarm(wid, "deadline")
                self._finish(now, "ok")    # pre-warm is best-effort

    def _prewarm_candidates(self, tgt) -> list[dict]:
        """Hottest distinct prefix chains still in flight: ranked by
        sticky-map heat + live sharers, deepest first on ties."""
        r = self.r
        seen: dict[int, dict] = {}
        bs = tgt.block_size or r._fleet_block_size() or 1
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
        cands = sorted(
            seen.values(),
            key=lambda e: (-(e["n"] + r._sticky.heat(e["chain"])),
                           -len(e["chain"]), e["chain"][-1]))
        return cands[:r.cfg.elastic_prewarm_chains]

    def _launch_prewarms(self, now: float, tgt) -> int:
        r = self.r
        n = 0
        for cand in self._prewarm_candidates(tgt):
            src, pages = best_digest_peer(
                cand["chain"], r.fleet.ready(),
                exclude_slot=tgt.slot,
                weight_version=getattr(tgt, "wv", None))
            if src is None or pages < 1:
                self.prewarm_misses += 1
                continue
            bs = tgt.block_size or r._fleet_block_size() or 1
            tok = cand["tok"][:pages * bs]
            self._wid_ctr += 1
            wid = f"w:{r._boots}-{self._wid_ctr}"
            if not tgt.send({"t": "prewarm", "id": wid, "tok": tok,
                             "deadline_s":
                             r.cfg.elastic_prewarm_deadline_s}):
                break
            if not r._send_to_slot(src.slot, src.epoch,
                                   {"t": "kv_req", "id": wid, "a": 0,
                                    "tok": tok}):
                continue   # tgt's own deadline settles the dangling pull
            self._prewarms[wid] = {
                "ms": MigrationState(meta={}, src_slot=src.slot,
                                     src_epoch=src.epoch,
                                     started_t=now, kind="prewarm",
                                     tgt_slot=tgt.slot),
                "tgt_epoch": tgt.epoch,
                "deadline": now + r.cfg.elastic_prewarm_deadline_s,
                "pages": pages}
            self.prewarm_sent += 1
            n += 1
        return n

    def _fail_prewarm(self, wid: str, reason: str) -> None:
        ent = self._prewarms.pop(wid, None)
        if ent is None:
            return
        self.prewarm_misses += 1
        ms = ent["ms"]
        self.r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                             {"t": "kv_fail", "id": wid})
        logger.info(f"elastic: prewarm {wid} failed ({reason})")

    def _sweep_prewarms(self, now: float) -> None:
        for wid in [w for w, e in self._prewarms.items()
                    if now >= e["deadline"]]:
            self._fail_prewarm(wid, "deadline")

    def on_kv(self, h, msg: dict) -> None:
        """kv_* legs of a prewarm transfer ("w:"-prefixed ids): the
        source streams the bundle to the router, which relays it to the
        new replica once the version gate passes — the same two-leg
        relay the radix pull path uses, minus the request to place."""
        t = str(msg.get("t", ""))
        wid = str(msg.get("id", ""))
        ent = self._prewarms.get(wid)
        if ent is None:
            self.late_msgs += 1
            return
        ms = ent["ms"]
        src_ok = h.slot == ms.src_slot and h.epoch == ms.src_epoch
        tgt_ok = h.slot == ms.tgt_slot and h.epoch == ent["tgt_epoch"]
        r = self.r
        if t == "kv_none":
            if src_ok:
                self._fail_prewarm(wid, "peer_miss")
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
                                {**msg, "id": wid, "a": 0})
        elif t == "kv_eof":
            if not src_ok:
                return
            if ms.phase == "xfer":
                r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                {"t": "kv_eof", "id": wid, "a": 0,
                                 "chunks": ms.total})
                return
            ms.total = int(msg.get("chunks", 0))
            if not ms.complete:
                self._fail_prewarm(wid, "torn")
                return
            if version_skew(ms.weight_version,
                            getattr(r.fleet.replicas[ms.tgt_slot],
                                    "wv", None)):
                r._count_version_skew("prewarm")
                self._fail_prewarm(wid, "version_skew")
                return
            ms.phase = "xfer"
            ok = r._send_to_slot(
                ms.tgt_slot, ent["tgt_epoch"],
                {"t": "kv_bundle", "id": wid, "a": 0, "meta": ms.meta,
                 "chunks": ms.total, "shm": ms.shm})
            for i in range(ms.total):
                if not ok:
                    break
                c = ms.chunks.get(i)
                ok = c is not None and r._send_to_slot(
                    ms.tgt_slot, ent["tgt_epoch"],
                    {**c, "id": wid, "a": 0})
            if ok:
                r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                {"t": "kv_eof", "id": wid, "a": 0,
                                 "chunks": ms.total})
            else:
                self._fail_prewarm(wid, "target_lost")
        elif t == "kv_need":
            if not tgt_ok or ms.phase != "xfer":
                return
            ms.resends += 1
            if ms.resends > r.cfg.migration_resend_max:
                self._fail_prewarm(wid, "resend_budget")
                return
            missing = [int(i) for i in (msg.get("missing") or ())]
            if msg.get("relay"):
                ms.relayed = True
                if not r._send_to_slot(ms.src_slot, ms.src_epoch,
                                       {"t": "kv_relay", "id": wid,
                                        "missing": missing}):
                    self._fail_prewarm(wid, "source_lost")
                return
            for i in missing:
                c = ms.chunks.get(i)
                if c is not None:
                    r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                                    {**c, "id": wid, "a": 0})
            r._send_to_slot(ms.tgt_slot, ent["tgt_epoch"],
                            {"t": "kv_eof", "id": wid, "a": 0,
                             "chunks": ms.total})
        elif t == "kv_ack":
            if not tgt_ok:
                return
            self._prewarms.pop(wid, None)
            pages = int(msg.get("pages", 0))
            if pages > 0:
                self.prewarm_acks += 1
                self.prewarm_pages += pages
                if r._telem.enabled:
                    r._telem.registry.histogram(
                        "serving_router_elastic_prewarm_pages",
                        buckets=_PREWARM_BUCKETS,
                        help="radix pages adopted per settled prewarm "
                             "transfer").observe(float(pages))
            else:
                self.prewarm_misses += 1

    # -- re-role ---------------------------------------------------------
    def _start_re_role(self, now: float, frm: str, to: str) -> bool:
        pool = [h for h in self.r.fleet.ready() if role_of(h) == frm]
        if not pool:
            return False
        if len([h for h in self.r.fleet.ready()
                if role_of(h) == frm]) <= 1:
            return False       # never flip a role's last replica away
        victim = min(pool, key=lambda h:
                     (self.r._assigned_n.get(h.slot, 0), -h.slot))
        self.action = {"kind": "re_role", "slot": victim.slot,
                       "role": to, "phase": PH_DRAIN}
        self._t0 = now
        self._deadline = now + self.r.cfg.elastic_drain_deadline_s
        self._flip_sent = False
        self._journal()
        victim.state = DRAINING            # quiesce: placements stop,
        logger.info(f"elastic: re-roling slot {victim.slot} "
                    f"{frm} -> {to}")      # in-flight streams continue
        return True

    def _progress_re_role(self, now: float, h, phase: str) -> None:
        if self._deadline is None:         # adopted: restart the clock
            self._deadline = now + self.r.cfg.elastic_drain_deadline_s
            if h.state == READY:
                h.state = DRAINING
        if phase == PH_DRAIN:
            quiesced = self.r._assigned_n.get(h.slot, 0) == 0
            if quiesced or now >= self._deadline:
                self.action["phase"] = PH_FLIP
                self._deadline = now + \
                    self.r.cfg.elastic_drain_deadline_s
                self._journal()
                self._flip_sent = h.send(
                    {"t": "re_role", "role": self.action["role"]})
        else:                              # PH_FLIP
            if not self._flip_sent and h.state in (READY, DRAINING):
                self._flip_sent = h.send(
                    {"t": "re_role", "role": self.action["role"]})
            if now >= self._deadline:
                if h.state == DRAINING:
                    h.state = READY        # give it back un-flipped
                self._finish(now, "timeout")

    # -- stats -----------------------------------------------------------
    def stats(self) -> dict:
        return {"actions": dict(self.actions_total),
                "in_flight": dict(self.action) if self.action else None,
                "prewarm_sent": self.prewarm_sent,
                "prewarm_acks": self.prewarm_acks,
                "prewarm_pages": self.prewarm_pages,
                "prewarm_misses": self.prewarm_misses,
                "late_msgs": self.late_msgs}
