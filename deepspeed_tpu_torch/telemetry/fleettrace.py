"""Fleet-wide distributed tracing: cross-replica trace assembly,
clock-aligned black-box postmortems, straggler detection.

Request tracing gave each process a Dapper-style request timeline and
the fleet turned the engine into a multi-replica serving tier — but
observability stayed per-process: when a request breaches its SLO after
touching three processes (router queue -> prefill replica -> bundle
relay -> decode replica), no single artifact shows where the time went.
This module is the fleet layer over the existing reqtrace/recorder/
protocol stack (Dapper, Sigelman et al. 2010 — cross-process trace
assembly; MegaScale, Jiang et al. NSDI'24 — fleet-wide straggler
diagnosis):

- **trace-context propagation** is already structural: the router mints
  the canonical trace ID at submit and every protocol message carries it
  as ``id``; engine replicas now ADOPT it into their reqtrace timelines
  (``ReqTracer.begin(trace_id=...)``) instead of minting their own, so
  one ID names the request in every process.
- :class:`ClockSync` estimates each replica's monotonic-clock offset
  from heartbeat RTT midpoints (the router pings with its own timestamp;
  the replica echoes it next heartbeat with its clocks). The lowest-RTT
  sample in a sliding window wins — its half-RTT is the uncertainty
  carried on every aligned event.
- :class:`FleetTraceAssembler` buffers the router's own per-request
  events (enqueue, placement decision + digest-match depth, shed/retry/
  failover, transfer relay phases, rebalance) plus the replica-shipped
  timeline segments (bounded, drop-counted — ``{"t": "trace"}`` on the
  line protocol) and merges them into ONE clock-aligned timeline per
  request, exportable as a Chrome trace with one track per process.
- :class:`StragglerScorer` keeps rolling per-replica TTFT/TBT/
  handoff-stall distributions and scores each replica's median against
  the pooled fleet distribution (robust z via median/MAD), feeding the
  ``serving_router_replica_degraded`` gauges and the router's
  ``fleet_health()`` rollup — signals only, no placement actuation.
- :func:`postmortem_report` renders a black-box dump (the router's
  rate-limited ``fleet_blackbox`` flight-recorder dump: merged timeline
  + clock table + fleet state) as a human report of the request path and
  where each millisecond went — ``bin/ds_postmortem`` is its CLI.

Everything here is host-side bookkeeping on clocks and dicts: disabled
(the default — ``RouterConfig(fleet_trace=False)``) none of it is
constructed, replicas ship nothing, and no buffer grows.
"""
from __future__ import annotations

import collections
import json
import time
import zlib


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


class ClockSync:
    """Per-replica-INCARNATION monotonic clock-offset estimation from
    heartbeat RTT midpoints. Samples are keyed ``(slot, epoch)`` — a
    respawned (or re-dialed, in remote-transport fleets) incarnation may
    run on a host with a different clock base, and aligning a dead
    incarnation's trace segments with its successor's offset would be
    confidently, silently wrong. ``note(slot, rtt, offset, epoch)``
    records one sample (offset = replica_mono - router_mono_at_midpoint);
    the estimate served by :meth:`offset` is the sample with the LOWEST
    rtt in the last ``window`` samples — queueing delay only ever
    inflates RTT, so the fastest exchange bounds the error tightest
    (NTP's logic). The uncertainty is that sample's half-RTT."""

    def __init__(self, window: int = 16, keep_epochs: int = 4):
        self.window = int(window)
        self.keep_epochs = int(keep_epochs)
        #: (slot, epoch) -> deque of (rtt, offset) samples. Dead
        #: incarnations' samples are RETAINED (their buffered trace
        #: segments still need alignment), bounded to the newest
        #: ``keep_epochs`` epochs per slot — a crash-looper can't grow
        #: this.
        self._samples: dict[tuple[int, int], collections.deque] = {}

    def note(self, slot: int, rtt_s: float, offset_s: float,
             epoch: int = 0) -> None:
        key = (int(slot), int(epoch))
        dq = self._samples.get(key)
        if dq is None:
            dq = self._samples[key] = collections.deque(
                maxlen=self.window)
            epochs = sorted(k[1] for k in self._samples
                            if k[0] == key[0])
            while len(epochs) > self.keep_epochs:
                self._samples.pop((key[0], epochs.pop(0)), None)
        dq.append((float(rtt_s), float(offset_s)))

    def _deque(self, slot: int, epoch: int | None):
        if epoch is not None:
            return self._samples.get((slot, epoch))
        newest = [k for k in self._samples if k[0] == slot]
        return self._samples[max(newest)] if newest else None

    def offset(self, slot: int,
               epoch: int | None = None) -> tuple[float, float | None]:
        """``(offset_s, err_s)`` — subtract ``offset_s`` from a replica
        timestamp to land on the router's clock; ``err_s`` is the
        half-RTT uncertainty. ``epoch=None`` serves the newest
        incarnation's estimate; an explicit epoch with no samples (the
        incarnation died before a ping round-tripped) returns
        ``(0.0, None)``: its events pass through UNALIGNED and the
        merged timeline says so — flagged, never wrongly aligned."""
        dq = self._deque(slot, epoch)
        if not dq:
            return 0.0, None
        rtt, off = min(dq, key=lambda s: s[0])
        return off, rtt / 2.0

    def rtt(self, slot: int, epoch: int | None = None) -> float | None:
        dq = self._deque(slot, epoch)
        if not dq:
            return None
        return min(s[0] for s in dq)

    def forget(self, slot: int) -> None:
        """Explicitly drop EVERY epoch's samples for a slot. NOT called
        on ordinary deaths — a dead incarnation's samples must outlive
        it so its buffered trace segments still align (boundedness comes
        from ``keep_epochs``, not from forgetting)."""
        for key in [k for k in self._samples if k[0] == slot]:
            self._samples.pop(key, None)

    def to_dict(self) -> dict:
        out = {}
        for slot, epoch in sorted(self._samples):
            off, err = self.offset(slot, epoch)
            out[f"{slot}.e{epoch}"] = {
                "offset_s": round(off, 6),
                "err_s": round(err, 6) if err is not None else None,
                "rtt_s": round(self.rtt(slot, epoch) or 0.0, 6),
                "samples": len(self._samples[(slot, epoch)])}
        return out


class StragglerScorer:
    """Rolling per-replica latency distributions scored against the
    fleet (MegaScale-style): for each metric (ttft/tbt/handoff_stall)
    the replica's median is compared to the POOLED fleet median via a
    robust z-score (1.4826 * MAD of the pooled samples). A replica is
    ``degraded`` when any metric with at least ``min_samples`` local
    samples scores past ``z_threshold``. Pure signal — the caller
    exposes gauges and a rollup, nothing here touches placement."""

    METRICS = ("ttft", "tbt", "handoff_stall")

    def __init__(self, window: int = 64, min_samples: int = 8,
                 z_threshold: float = 3.0):
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.z_threshold = float(z_threshold)
        #: (slot, metric) -> deque of samples
        self._samples: dict[tuple[int, str], collections.deque] = {}

    def note(self, slot: int, metric: str, value: float) -> None:
        key = (int(slot), metric)
        dq = self._samples.get(key)
        if dq is None:
            dq = self._samples[key] = collections.deque(maxlen=self.window)
        dq.append(float(value))

    def forget_slot(self, slot: int) -> None:
        for key in [k for k in self._samples if k[0] == slot]:
            self._samples.pop(key, None)

    def scores(self) -> dict[int, dict[str, float]]:
        """{slot: {metric: robust_z}} for every (slot, metric) holding
        at least ``min_samples`` samples."""
        out: dict[int, dict[str, float]] = {}
        for metric in self.METRICS:
            pooled: list[float] = []
            per_slot: dict[int, list[float]] = {}
            for (slot, m), dq in self._samples.items():
                if m != metric or len(dq) < self.min_samples:
                    continue
                xs = list(dq)
                per_slot[slot] = xs
                pooled.extend(xs)
            if len(per_slot) < 2:
                continue                 # nothing to compare against
            fleet_med = _median(pooled)
            mad = _median([abs(x - fleet_med) for x in pooled])
            scale = 1.4826 * mad + 1e-9
            for slot, xs in per_slot.items():
                z = (_median(xs) - fleet_med) / scale
                out.setdefault(slot, {})[metric] = round(z, 3)
        return out

    def degraded(self) -> dict[int, bool]:
        return {slot: any(z > self.z_threshold for z in ms.values())
                for slot, ms in self.scores().items()}


class _FleetReq:
    """One request's fleet-level trace state: the router's own events
    plus the replica-shipped segments, both bounded."""

    __slots__ = ("events", "segments", "dropped")

    def __init__(self):
        self.events: list[tuple] = []      # (t_mono, wall, kind, fields)
        #: (slot, epoch) -> {"pid": int, "events": [...], "dropped": int}
        self.segments: dict[tuple[int, int], dict] = {}
        self.dropped = 0


class FleetTraceAssembler:
    """Router-side trace assembly: per-request router events + replica
    segments -> one clock-aligned merged timeline. Memory is bounded
    forever: the newest ``max_requests`` requests are kept (oldest
    dropped whole), each side of a request keeps its first
    ``max_events`` events (head retention, like reqtrace — the admit/
    placement context survives truncation), and at most
    ``max_segments`` distinct (slot, epoch) segments attach per request
    (a request replayed across more incarnations than that keeps the
    earliest — the ones the postmortem needs)."""

    def __init__(self, max_requests: int = 256, max_events: int = 128,
                 max_segments: int = 8):
        self.max_requests = int(max_requests)
        self.max_events = int(max_events)
        self.max_segments = int(max_segments)
        self.clock = ClockSync()
        self._reqs: collections.OrderedDict[str, _FleetReq] = \
            collections.OrderedDict()
        self.segments_received = 0
        self.segments_dropped = 0

    # -- recording --------------------------------------------------------
    def _req(self, tid: str) -> _FleetReq:
        fr = self._reqs.get(tid)
        if fr is None:
            fr = self._reqs[tid] = _FleetReq()
            while len(self._reqs) > self.max_requests:
                self._reqs.popitem(last=False)
        return fr

    def router_event(self, tid: str, kind: str, **fields) -> None:
        """One router-side lifecycle event on the router's own clock
        (monotonic + wall, satellite of the cross-process story: wall is
        what correlates with external logs)."""
        fr = self._req(tid)
        if len(fr.events) < self.max_events:
            fr.events.append((time.monotonic(), time.time(), kind,
                              fields or None))
        else:
            fr.dropped += 1

    def add_segment(self, tid: str, slot: int, epoch: int, pid: int,
                    events: list, dropped: int = 0) -> None:
        """Fold a replica-shipped timeline segment in. Segments for the
        same (slot, epoch) append (replicas ship incrementally: a live
        breach-sampled snapshot first, the rest at release), bounded by
        ``max_events`` per segment."""
        self.segments_received += 1
        fr = self._req(tid)
        key = (int(slot), int(epoch))
        seg = fr.segments.get(key)
        if seg is None:
            if len(fr.segments) >= self.max_segments:
                self.segments_dropped += 1
                return
            seg = fr.segments[key] = {"pid": int(pid), "events": [],
                                      "dropped": 0}
        room = self.max_events - len(seg["events"])
        seg["events"].extend(events[:max(room, 0)])
        seg["dropped"] += int(dropped) + max(len(events) - room, 0)

    def has(self, tid: str) -> bool:
        return tid in self._reqs

    def __len__(self) -> int:
        return len(self._reqs)

    # -- assembly ---------------------------------------------------------
    def assemble(self, tid: str) -> dict | None:
        """The merged, clock-aligned timeline for one request: every
        event carries ``t`` (router-clock monotonic), ``dt`` (seconds
        since the first event), ``wall``, ``src`` (``router`` /
        ``replicaN``), and — for replica events — ``err_s``, the clock
        alignment uncertainty. Sorted by aligned time; with sane clock
        sync that IS causal order."""
        fr = self._reqs.get(tid)
        if fr is None:
            return None
        events: list[dict] = []
        dropped = fr.dropped
        for t, wall, kind, fields in fr.events:
            ev = {"t": t, "wall": round(wall, 6), "src": "router",
                  "kind": kind}
            if fields:
                ev.update({k: v for k, v in fields.items()
                           if k not in ev})
            events.append(ev)
        clock: dict[str, dict] = {}
        for (slot, epoch), seg in sorted(fr.segments.items()):
            # aligned with the offset of the incarnation that RECORDED
            # the segment — a successor on a different clock base must
            # not retime its predecessor's events
            off, err = self.clock.offset(slot, epoch)
            clock[str(slot)] = {
                "offset_s": round(off, 6),
                "err_s": round(err, 6) if err is not None else None,
                "rtt_s": self.clock.rtt(slot, epoch), "epoch": epoch,
                "pid": seg["pid"]}
            dropped += seg["dropped"]
            for rec in seg["events"]:
                t, wall, kind = rec[0], rec[1], rec[2]
                fields = rec[3] if len(rec) > 3 else None
                ev = {"t": float(t) - off, "wall": round(float(wall), 6),
                      "src": f"replica{slot}", "slot": slot, "kind": kind,
                      "err_s": round(err, 6) if err is not None else None}
                if fields:
                    ev.update({k: v for k, v in fields.items()
                               if k not in ev})
                events.append(ev)
        events.sort(key=lambda e: e["t"])
        t0 = events[0]["t"] if events else 0.0
        for e in events:
            e["dt"] = round(e["t"] - t0, 6)
        return {"trace_id": tid, "events": events, "clock": clock,
                "events_dropped": dropped}

    # -- chrome export (fleet mode) ---------------------------------------
    def chrome_events(self, tids: list[str] | None = None,
                      epoch: float | None = None) -> list[dict]:
        """Chrome trace-event JSON with ONE track (pid) per process:
        pid 10 is the router, pid 11+slot each replica (10+ keeps clear
        of the span tracer's pid 0 and reqtrace's pid 1 in a combined
        export), all on the router's clock (replica events shifted by
        their estimated offset). ``epoch`` sets the zero point (pass
        the span tracer's epoch to overlay on host spans — both clocks
        are CLOCK_MONOTONIC on CPython/Linux); defaults to the earliest
        merged event."""
        merged = [m for m in (self.assemble(t)
                              for t in (tids if tids is not None
                                        else list(self._reqs)))
                  if m is not None and m["events"]]
        if not merged:
            return []
        if epoch is None:
            epoch = min(m["events"][0]["t"] for m in merged)
        out: list[dict] = []
        pids_named: set[int] = set()

        def _name(pid: int, name: str) -> None:
            if pid not in pids_named:
                pids_named.add(pid)
                out.append({"name": "process_name", "ph": "M", "pid": pid,
                            "tid": 0, "args": {"name": name}})

        _name(10, "router")
        for m in merged:
            tid_hash = zlib.crc32(m["trace_id"].encode()) % 1_000_000 + 1
            by_src: dict[str, list[dict]] = {}
            for e in m["events"]:
                by_src.setdefault(e["src"], []).append(e)
            for src, evs in by_src.items():
                pid = 10 if src == "router" else 11 + int(evs[0]["slot"])
                if pid != 10:
                    _name(pid, src)
                t_first, t_last = evs[0]["t"], evs[-1]["t"]
                out.append({"name": f"req {m['trace_id']}",
                            "cat": "fleettrace", "ph": "X", "pid": pid,
                            "tid": tid_hash,
                            "ts": (t_first - epoch) * 1e6,
                            "dur": max((t_last - t_first) * 1e6, 1.0),
                            "args": {"trace_id": m["trace_id"]}})
                for e in evs:
                    ev = {"name": e["kind"], "cat": "fleettrace",
                          "ph": "i", "s": "t", "pid": pid, "tid": tid_hash,
                          "ts": (e["t"] - epoch) * 1e6}
                    args = {k: v for k, v in e.items()
                            if k not in ("t", "dt", "src", "kind")
                            and isinstance(v, (int, float, str, bool,
                                               type(None)))}
                    if args:
                        ev["args"] = args
                    out.append(ev)
        return out

    def export_chrome_trace(self, path: str,
                            tids: list[str] | None = None) -> str:
        with open(path, "w") as f:
            json.dump({"traceEvents": self.chrome_events(tids),
                       "displayTimeUnit": "ms"}, f)
        return path


# -- black-box postmortem rendering (bin/ds_postmortem) ---------------------

def _fmt_s(v) -> str:
    try:
        v = float(v)
    except (TypeError, ValueError):
        return "?"
    if abs(v) >= 1.0:
        return f"{v:.3f}s"
    return f"{v * 1e3:.2f}ms"


def postmortem_report(rec: dict) -> str:
    """Render a ``fleet_blackbox`` flight-recorder dump (the router's
    rate-limited atomic dump: merged timeline + clock table + fleet
    state + health rollup) as a human report: what fired, how the
    clocks aligned, the request's path through the fleet, and where
    each millisecond went (the largest inter-event gaps). Tolerates
    missing pieces — a dump assembled mid-crash renders what it has."""
    lines: list[str] = []
    fleet = rec.get("fleet") or {}
    trig = fleet.get("trigger") or {}
    lines.append(f"== fleet postmortem: {rec.get('reason', '?')} ==")
    if rec.get("detail"):
        lines.append(f"   {rec['detail']}")
    t = rec.get("time")
    if t is not None:
        lines.append(f"captured at wall {t:.3f} "
                     f"({time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(t))}) "
                     f"by pid {rec.get('pid', '?')}")
    if trig:
        bits = [f"trigger: {trig.get('kind', '?')}"]
        for k in ("slo", "value", "threshold", "slot", "reason"):
            if trig.get(k) is not None:
                v = trig[k]
                bits.append(f"{k}={_fmt_s(v) if k in ('value', 'threshold') else v}")
        lines.append("  ".join(bits))
    clock = fleet.get("clock") or {}
    if clock:
        lines.append("clock alignment (replica clock minus router clock):")
        for slot in sorted(clock, key=str):
            c = clock[slot]
            err = c.get("err_s")
            lines.append(
                f"  replica{slot}  offset {c.get('offset_s', 0.0):+.6f}s"
                f"  ±{_fmt_s(err) if err is not None else '?'}"
                f"  (rtt {_fmt_s(c.get('rtt_s'))})")
    tl = fleet.get("timeline")
    if tl and tl.get("events"):
        evs = tl["events"]
        lines.append(f"request path (trace {tl.get('trace_id', '?')}): "
                     f"{len(evs)} events, "
                     f"{tl.get('events_dropped', 0)} dropped")
        for e in evs:
            extra = " ".join(
                f"{k}={v}" for k, v in e.items()
                if k not in ("t", "dt", "wall", "src", "kind", "err_s",
                             "slot") and v is not None)
            err = e.get("err_s")
            lines.append(
                f"  +{e.get('dt', 0.0):>10.6f}s  {e.get('src', '?'):<10}"
                f" {e.get('kind', '?'):<16}"
                + (f" ±{_fmt_s(err)}" if err is not None else "")
                + (f"  {extra}" if extra else ""))
        gaps = []
        for a, b in zip(evs, evs[1:]):
            gaps.append((b.get("t", 0.0) - a.get("t", 0.0),
                         f"{a.get('src')}:{a.get('kind')} -> "
                         f"{b.get('src')}:{b.get('kind')}"))
        gaps.sort(reverse=True)
        if gaps:
            lines.append("where the time went (largest gaps):")
            for i, (dur, desc) in enumerate(gaps[:6], 1):
                lines.append(f"  {i}. {_fmt_s(dur):>10}  {desc}")
    else:
        lines.append("no request timeline in this dump "
                     f"(trigger was {trig.get('kind', 'unknown')} — "
                     "router-side fleet state only)")
    state = fleet.get("fleet_state") or {}
    if state:
        reps = state.get("replicas") or {}
        lines.append(f"fleet state: {len(reps)} replica slots")
        for slot in sorted(reps, key=str):
            r = reps[slot]
            lines.append(
                f"  slot {slot}: {r.get('state', '?')} "
                f"role={r.get('role', '?')} epoch={r.get('epoch', '?')}"
                + (f" live={r.get('live')}" if r.get("live") is not None
                   else ""))
        for k in ("assignments", "queued", "transfers", "quarantined"):
            if state.get(k):
                lines.append(f"  {k}: {state[k]}")
    health = fleet.get("health") or {}
    if health:
        deg = health.get("degraded") or []
        lines.append(f"health: degraded={deg or 'none'}  "
                     f"blackbox_dumps={health.get('blackbox_dumps', '?')}  "
                     f"trace_segments={health.get('trace_segments', '?')}")
    return "\n".join(lines)


def postmortem_cli(argv=None) -> int:
    """``ds_postmortem <fleet_blackbox.json> [--json]`` — render a fleet
    black-box dump (bin/ds_postmortem and the ``ds-tpu-postmortem``
    console script both land here)."""
    import sys

    argv = list(sys.argv if argv is None else argv)
    args = [a for a in argv[1:] if a != "--json"]
    as_json = "--json" in argv[1:]
    if len(args) != 1 or args[0] in ("-h", "--help"):
        print("usage: ds_postmortem <fleet_blackbox.json> [--json]",
              file=sys.stderr)
        return 0 if args and args[0] in ("-h", "--help") else 2
    try:
        with open(args[0], encoding="utf-8") as f:
            rec = json.load(f)
    except (OSError, ValueError) as e:
        print(f"ds_postmortem: cannot read {args[0]}: {e}",
              file=sys.stderr)
        return 1
    try:
        if as_json:
            print(json.dumps((rec.get("fleet") or {}).get("timeline"),
                             indent=1))
        else:
            print(postmortem_report(rec))
    except BrokenPipeError:              # | head closed the pipe: fine
        return 0
    return 0
