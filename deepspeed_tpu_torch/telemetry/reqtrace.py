"""Per-request lifecycle tracing: trace IDs, ring-buffered timelines,
per-tenant attribution, SLO-breach auto-capture.

Base telemetry is process-aggregate — the histograms say p99 TTFT
regressed but cannot name the request, tenant, or scheduler decision that
caused it. This module adds the request-scoped layer (Dapper, Sigelman et
al. 2010; the unit SGLang's router and every production LLM scheduler key
on): every admitted sequence gets a **trace ID** and a bounded, sampled
**lifecycle timeline** — enqueue, admit (prefix-cache hit extent, pages
pinned), each prefill chunk, each decode window/step, each speculative
round, rollback/rewind/eviction events, commits, release — emitted by
``engine_v2`` / ``scheduler`` / ``ragged`` / ``prefix_cache`` /
``speculative`` through one ``event()`` call. On top of the timelines:

- **exemplars** — SLO histogram observations carry the trace ID of the
  observed request (OpenMetrics exemplar syntax on
  ``/metrics?exemplars=1``), so a tail bucket links to a concrete
  timeline instead of an anonymous count;
- **per-tenant attribution** — bounded-cardinality labeled series
  (``serving_tenant_*``: tokens prefilled/decoded, KV page-seconds,
  speculative verify compute, TTFT/TBT/queue-wait histograms) with
  sanitized tenant label values and an ``other`` overflow bucket once
  :data:`TENANT_CARDINALITY_CAP` distinct tenants exist — a hostile or
  buggy client can never explode the scrape;
- **SLO-breach auto-capture** — configurable TTFT/TBT thresholds; on
  breach the offending request's full timeline plus an engine/pool state
  snapshot dump to the flight recorder (rate-limited by
  ``breach_interval_s``), with an optional bounded ``torch.profiler``
  capture of the CUDA activity that follows (``breach_profile_dir``).

Disabled (the default) is zero-overhead like the rest of telemetry: every
entry point is one ``enabled`` check, nothing buffers, nothing allocates —
tested like the base telemetry's zero-overhead gate.

The canonical lifecycle-transition set lives in :data:`LIFECYCLE_EVENTS`;
``tests/test_torch_reqtrace.py`` AST-scans this package and fails when a
transition is emitted under an undeclared kind or a declared kind is never
emitted anywhere (the drift guard for the scheduler wiring).
"""
from __future__ import annotations

import collections
import itertools
import os
import threading
import time
import zlib

from ..utils.logging import logger
from .metrics import LATENCY_BUCKETS_S, sanitize_label_value

#: THE request-lifecycle transition enum. Every kind here is emitted
#: somewhere in deepspeed_tpu_torch/ and every ``event()`` emission uses a kind
#: from this tuple — the drift guard enforces both directions.
LIFECYCLE_EVENTS = (
    "enqueue",          # put() accepted the request (engine_v2)
    "admit",            # pages reserved, prefix-cache chain pinned (ragged)
    "evict",            # prefix-LRU pages reclaimed under pressure
    "prefill_chunk",    # one scheduled prompt chunk (scheduler)
    "decode_step",      # one [S,1] decode plan row (scheduler)
    "decode_window",    # one multi-iteration decode window (engine_v2)
    "spec_round",       # one speculative verify round (engine_v2)
    "spec_depth_adapt",  # accept-rate EMA adapted the draft depth
    "rollback",         # provisional tree discarded (ragged)
    "rewind",           # history reset / draft-mirror resync
    "commit",           # sampled tokens reached the committed view
    "release",          # slot + pages freed / published (ragged)
    "migrate_out",      # page bundle exported, sequence pinned (ragged);
    #                     carries the serving trace ID linking both sides
    "migrate_in",       # page bundle imported + trie seeded (ragged);
    #                     same serving trace ID as the exporter's event
    "kv_pull",          # placement-time radix pull (ragged): dir="out" =
    #                     a peer's cached chain snapshotted for export,
    #                     dir="in" = pulled pages adopted into the local
    #                     trie; both carry the pulling request's serving
    #                     trace ID, linking the two replicas' timelines
    "weight_swap",      # in-place weight hot-swap (engine_v2.swap_weights):
    #                     a pool-level event (uid -1 — it pauses EVERY live
    #                     sequence) carrying the new weight-version id +
    #                     quiesce/swap durations; the serving replica
    #                     additionally stamps each in-flight request's
    #                     fleet-trace segment so rolling-deploy stalls are
    #                     attributable per request
    "kv_tier",          # KV tiering (inference/kvtier.py): dir="demote"
    #                     = evicted chains serialized into the host-RAM/
    #                     NVMe tier (a pool-level event, uid -1 — the
    #                     reclaimed pages had no live owner), dir=
    #                     "promote" = a tier-resident chain adopted back
    #                     into the trie at an admission miss instead of
    #                     recomputing (pages + tokens saved ride the
    #                     event)
)

#: hard cap on distinct tenant label values per process — the scrape's
#: cardinality bound. Tenants past the cap fold into
#: :data:`TENANT_OVERFLOW_LABEL`. bin/check_metric_names.py pins this
#: constant (present, integer, 1..64) so a refactor can't silently remove
#: the bound.
TENANT_CARDINALITY_CAP = 32
TENANT_OVERFLOW_LABEL = "other"


class _Req:
    """One request's trace state: identity + the bounded event timeline."""

    __slots__ = ("trace_id", "uid", "tenant", "sampled", "t0", "wall0",
                 "t_admit", "pages", "events", "dropped")

    def __init__(self, trace_id: str, uid: int, tenant: str, sampled: bool):
        self.trace_id = trace_id
        self.uid = uid
        self.tenant = tenant
        self.sampled = sampled
        self.t0 = time.perf_counter()
        #: wall anchor captured once at begin: per-event wall clocks are
        #: wall0 + (t - t0) — zero per-event cost, and good enough to
        #: correlate a timeline with external logs / other processes
        #: (monotonic-only dumps cannot be correlated at all)
        self.wall0 = time.time()
        self.t_admit: float | None = None
        self.pages = 0                      # blocks reserved at admit
        self.events: list[tuple] = []       # (t, kind, fields|None)
        self.dropped = 0

    def to_dict(self) -> dict:
        out = {"trace_id": self.trace_id, "uid": self.uid,
               "tenant": self.tenant, "sampled": self.sampled,
               "t_start": self.t0, "t_start_wall": self.wall0,
               "events_dropped": self.dropped,
               "events": [dict({"t": t,
                                "wall": round(
                                    self.wall0 + (t - self.t0), 6),
                                "kind": kind}, **(fields or {}))
                          for t, kind, fields in self.events]}
        return out


class ReqTracer:
    """Request-scoped tracer. One instance rides the process-wide
    :class:`~.Telemetry` bundle (``get_telemetry().reqtrace``); the engine
    attaches it to the StateManager / scheduler / prefix cache /
    speculative proposer so all five emit into the same timelines.

    Memory is bounded forever: live traces are capped at ``max_live``
    (oldest dropped), completed timelines keep the newest
    ``timeline_ring``, each timeline keeps its FIRST ``max_events`` events
    (head-retention — admit/prefill context survives; a ``dropped``
    counter marks truncation), and unattributed (uid < 0) events ride a
    small global ring."""

    def __init__(self, registry=None, recorder=None, enabled: bool = False,
                 sample: float = 1.0, timeline_ring: int = 256,
                 max_events: int = 1024, max_live: int = 4096,
                 slo_ttft_s: float | None = None,
                 slo_tbt_s: float | None = None,
                 breach_interval_s: float = 60.0,
                 breach_profile_dir: str | None = None,
                 breach_profile_s: float = 2.0):
        self.registry = registry
        self.recorder = recorder
        self.enabled = bool(enabled)
        self.sample = float(sample)
        self._timeline_ring = int(timeline_ring)
        self.max_events = int(max_events)
        self.max_live = int(max_live)
        self.slo_ttft_s = slo_ttft_s
        self.slo_tbt_s = slo_tbt_s
        self.breach_interval_s = float(breach_interval_s)
        self.breach_profile_dir = breach_profile_dir
        self.breach_profile_s = float(breach_profile_s)
        #: callable returning an engine/pool state snapshot dict attached
        #: to breach dumps (engine_v2 installs a weakref-backed probe;
        #: with two engines in one process the last one wins — same
        #: caveat as the shared registry)
        self.state_probe = None
        self._live: collections.OrderedDict[int, _Req] = \
            collections.OrderedDict()
        self._done: collections.deque[_Req] = \
            collections.deque(maxlen=self._timeline_ring)
        self._global: collections.deque[tuple] = collections.deque(maxlen=256)
        self._labels: set[str] = set()
        self._ctr = itertools.count(1)
        self._pid = os.getpid()
        # wall anchor for unattributed global-ring events (same one-shot
        # scheme as _Req.wall0)
        self._mono0 = time.perf_counter()
        self._wall0 = time.time()
        self._last_breach_dump = 0.0
        self._profiling = False
        self._prof = None                 # live breach capture, if any
        self._prof_until = 0.0
        self.traces_started = 0
        self.breaches = 0
        self.breach_dumps = 0

    @property
    def timeline_ring(self) -> int:
        return self._timeline_ring

    @timeline_ring.setter
    def timeline_ring(self, n: int) -> None:
        """Resize the completed-timeline ring (newest kept). A plain
        attribute write would be a silent no-op — the deque's maxlen is
        fixed at construction."""
        n = int(n)
        if n != self._timeline_ring:
            self._timeline_ring = n
            self._done = collections.deque(self._done, maxlen=n)

    # -- identity ---------------------------------------------------------
    def tenant_label(self, tenant) -> str:
        """Sanitized, bounded-cardinality label value for ``tenant``
        (None → ``default``); past :data:`TENANT_CARDINALITY_CAP` distinct
        values everything folds into :data:`TENANT_OVERFLOW_LABEL`."""
        label = sanitize_label_value("default" if tenant is None else tenant)
        if label in self._labels:
            return label
        if len(self._labels) >= TENANT_CARDINALITY_CAP:
            return TENANT_OVERFLOW_LABEL
        self._labels.add(label)
        return label

    def begin(self, uid: int, tenant=None, prompt: int = 0,
              trace_id: str | None = None) -> str | None:
        """Open a trace for an arriving request: assign the trace ID,
        resolve the tenant label, decide sampling (deterministic in the
        trace ID), record the ``enqueue`` event. Returns the trace ID
        (None when disabled). ``trace_id`` ADOPTS an externally minted
        canonical ID instead of minting one — a serving replica passes
        the router's trace ID here so one ID names the request in every
        process the fleet assembler merges (fleettrace.py)."""
        if not self.enabled:
            return None
        trace_id = trace_id or \
            f"{self._pid:x}-{uid & 0xFFFFFFFF:x}-{next(self._ctr):x}"
        sampled = self.sample >= 1.0 or (
            (zlib.crc32(trace_id.encode()) & 0xFFFF) / 65536.0 < self.sample)
        old = self._live.pop(uid, None)
        if old is not None:                 # uid reuse without release
            self._finish(old)
        req = _Req(trace_id, uid, self.tenant_label(tenant), sampled)
        self._live[uid] = req
        while len(self._live) > self.max_live:
            self._finish(self._live.popitem(last=False)[1])
        self.traces_started += 1
        self.event(uid, "enqueue", prompt=prompt)
        return trace_id

    def exemplar(self, uid: int) -> str | None:
        """Trace ID to attach to a histogram observation for ``uid``
        (None when the request is unsampled/unknown — exemplars only link
        to timelines that exist)."""
        if not self.enabled:
            return None
        req = self._live.get(uid)
        return req.trace_id if req is not None and req.sampled else None

    # -- the one emission path -------------------------------------------
    def event(self, uid: int, kind: str, **fields) -> None:
        """Record one lifecycle event for ``uid``. ``kind`` must be a
        :data:`LIFECYCLE_EVENTS` literal at the call site
        (the drift guard). uid < 0 (or an unknown uid) lands
        in the small unattributed global ring — pool-level events like
        prefix-LRU eviction have no single owner."""
        if not self.enabled:
            return
        t = time.perf_counter()
        if self._prof is not None and t >= self._prof_until:
            self.finish_profile()
        req = self._live.get(uid)
        if req is None:
            self._global.append((t, kind, fields or None))
            return
        if req.sampled:
            if len(req.events) < self.max_events:
                req.events.append((t, kind, fields or None))
            else:
                req.dropped += 1
        if kind == "admit":
            req.t_admit = t
            req.pages = int(fields.get("blocks", 0))
            # counted HERE, not at begin(): a failed admit drop()s the
            # trace and must leave no tenant-series residue
            self._tenant_inc("serving_tenant_requests_total", req.tenant,
                             1, "requests admitted, by tenant")
        elif kind == "prefill_chunk":
            self._tenant_inc("serving_tenant_prefill_tokens_total",
                             req.tenant, fields.get("tokens", 0),
                             "prompt tokens scheduled, by tenant")
        elif kind in ("decode_step", "decode_window"):
            self._tenant_inc("serving_tenant_decode_tokens_total",
                             req.tenant, fields.get("tokens", 1),
                             "decode tokens scheduled, by tenant")
        elif kind == "spec_round":
            # verify compute = every tree node run through the target
            # forward (root included); committed tokens count as decode
            self._tenant_inc("serving_tenant_spec_verify_tokens_total",
                             req.tenant, fields.get("proposed", 0) + 1,
                             "speculative verify-forward tree nodes, "
                             "by tenant")
            self._tenant_inc("serving_tenant_decode_tokens_total",
                             req.tenant, fields.get("committed", 0),
                             "decode tokens scheduled, by tenant")
        elif kind == "release":
            pages = int(fields.get("pages", req.pages))
            t_ref = req.t_admit if req.t_admit is not None else req.t0
            self._tenant_inc("serving_tenant_kv_page_seconds_total",
                             req.tenant, pages * max(t - t_ref, 0.0),
                             "KV pool occupancy integral (pages x "
                             "seconds held), by tenant")
            self._live.pop(uid, None)
            self._finish(req)

    def _tenant_inc(self, name: str, tenant: str, v, help: str) -> None:
        if self.registry is not None and v:
            self.registry.counter(name, labels={"tenant": tenant},
                                  help=help).inc(v)

    def _finish(self, req: _Req) -> None:
        if req.sampled and req.events:
            self._done.append(req)

    def forget(self, uid: int) -> None:
        """Finalize a live trace without a ``release`` event (engine flush
        safety net — idempotent)."""
        req = self._live.pop(uid, None)
        if req is not None:
            self._finish(req)

    def drop(self, uid: int) -> None:
        """Discard a live trace entirely (failed admit: the request never
        existed as far as timelines are concerned)."""
        self._live.pop(uid, None)

    # -- SLO observations / breach capture --------------------------------
    def observe_ttft(self, uid: int, v: float) -> None:
        self._observe_slo(uid, "serving_tenant_ttft_s", v, 1,
                          "admission -> first committed token, by tenant",
                          "ttft", self.slo_ttft_s)

    def observe_tbt(self, uid: int, v: float, n: int = 1) -> None:
        self._observe_slo(uid, "serving_tenant_tbt_s", v, n,
                          "per-token time between committed tokens, "
                          "by tenant", "tbt", self.slo_tbt_s)

    def observe_queue_wait(self, uid: int, v: float) -> None:
        self._observe_slo(uid, "serving_tenant_queue_wait_s", v, 1,
                          "admission -> first scheduled chunk, by tenant",
                          "queue_wait", None)

    def _observe_slo(self, uid: int, name: str, v: float, n: int,
                     help: str, slo: str, threshold: float | None) -> None:
        if not self.enabled:
            return
        req = self._live.get(uid)
        if req is None:
            return
        if self.registry is not None:
            self.registry.histogram(
                name, buckets=LATENCY_BUCKETS_S,
                labels={"tenant": req.tenant}, help=help).observe(
                v, n=n, exemplar=req.trace_id if req.sampled else None)
        if threshold is not None and v > threshold:
            self._breach(slo, req, v, threshold)

    def _breach(self, slo: str, req: _Req, value: float,
                threshold: float) -> None:
        """An SLO threshold was crossed: count it, and (rate-limited) dump
        the offending request's full timeline + an engine state snapshot
        to the flight recorder, optionally kicking a bounded profiler
        capture."""
        self.breaches += 1
        if self.registry is not None:
            self.registry.counter(
                "serving_slo_breach_total", labels={"slo": slo},
                help="SLO threshold crossings observed").inc()
        now = time.time()
        if self.recorder is not None:
            # the breadcrumb is unconditional (cheap, read only on dumps);
            # the full dump below is rate-limited
            self.recorder.note("slo_breach", slo=slo, uid=req.uid,
                               trace_id=req.trace_id, tenant=req.tenant,
                               value=round(value, 6),
                               threshold=threshold)
        if now - self._last_breach_dump < self.breach_interval_s:
            return
        self._last_breach_dump = now
        state = None
        if self.state_probe is not None:
            try:
                state = self.state_probe()
            except Exception as e:      # a probe bug must not kill serving
                logger.warning(f"reqtrace: engine state probe failed on "
                               f"breach dump: {e!r}")
        if self.recorder is not None:
            self.recorder.dump(
                "slo_breach",
                detail=f"{slo} {value:.4f}s > {threshold:.4f}s "
                       f"(uid {req.uid}, trace {req.trace_id})",
                extra={"breach": {"slo": slo, "uid": req.uid,
                                  "trace_id": req.trace_id,
                                  "tenant": req.tenant,
                                  "value": value, "threshold": threshold},
                       "request_timeline": req.to_dict(),
                       "engine_state": state})
            self.breach_dumps += 1
        if self.breach_profile_dir:
            self._profile_capture()

    def _profile_capture(self) -> None:
        """Bounded ``torch.profiler`` capture (CPU ranges and CUDA kernels,
        at most one in flight) of the seconds FOLLOWING a breach — tail
        latency usually has a persistent cause worth a device timeline.

        The profiler runs on the thread that observed the breach (the
        engine's): its CPU ranges are recorded per thread, so a capture
        started elsewhere would see the kernels but not the ``dispatch``
        spans that launched them. It ends at the first lifecycle event
        past ``breach_profile_s``, or at :meth:`finish_profile`, and
        writes ``breach_<pid>_<n>.json`` (a Chrome trace) into
        ``breach_profile_dir``. Once a profiler has run, CUPTI stays
        subscribed and later launches cost more host time: the capture is
        off unless that directory is set."""
        if self._profiling:
            return
        try:
            import torch

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:   # profiler may be busy / unavailable
            logger.warning(f"reqtrace: breach profiler capture failed: "
                           f"{e!r}")
            return
        self._profiling = True
        self._prof = prof
        self._prof_until = time.perf_counter() + self.breach_profile_s

    def finish_profile(self) -> str | None:
        """End a live breach capture now and write its trace; returns the
        trace's path (None when no capture was live or the write failed).
        Call on the thread that served the breaching request."""
        prof, self._prof = self._prof, None
        if prof is None:
            return None
        path = None
        try:
            prof.stop()
            os.makedirs(self.breach_profile_dir, exist_ok=True)
            path = os.path.join(self.breach_profile_dir,
                                f"breach_{self._pid}_{self.breaches}.json")
            prof.export_chrome_trace(path)
            logger.warning(f"reqtrace: breach profiler capture -> {path}")
        except Exception as e:
            logger.warning(f"reqtrace: breach profiler capture failed: "
                           f"{e!r}")
            path = None
        finally:
            self._profiling = False
        return path

    # -- reading ----------------------------------------------------------
    def live_timelines(self) -> list[dict]:
        return [r.to_dict() for r in self._live.values()]

    def timelines(self) -> list[dict]:
        """Completed (sampled) timelines, oldest -> newest."""
        return [r.to_dict() for r in self._done]

    def find(self, trace_id: str) -> dict | None:
        for r in list(self._live.values()) + list(self._done):
            if r.trace_id == trace_id:
                return r.to_dict()
        return None

    def global_events(self) -> list[dict]:
        return [dict({"t": t,
                      "wall": round(self._wall0 + (t - self._mono0), 6),
                      "kind": kind}, **(fields or {}))
                for t, kind, fields in self._global]

    def __len__(self) -> int:
        return len(self._live) + len(self._done)

    def clear(self) -> None:
        """Drop every timeline + per-run counters (bench zeroes this with
        the registry so each measured run's artifact stands alone). The
        tenant label table resets too — the registry's tenant series were
        just dropped, so labels re-admit against a fresh cap."""
        self._live.clear()
        self._done.clear()
        self._global.clear()
        self._labels.clear()
        self.traces_started = 0
        self.breaches = 0
        self.breach_dumps = 0

    # -- chrome-trace overlay ---------------------------------------------
    def chrome_events(self, epoch: float) -> list[dict]:
        """Trace-event JSON for every sampled timeline, on the SAME clock
        as the span tracer (``epoch`` = the tracer's perf_counter zero),
        so request lifecycles interleave with host spans in one Perfetto
        view: pid 1 is the "requests" track, one tid per trace, an "X"
        span covering the request plus an instant event per lifecycle
        transition."""
        out: list[dict] = []
        for req in list(self._done) + list(self._live.values()):
            if not req.sampled or not req.events:
                continue
            tid = zlib.crc32(req.trace_id.encode()) % 1_000_000 + 1
            t_first = req.events[0][0]
            t_last = req.events[-1][0]
            out.append({"name": "thread_name", "ph": "M", "pid": 1,
                        "tid": tid,
                        "args": {"name": f"req {req.trace_id} "
                                         f"[{req.tenant}]"}})
            out.append({"name": "request", "cat": "reqtrace", "ph": "X",
                        "pid": 1, "tid": tid,
                        "ts": (t_first - epoch) * 1e6,
                        "dur": max((t_last - t_first) * 1e6, 1.0),
                        "args": {"trace_id": req.trace_id,
                                 "tenant": req.tenant, "uid": req.uid}})
            for t, kind, fields in req.events:
                ev = {"name": kind, "cat": "reqtrace", "ph": "i", "s": "t",
                      "pid": 1, "tid": tid, "ts": (t - epoch) * 1e6}
                if fields:
                    ev["args"] = {k: v if isinstance(
                        v, (int, float, str, bool, type(None))) else repr(v)
                        for k, v in fields.items()}
                out.append(ev)
        return out
