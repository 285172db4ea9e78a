"""Bounded on-disk time-series store for fleet metric history.

The observability stack up to here is *instantaneous*: ``/metrics`` serves
the current snapshot and every policy threshold is calibrated by hand
against nothing.  This module gives the fleet a memory — a periodic
sampler turns :class:`~deepspeed_tpu_torch.telemetry.metrics.MetricsRegistry`
snapshots into an append-only, crc-framed, segmented on-disk log (the same
framing discipline as ``serving/journal.py`` and ``inference/kvtier.py``)
plus an in-memory index answering trend queries:

- counters are stored as **deltas** between consecutive samples (clamped
  at zero so a restarted source re-bases instead of producing a huge
  negative spike),
- gauges are stored **last-write** every tick,
- histograms store per-bucket count deltas (plus sum/count deltas), so a
  trailing-window percentile is exact over that window rather than
  lifetime-cumulative.

Each record is tagged with a ``src`` ("router", "replica0", ...) so one
store holds the whole fleet: the router samples its own registry plus
every replica's heartbeat-shipped snapshot file.

Durability discipline (mirrors ``serving/journal.py``):

- one record per line: ``<compact json>|<crc32 hex>\\n``;
- segments named ``ts-%08d.log``, rotated past ``segment_bytes``;
- retention: oldest whole segments are deleted once total bytes exceed
  ``retention_bytes`` (the active segment is never deleted);
- on open, retained segments are replayed into the memory index; torn
  tails and corrupt lines are counted in :attr:`TimeSeriesStore.bad_records`
  and skipped — never fatal.

``path=None`` gives a memory-only store (no file I/O at all), which is
what tests and short-lived tools use.  The disabled configuration is the
*absence* of a store — nothing in this module runs unless constructed.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
import zlib
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["TimeSeriesStore", "StoreSampler", "series_key", "DEFAULT_SEGMENT_BYTES", "DEFAULT_RETENTION_BYTES"]

#: rotate the active segment once it crosses this many bytes
DEFAULT_SEGMENT_BYTES = 1 << 20

#: delete oldest segments once the store exceeds this many bytes on disk
DEFAULT_RETENTION_BYTES = 8 << 20

#: default bound on in-memory sample records (ring buffer)
DEFAULT_MEMORY_RECORDS = 4096

_SEG_PREFIX = "ts-"
_SEG_SUFFIX = ".log"
_SEG_RE = re.compile(r"^ts-(\d{8})\.log$")


def series_key(name: str, labels: Optional[Dict[str, str]] = None) -> str:
    """Flatten ``name`` + ``labels`` into the canonical series key.

    Matches Prometheus exposition shape (sorted labels) so keys are stable
    across processes: ``serving_router_ttft_s`` or
    ``serving_tokens_total{phase="decode"}``.
    """
    if not labels:
        return name
    inner = ",".join('%s="%s"' % (k, v) for k, v in sorted(labels.items()))
    return "%s{%s}" % (name, inner)


def _key_matches(key: str, name: str, labels: Optional[Dict[str, str]]) -> bool:
    """True when series ``key`` is family ``name`` carrying all of ``labels``."""
    if key != name and not key.startswith(name + "{"):
        return False
    if labels:
        for k, v in labels.items():
            if '%s="%s"' % (k, v) not in key:
                return False
    return True


class TimeSeriesStore:
    """Append-only fleet metric history with trend queries.

    Single-writer (the sampling thread/loop); queries may come from other
    threads (the exposition server's ``/series`` endpoint) and are guarded
    by a lock around the in-memory index.  Disk writes are line-atomic in
    practice and torn tails are skipped on replay, so a crash mid-write
    loses at most the last sample.
    """

    def __init__(
        self,
        path: Optional[str] = None,
        *,
        segment_bytes: int = DEFAULT_SEGMENT_BYTES,
        retention_bytes: int = DEFAULT_RETENTION_BYTES,
        memory_records: int = DEFAULT_MEMORY_RECORDS,
    ) -> None:
        self.path = path
        self.segment_bytes = max(1, int(segment_bytes))
        self.retention_bytes = max(self.segment_bytes, int(retention_bytes))
        #: records skipped on replay (torn tail / crc mismatch / bad json)
        self.bad_records = 0
        #: records appended (lifetime, including replayed)
        self.records = 0
        #: segments deleted by retention
        self.segments_pruned = 0
        self._lock = threading.Lock()
        # ring buffer of sample records: {"t": wall, "src": str,
        #   "c": {key: delta}, "g": {key: value}, "h": {key: [bounds, dcounts, dsum, dn]}}
        self._recs: deque = deque(maxlen=max(16, int(memory_records)))
        # last raw snapshot per source, for delta computation
        self._prev: Dict[str, Dict[str, Any]] = {}
        # every (src, key, kind) ever observed — lets rate() report 0.0
        # (series known, quiet) vs None (series never seen)
        self._seen: Dict[Tuple[str, str], str] = {}
        self._fd = -1
        self._seg_index = 0
        self._seg_bytes = 0
        if self.path is not None:
            os.makedirs(self.path, exist_ok=True)
            self._replay()
            self._open_segment()

    # ------------------------------------------------------------------ disk

    def segments(self) -> List[str]:
        """Sorted absolute paths of on-disk segments (oldest first)."""
        if self.path is None:
            return []
        try:
            names = sorted(n for n in os.listdir(self.path) if _SEG_RE.match(n))
        except OSError:
            return []
        return [os.path.join(self.path, n) for n in names]

    def disk_bytes(self) -> int:
        total = 0
        for p in self.segments():
            try:
                total += os.path.getsize(p)
            except OSError:
                continue
        return total

    def _replay(self) -> None:
        """Load retained segments into the memory index. Never raises."""
        for seg in self.segments():
            m = _SEG_RE.match(os.path.basename(seg))
            if m:
                self._seg_index = max(self._seg_index, int(m.group(1)))
            try:
                with open(seg, "rb") as f:
                    blob = f.read()
            except OSError:
                self.bad_records += 1
                continue
            for raw in blob.split(b"\n"):
                if not raw:
                    continue
                body, _, crc = raw.rpartition(b"|")
                if not body or len(crc) != 8:
                    self.bad_records += 1
                    continue
                try:
                    if int(crc, 16) != (zlib.crc32(body) & 0xFFFFFFFF):
                        self.bad_records += 1
                        continue
                    rec = json.loads(body)
                except (ValueError, OverflowError):
                    self.bad_records += 1
                    continue
                if not isinstance(rec, dict) or "t" not in rec or "src" not in rec:
                    self.bad_records += 1
                    continue
                self._index(rec)
                self.records += 1

    def _open_segment(self) -> None:
        assert self.path is not None
        self._seg_index += 1
        seg = os.path.join(self.path, "%s%08d%s" % (_SEG_PREFIX, self._seg_index, _SEG_SUFFIX))
        self._fd = os.open(seg, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
        self._seg_bytes = 0

    def _write(self, rec: Dict[str, Any]) -> None:
        if self._fd < 0:
            return
        line = json.dumps(rec, separators=(",", ":")).encode("utf-8")
        buf = line + b"|%08x\n" % (zlib.crc32(line) & 0xFFFFFFFF)
        try:
            os.write(self._fd, buf)
        except OSError:
            return  # history is advisory; never take the router down over it
        self._seg_bytes += len(buf)
        if self._seg_bytes >= self.segment_bytes:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1
            self._open_segment()
            self._retain()

    def _retain(self) -> None:
        """Delete oldest whole segments past the retention cap."""
        segs = self.segments()
        sizes = []
        for p in segs:
            try:
                sizes.append(os.path.getsize(p))
            except OSError:
                sizes.append(0)
        total = sum(sizes)
        # never delete the active (last) segment
        for p, sz in zip(segs[:-1], sizes[:-1]):
            if total <= self.retention_bytes:
                break
            try:
                os.remove(p)
            except OSError:
                continue
            total -= sz
            self.segments_pruned += 1

    def close(self) -> None:
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1

    # -------------------------------------------------------------- sampling

    def sample(self, src: str, snapshot: Dict[str, Any], now: float) -> bool:
        """Record one registry snapshot for ``src`` at wall time ``now``.

        ``snapshot`` is the :meth:`MetricsRegistry.snapshot` dict.  Counter
        and histogram values are stored as deltas vs the previous sample
        from the same source (negative deltas — a restarted source —
        re-base to the full value).  Returns True when a record was
        appended (quiet ticks with no gauges and no counter movement still
        append, so per-source liveness is visible in the record stream).
        """
        flat: Dict[str, Tuple[str, Any]] = {}
        for fam, meta in snapshot.items():
            kind = meta.get("type")
            for s in meta.get("series", ()):
                key = series_key(fam, s.get("labels") or None)
                if kind == "histogram":
                    flat[key] = (kind, (list(s.get("bounds") or ()), list(s.get("counts") or ()),
                                        float(s.get("sum", 0.0)), int(s.get("count", 0))))
                else:
                    flat[key] = (kind, float(s.get("value", 0.0)))
        prev = self._prev.get(src, {})
        rec: Dict[str, Any] = {"t": now, "src": src}
        counters: Dict[str, float] = {}
        gauges: Dict[str, float] = {}
        hists: Dict[str, list] = {}
        for key, (kind, val) in flat.items():
            if kind == "counter":
                old = prev.get(key)
                d = val - old[1] if old is not None and old[0] == "counter" else val
                if d < 0:
                    d = val  # source restarted: re-base
                if d != 0:
                    counters[key] = d
            elif kind == "gauge":
                gauges[key] = val
            elif kind == "histogram":
                bounds, counts, hsum, hcount = val
                old = prev.get(key)
                if old is not None and old[0] == "histogram" and list(old[1][0]) == bounds:
                    ocounts, osum, ocount = old[1][1], old[1][2], old[1][3]
                    dcounts = [c - o for c, o in zip(counts, ocounts)]
                    dsum, dn = hsum - osum, hcount - ocount
                    if any(d < 0 for d in dcounts) or dn < 0:
                        dcounts, dsum, dn = counts, hsum, hcount  # re-base
                else:
                    dcounts, dsum, dn = counts, hsum, hcount
                if dn != 0:
                    hists[key] = [bounds, dcounts, dsum, dn]
        self._prev[src] = flat
        if counters:
            rec["c"] = counters
        if gauges:
            rec["g"] = gauges
        if hists:
            rec["h"] = hists
        with self._lock:
            self._index(rec)
        self.records += 1
        self._write(rec)
        return True

    def sample_many(self, snapshots: Dict[str, Dict[str, Any]], now: float) -> int:
        """Record snapshots from several sources at one tick."""
        n = 0
        for src in sorted(snapshots):
            if self.sample(src, snapshots[src], now):
                n += 1
        return n

    def _index(self, rec: Dict[str, Any]) -> None:
        self._recs.append(rec)
        src = rec["src"]
        for key in rec.get("c", ()):
            self._seen[(src, key)] = "counter"
        for key in rec.get("g", ()):
            self._seen[(src, key)] = "gauge"
        for key in rec.get("h", ()):
            self._seen[(src, key)] = "histogram"

    # --------------------------------------------------------------- queries

    def sources(self) -> List[str]:
        with self._lock:
            return sorted({src for (src, _k) in self._seen})

    def seen(self, name: str, src: Optional[str] = None,
             labels: Optional[Dict[str, str]] = None) -> bool:
        """True when any matching series has ever carried a value."""
        with self._lock:
            for (s, key) in self._seen:
                if src is not None and s != src:
                    continue
                if _key_matches(key, name, labels):
                    return True
        return False

    def _scan(self, t0: Optional[float], t1: Optional[float],
              src: Optional[str]) -> List[Dict[str, Any]]:
        with self._lock:
            recs = list(self._recs)
        out = []
        for rec in recs:
            if src is not None and rec["src"] != src:
                continue
            t = rec["t"]
            if t0 is not None and t < t0:
                continue
            if t1 is not None and t > t1:
                continue
            out.append(rec)
        return out

    def range(self, name: str, t0: Optional[float] = None, t1: Optional[float] = None,
              src: Optional[str] = None, labels: Optional[Dict[str, str]] = None
              ) -> List[Tuple[float, float]]:
        """Time-ordered ``(t, value)`` points for one metric family.

        Counters are re-accumulated cumulatively *within the queried
        window* (each point is the running sum of deltas since ``t0``);
        gauges are raw last-write points.  Multiple matching series
        (several label sets) are summed per record for counters and for
        gauges the sum is reported too (occupancy-style gauges add
        meaningfully; use ``labels=`` to pin one series otherwise).
        """
        pts: List[Tuple[float, float]] = []
        acc = 0.0
        for rec in self._scan(t0, t1, src):
            hit = False
            v = 0.0
            for key, d in rec.get("c", {}).items():
                if _key_matches(key, name, labels):
                    acc += d
                    v = acc
                    hit = True
            for key, g in rec.get("g", {}).items():
                if _key_matches(key, name, labels):
                    v += g
                    hit = True
            for key, h in rec.get("h", {}).items():
                if _key_matches(key, name, labels):
                    acc += h[3]
                    v = acc
                    hit = True
            if hit:
                pts.append((rec["t"], v))
        return pts

    def rate(self, name: str, window_s: float, now: Optional[float] = None,
             src: Optional[str] = None, labels: Optional[Dict[str, str]] = None
             ) -> Optional[float]:
        """Per-second rate of a counter over the trailing window.

        Sum of stored deltas in ``(now - window_s, now]`` divided by the
        window.  Returns 0.0 — not None — for a series the store has seen
        but which moved nothing in the window (a stalled counter *is* the
        signal); None only when no matching series was ever recorded.
        """
        if now is None:
            now = self.last_t()
            if now is None:
                return None
        window_s = max(1e-9, float(window_s))
        total = 0.0
        hit = False
        for rec in self._scan(now - window_s, now, src):
            for key, d in rec.get("c", {}).items():
                if _key_matches(key, name, labels):
                    total += d
                    hit = True
            for key, h in rec.get("h", {}).items():
                if _key_matches(key, name, labels):
                    total += h[3]
                    hit = True
        if not hit and not self.seen(name, src, labels):
            return None
        return total / window_s

    def percentile(self, name: str, q: float, window_s: float,
                   now: Optional[float] = None, src: Optional[str] = None,
                   labels: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Histogram percentile over the trailing window (bucket deltas)."""
        if now is None:
            now = self.last_t()
            if now is None:
                return None
        bounds: List[float] = []
        counts: List[float] = []
        for rec in self._scan(now - max(1e-9, float(window_s)), now, src):
            for key, h in rec.get("h", {}).items():
                if not _key_matches(key, name, labels):
                    continue
                hb, hc = h[0], h[1]
                if not bounds:
                    bounds = list(hb)
                    counts = [0.0] * len(hc)
                if list(hb) == bounds and len(hc) == len(counts):
                    counts = [a + b for a, b in zip(counts, hc)]
        return _bucket_percentile(bounds, counts, q)

    def percentile_series(self, name: str, q: float, window_s: float,
                          t0: Optional[float] = None, t1: Optional[float] = None,
                          src: Optional[str] = None,
                          labels: Optional[Dict[str, str]] = None
                          ) -> List[Tuple[float, float]]:
        """Rolling-window percentile evaluated at every sample tick.

        For each record time ``t`` in ``[t0, t1]`` that carries matching
        bucket deltas, the percentile of all deltas in ``(t - window_s, t]``.
        This is the sparkline feed: a trend of tail latency, not a single
        lifetime-cumulative number.
        """
        ticks = sorted({rec["t"] for rec in self._scan(t0, t1, src)
                        if any(_key_matches(k, name, labels) for k in rec.get("h", {}))})
        out: List[Tuple[float, float]] = []
        for t in ticks:
            v = self.percentile(name, q, window_s, now=t, src=src, labels=labels)
            if v is not None:
                out.append((t, v))
        return out

    def latest(self, name: str, src: Optional[str] = None,
               labels: Optional[Dict[str, str]] = None, agg: str = "last"
               ) -> Optional[float]:
        """Most recent value of a gauge (or cumulative total of a counter).

        ``agg`` resolves multiple matching series in the newest carrying
        record: ``last`` (arbitrary stable), ``max``, ``min``, ``absmax``.
        Counters report the sum of all retained deltas (windowless total).
        """
        # gauges: newest record carrying a match wins
        with self._lock:
            recs = list(self._recs)
        for rec in reversed(recs):
            if src is not None and rec["src"] != src:
                continue
            vals = [g for key, g in rec.get("g", {}).items() if _key_matches(key, name, labels)]
            if vals:
                if agg == "max":
                    return max(vals)
                if agg == "min":
                    return min(vals)
                if agg == "absmax":
                    return max(vals, key=abs)
                return vals[-1]
        pts = self.range(name, src=src, labels=labels)
        if pts:
            return pts[-1][1]
        return None

    def last_t(self) -> Optional[float]:
        with self._lock:
            if not self._recs:
                return None
            return self._recs[-1]["t"]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            n_series = len(self._seen)
            n_recs = len(self._recs)
        return {
            "path": self.path,
            "records": self.records,
            "memory_records": n_recs,
            "series": n_series,
            "bad_records": self.bad_records,
            "segments": len(self.segments()),
            "segments_pruned": self.segments_pruned,
            "disk_bytes": self.disk_bytes(),
            "retention_bytes": self.retention_bytes,
        }


def _bucket_percentile(bounds: List[float], counts: List[float], q: float) -> Optional[float]:
    """Linear-interpolated percentile from bucket counts, ``q`` in [0, 1].

    ``counts`` has ``len(bounds) + 1`` slots (the trailing +Inf bucket).
    Same estimator as :meth:`telemetry.metrics.Histogram.percentile` so
    store-window percentiles agree with live exposition percentiles.
    """
    total = sum(counts)
    if not bounds or total <= 0:
        return None
    target = max(0.0, min(1.0, q)) * total
    acc = 0.0
    for i, c in enumerate(counts):
        acc += c
        if acc >= target and c:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else bounds[-1]
            frac = (target - (acc - c)) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
    return bounds[-1]


class StoreSampler(threading.Thread):
    """Daemon thread sampling one registry into a store at a fixed cadence.

    The router does *not* use this — its sampling rides the ``poll()``
    tick so the store sees exactly the scheduler's clock.  This thread is
    for standalone processes (bench, a lone replica) that want history
    without a control loop to piggyback on.
    """

    def __init__(self, store: TimeSeriesStore, registry, interval_s: float = 1.0,
                 src: str = "local", now_fn=None) -> None:
        super().__init__(name="ds-watchtower-sampler", daemon=True)
        self.store = store
        self.registry = registry
        self.interval_s = max(0.05, float(interval_s))
        self.src = src
        self._now = now_fn if now_fn is not None else time.time
        self._stop = threading.Event()
        self.ticks = 0

    def run(self) -> None:
        while not self._stop.wait(timeout=self.interval_s):
            try:
                self.store.sample(self.src, self.registry.snapshot(), now=self._now())
                self.ticks += 1
            except (OSError, ValueError, RuntimeError):
                continue  # advisory history: swallow and keep sampling

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self.join(timeout=timeout)
