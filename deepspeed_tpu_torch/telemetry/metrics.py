"""Metrics registry: counters, gauges, fixed-bucket histograms; mergeable
snapshots; Prometheus text-format rendering.

Design constraints, in order:
- **Hot-path cheap.** ``Counter.inc`` is one float add; ``Histogram.observe``
  is one bisect + two adds. No locks on observation (GIL-atomic ops only —
  a racing observe can interleave, never corrupt); the registry lock guards
  metric *creation* only.
- **Mergeable.** ``snapshot()`` returns plain data and ``merge()`` folds
  another process's snapshot in — counters/histogram buckets add, gauges
  last-write-wins — so a multi-host job can aggregate per-host registries.
- **Prometheus-safe by construction.** Every name passes
  :func:`sanitize_metric_name`; exposition can never 500 on a bad tag
  (bin/check_metric_names.py lints emitted literals to the same rule).

Fixed buckets (vs. t-digest etc.) are deliberate: mergeable across
processes by plain addition, constant memory, and the SLO questions
("p99 TTFT under 2s?") only need resolution near the targets — pick
buckets around them.
"""
from __future__ import annotations

import functools
import re
import threading
import time as _time
from bisect import bisect_left
from typing import Iterable

_VALID_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*\Z")
_INVALID_CHARS = re.compile(r"[^a-zA-Z0-9_:]")
_VALID_LABEL = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*\Z")
_LABEL_VALUE_BAD = re.compile(r"[^A-Za-z0-9_\-./:]")

#: longest label VALUE the sanitizer emits — tenant names, peer file
#: names etc. are untrusted input; unbounded values would bloat every
#: scrape line they ride
LABEL_VALUE_MAX_LEN = 64

#: default latency buckets (seconds): ~geometric 100µs → 60s, densified
#: around serving SLO territory (tens of ms .. few s)
LATENCY_BUCKETS_S = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.075, 0.1, 0.15, 0.25, 0.5, 0.75, 1.0, 1.5, 2.5, 5.0, 10.0, 30.0, 60.0)

#: default buckets for ratios/fractions in [0, 1]
RATIO_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9,
                 0.95, 0.99, 1.0)


@functools.lru_cache(maxsize=4096)
def sanitize_metric_name(name: str) -> str:
    """Map an arbitrary tag to a valid Prometheus metric name
    (``[a-zA-Z_:][a-zA-Z0-9_:]*``): invalid chars → ``_``, a leading digit
    gets a ``_`` prefix. Raises on tags that cannot be salvaged (empty /
    nothing left) — exposition must never meet an invalid name.

    Keep in sync with bin/check_metric_names.py ``sanitize`` (the repo lint
    applies the same rule to emitted literals at test time)."""
    out = _INVALID_CHARS.sub("_", name)
    if out and out[0].isdigit():
        out = "_" + out
    if not _VALID_NAME.fullmatch(out):
        raise ValueError(f"metric tag {name!r} sanitizes to {out!r}, not a "
                         f"valid Prometheus metric name")
    return out


def sanitize_label_value(value) -> str:
    """Map an arbitrary (possibly user-supplied) value to a safe, bounded
    Prometheus label VALUE: characters outside ``[A-Za-z0-9_\\-./:]`` →
    ``_``, truncated to :data:`LABEL_VALUE_MAX_LEN`, never empty. Used by
    the per-tenant attribution path (telemetry/reqtrace.py) and the
    aggregate scrape's per-peer labels.

    Keep in sync with bin/check_metric_names.py ``sanitize_label_value``
    (the repo lint's drift-pinned mirror)."""
    out = _LABEL_VALUE_BAD.sub("_", str(value))[:LABEL_VALUE_MAX_LEN]
    return out or "unknown"


def _label_key(labels: dict[str, str] | None) -> tuple:
    return tuple(sorted(labels.items())) if labels else ()


def _render_labels(label_items: Iterable[tuple[str, str]],
                   extra: tuple[tuple[str, str], ...] = ()) -> str:
    items = tuple(label_items) + extra
    if not items:
        return ""
    parts = []
    for k, v in items:
        if not _VALID_LABEL.fullmatch(k):
            k = sanitize_metric_name(k).replace(":", "_")
        v = str(v).replace("\\", r"\\").replace('"', r'\"').replace("\n", r"\n")
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


class Counter:
    """Monotone counter."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-written value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v


class Histogram:
    """Fixed-bucket histogram (cumulative-on-render, additive-in-memory).

    ``counts[i]`` counts observations with ``bounds[i-1] < v <= bounds[i]``;
    the implicit last bucket is +Inf. Percentiles interpolate linearly
    inside the hit bucket (the standard Prometheus ``histogram_quantile``
    estimate), so accuracy is bounded by bucket width — size buckets to the
    question being asked.

    **Exemplars** (reqtrace): an observation may carry a trace ID; each
    bucket remembers its most recent exemplar ``(trace_id, value,
    unix_time)``, so a tail bucket links to the concrete request timeline
    that landed there (``/metrics?exemplars=1`` renders them OpenMetrics-
    style). Storage is lazy — a histogram that never sees an exemplar
    allocates nothing, and memory is bounded at one exemplar per bucket.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "exemplars")

    def __init__(self, buckets: Iterable[float] = LATENCY_BUCKETS_S):
        bounds = tuple(float(b) for b in buckets)
        if not bounds or any(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:])):
            raise ValueError("histogram buckets must be non-empty and "
                             "strictly increasing")
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0
        self.exemplars: dict[int, tuple] | None = None   # bucket -> exemplar

    def observe(self, v: float, n: int = 1,
                exemplar: str | None = None) -> None:
        """Record ``n`` observations of value ``v`` (n>1 is the amortized
        form: a decode window committing k tokens dt apart contributes k
        samples of dt/k). ``exemplar`` (a trace ID) tags the hit bucket's
        most recent exemplar."""
        i = bisect_left(self.bounds, v)
        self.counts[i] += n
        self.sum += v * n
        self.count += n
        if exemplar is not None:
            if self.exemplars is None:
                self.exemplars = {}
            self.exemplars[i] = (exemplar, v, _time.time())

    def percentile(self, q: float) -> float | None:
        """Estimate the q-th percentile (q in [0, 100]); None when empty."""
        if not self.count:
            return None
        target = (q / 100.0) * self.count
        acc = 0
        for i, c in enumerate(self.counts):
            acc += c
            if acc >= target and c:
                lo = self.bounds[i - 1] if i > 0 else 0.0
                hi = self.bounds[i] if i < len(self.bounds) else self.bounds[-1]
                frac = (target - (acc - c)) / c
                return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        return self.bounds[-1]

    @property
    def mean(self) -> float | None:
        return self.sum / self.count if self.count else None


class MetricsRegistry:
    """Named metric store. Accessors create-on-first-use (so emit sites
    stay one-liners) and return the live metric object; names sanitize at
    creation. ``labels`` distinguish series under one name."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> {"type", "help", "series": {label_key: metric}}
        self._metrics: dict[str, dict] = {}

    # -- accessors -------------------------------------------------------
    def _get(self, name: str, typ: str, factory, labels: dict | None,
             help: str | None):
        name = sanitize_metric_name(name)
        key = _label_key(labels)
        fam = self._metrics.get(name)
        if fam is not None:
            if fam["type"] != typ:
                raise ValueError(f"metric '{name}' registered as "
                                 f"{fam['type']}, requested as {typ}")
            series = fam["series"].get(key)
            if series is not None:
                return series
        with self._lock:
            fam = self._metrics.setdefault(
                name, {"type": typ, "help": help or "", "series": {}})
            if fam["type"] != typ:
                raise ValueError(f"metric '{name}' registered as "
                                 f"{fam['type']}, requested as {typ}")
            return fam["series"].setdefault(key, factory())

    def counter(self, name: str, labels: dict | None = None,
                help: str | None = None) -> Counter:
        return self._get(name, "counter", Counter, labels, help)

    def gauge(self, name: str, labels: dict | None = None,
              help: str | None = None) -> Gauge:
        return self._get(name, "gauge", Gauge, labels, help)

    def histogram(self, name: str, buckets: Iterable[float] | None = None,
                  labels: dict | None = None,
                  help: str | None = None) -> Histogram:
        factory = (lambda: Histogram(buckets)) if buckets is not None \
            else Histogram
        return self._get(name, "histogram", factory, labels, help)

    # -- snapshot / merge ------------------------------------------------
    def snapshot(self) -> dict:
        """Plain-data view: mergeable across processes, JSON-serializable
        (flight recorder, bench artifacts)."""
        out: dict = {}
        with self._lock:
            items = [(n, f["type"], f["help"], list(f["series"].items()))
                     for n, f in self._metrics.items()]
        for name, typ, help_, series in items:
            fam: dict = {"type": typ, "help": help_, "series": []}
            for key, m in series:
                s: dict = {"labels": dict(key)}
                if typ == "histogram":
                    s.update(bounds=list(m.bounds), counts=list(m.counts),
                             sum=m.sum, count=m.count)
                    if m.exemplars:
                        # str keys: the snapshot is JSON round-trippable
                        # (flight dumps, peer files); merge() ignores
                        # this. list(items()) first: observe() inserts
                        # lock-free from the serving thread, and one C
                        # call is atomic under the GIL where iterating
                        # the live dict is not — a scrape must never 500
                        s["exemplars"] = {str(i): list(e) for i, e
                                          in list(m.exemplars.items())}
                else:
                    s["value"] = m.value
                fam["series"].append(s)
            out[name] = fam
        return out

    def merge(self, snap: dict) -> None:
        """Fold a :meth:`snapshot` from another registry/process in:
        counters and histogram buckets add, gauges last-write-wins."""
        for name, fam in snap.items():
            for s in fam["series"]:
                labels = s.get("labels") or None
                if fam["type"] == "counter":
                    self.counter(name, labels, fam.get("help")).inc(s["value"])
                elif fam["type"] == "gauge":
                    self.gauge(name, labels, fam.get("help")).set(s["value"])
                else:
                    h = self.histogram(name, buckets=s["bounds"],
                                       labels=labels, help=fam.get("help"))
                    if tuple(s["bounds"]) != h.bounds:
                        raise ValueError(
                            f"histogram '{name}' bucket mismatch on merge")
                    for i, c in enumerate(s["counts"]):
                        h.counts[i] += c
                    h.sum += s["sum"]
                    h.count += s["count"]

    def reset(self, prefix: str | tuple[str, ...] | None = None,
              keep: tuple[str, ...] = ()) -> None:
        """Drop metric families — all of them by default (bench zeroes the
        registry per measured run, like it zeroes engine stats), or only
        those whose name starts with ``prefix``. Families starting with a
        ``keep`` prefix always survive: two components sharing one
        process-wide registry (bench-driven engine + co-resident router)
        each zero THEIR families per measured run without clobbering the
        other's — see ``Telemetry.reset_metrics``."""
        if isinstance(prefix, str):
            prefix = (prefix,)
        with self._lock:
            if prefix is None and not keep:
                self._metrics.clear()
                return
            for name in list(self._metrics):
                if keep and name.startswith(keep):
                    continue
                if prefix is None or name.startswith(prefix):
                    del self._metrics[name]

    # -- exposition ------------------------------------------------------
    def render_prometheus(self, exemplars: bool = False) -> str:
        """Prometheus text exposition format 0.0.4. With ``exemplars``,
        bucket lines additionally carry their most recent exemplar in
        OpenMetrics syntax (``... # {trace_id="..."} value timestamp``)
        and the body ends with ``# EOF`` — serve this variant under the
        OpenMetrics content type only (plain 0.0.4 parsers reject the
        suffix)."""
        lines: list[str] = []
        for name, fam in sorted(self.snapshot().items()):
            sample_name = name
            if exemplars and fam["type"] == "counter":
                # OpenMetrics reserves the ``_total`` suffix for counter
                # SAMPLES: the family is declared under the base name and
                # strict OM parsers reject a TYPE line that carries the
                # suffix ("clashing name") — which would drop the whole
                # scrape for exactly the consumers this mode exists for
                base = name[:-6] if name.endswith("_total") else name
                sample_name = base + "_total"
                if fam["help"]:
                    lines.append(f"# HELP {base} {fam['help']}")
                lines.append(f"# TYPE {base} {fam['type']}")
            else:
                if fam["help"]:
                    lines.append(f"# HELP {name} {fam['help']}")
                lines.append(f"# TYPE {name} {fam['type']}")
            for s in fam["series"]:
                items = tuple(sorted(s["labels"].items()))
                if fam["type"] == "histogram":
                    ex = s.get("exemplars") if exemplars else None
                    acc = 0
                    for i, (bound, c) in enumerate(
                            zip(s["bounds"] + [float("inf")], s["counts"])):
                        acc += c
                        le = "+Inf" if bound == float("inf") else repr(bound)
                        line = (f"{name}_bucket"
                                f"{_render_labels(items, (('le', le),))} "
                                f"{acc}")
                        e = ex.get(str(i)) if ex else None
                        if e is not None:
                            tid, v, ts = e
                            line += (f' # {{trace_id="{tid}"}} {v} '
                                     f"{round(ts, 3)}")
                        lines.append(line)
                    lines.append(
                        f"{name}_sum{_render_labels(items)} {s['sum']}")
                    lines.append(
                        f"{name}_count{_render_labels(items)} {s['count']}")
                else:
                    lines.append(
                        f"{sample_name}{_render_labels(items)} "
                        f"{s['value']}")
        if exemplars:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"
