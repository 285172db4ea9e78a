"""Declarative alert rules over the fleet time-series store.

Evaluated on the watchtower sample tick (``Router.poll``), each
:class:`AlertRule` turns a store query — instantaneous ``latest``,
trailing-window ``rate``, or a ``p..`` percentile — into a condition with
the full Prometheus-style lifecycle:

    inactive → pending (condition true, holding for ``for_s``)
             → firing  (held long enough; notification emitted)
             → resolved (condition false again; kept for display)

Deduplication is by **fingerprint** (``rule`` or ``rule/source`` for
per-replica rules): a condition that stays true keeps one alert object
alive rather than spawning a new one per tick.  Notifications — the
router's trigger to cut a black-box dump or feed the elastic controller —
are additionally rate-limited per rule (``rate_limit_s``), so a flapping
condition cannot storm the dump path.

Two detection kinds:

- ``threshold``: compare the query value against ``value`` with ``op``.
- ``zscore``: robust z-score of the query value against a rolling
  median/MAD baseline of its *own* history (the fleettrace StragglerScorer
  statistics: ``z = (v - median) / (1.4826 * MAD + eps)``), firing when
  ``|z|`` crosses ``z`` in the direction of ``op``.  This needs no
  hand-guessed absolute threshold — the metric's recent past is the
  baseline.

Metrics: ``serving_alerts_total{rule,severity}`` counts fire transitions,
``serving_alerts_firing{rule,severity}`` gauges currently-firing alerts.
The ``/alerts`` HTTP endpoint serves :meth:`AlertManager.to_dict`.
"""
from __future__ import annotations

import re
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from .fleettrace import _median
from .metrics import sanitize_label_value

__all__ = ["AlertRule", "Alert", "AlertManager", "default_fleet_rules", "SEVERITIES"]

#: allowed severities, mildest first (check_metric_names.py pins rule
#: literals against this tuple — keep in sync with the lint)
SEVERITIES = ("info", "warning", "critical")

#: minimum baseline samples before a zscore rule may score (below this the
#: MAD is meaningless and everything looks anomalous)
ZSCORE_MIN_SAMPLES = 8

_OPS = {
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
}

_PCT_RE = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")


@dataclass
class AlertRule:
    """One declarative rule. ``query``: ``latest`` | ``rate`` | ``p<q>``
    (e.g. ``p95``). ``per_source='replica'`` evaluates the rule once per
    store source matching ``replica<N>`` (fingerprint gains ``/replica<N>``).
    ``guard`` suppresses the rule unless a second metric passes its own
    threshold — e.g. "replica emits no tokens" only alerts while the
    router still believes that replica holds live sequences."""

    name: str
    metric: str
    op: str = ">"
    value: float = 0.0
    query: str = "latest"
    window_s: float = 10.0
    for_s: float = 0.0
    severity: str = "warning"
    kind: str = "threshold"          # "threshold" | "zscore"
    z: float = 3.5                   # zscore trip point (kind="zscore")
    baseline_s: float = 120.0        # rolling baseline horizon (kind="zscore")
    abs_value: bool = False          # score |v| (clock offsets swing both ways)
    labels: Optional[Dict[str, str]] = None
    per_source: Optional[str] = None
    src: Optional[str] = None        # pin to one source (None = fleet-wide)
    guard: Optional[Dict[str, Any]] = None
    rate_limit_s: float = 60.0
    hint_role: Optional[str] = None  # feed ElasticController while firing
    hint_direction: str = "up"
    help: str = ""

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            raise ValueError("bad op %r" % (self.op,))
        if self.severity not in SEVERITIES:
            raise ValueError("bad severity %r" % (self.severity,))
        if self.kind not in ("threshold", "zscore"):
            raise ValueError("bad kind %r" % (self.kind,))
        if self.query not in ("latest", "rate") and not _PCT_RE.match(self.query):
            raise ValueError("bad query %r" % (self.query,))
        if sanitize_label_value(self.name) != self.name:
            raise ValueError("rule name %r is not a clean label value" % (self.name,))


@dataclass
class Alert:
    """One live (or recently resolved) alert instance."""

    rule: str
    severity: str
    fingerprint: str
    source: Optional[str]
    state: str                        # "pending" | "firing" | "resolved"
    since_t: float                    # condition first true (wall)
    fired_t: Optional[float] = None   # pending → firing (wall)
    fired_mono: Optional[float] = None  # same edge on the monotonic clock
    resolved_t: Optional[float] = None
    value: Optional[float] = None     # most recent query value
    zscore: Optional[float] = None
    notified: bool = False            # a notification actually went out
    help: str = ""

    def to_dict(self) -> Dict[str, Any]:
        return {
            "rule": self.rule,
            "severity": self.severity,
            "fingerprint": self.fingerprint,
            "source": self.source,
            "state": self.state,
            "since_t": self.since_t,
            "fired_t": self.fired_t,
            "resolved_t": self.resolved_t,
            "value": self.value,
            "zscore": self.zscore,
            "notified": self.notified,
            "help": self.help,
        }


class AlertManager:
    """Rule evaluation + alert lifecycle + metric emission.

    ``evaluate(store, now)`` runs every rule against the store and returns
    the list of alerts that *newly fired this tick and passed their rule's
    notification rate limit* — the router treats those as events (black-box
    dump for critical, log line otherwise).  Current state is always
    available via :meth:`firing` / :meth:`to_dict`.
    """

    def __init__(self, rules: Optional[List[AlertRule]] = None, registry=None,
                 resolved_keep_s: float = 600.0) -> None:
        self.rules: List[AlertRule] = list(rules) if rules is not None else default_fleet_rules()
        self.registry = registry
        self.resolved_keep_s = float(resolved_keep_s)
        self._active: Dict[str, Alert] = {}
        self._resolved: deque = deque(maxlen=64)
        self._last_notify: Dict[str, float] = {}   # rule name -> wall t
        self._baseline: Dict[str, deque] = {}      # fingerprint -> deque[(t, v)]
        self.evals = 0
        self.notifications = 0

    # ------------------------------------------------------------ evaluation

    def evaluate(self, store, now: Optional[float] = None) -> List[Alert]:
        if now is None:
            now = time.time()
        mono = time.monotonic()
        fired: List[Alert] = []
        self.evals += 1
        live: set = set()
        for rule in self.rules:
            for source in self._sources(rule, store):
                fp = rule.name if source is None else "%s/%s" % (rule.name, source)
                live.add(fp)
                value = self._query(rule, store, now, source)
                cond, zs = self._condition(rule, fp, value, now, store)
                alert = self._active.get(fp)
                if cond:
                    if alert is None or alert.state == "resolved":
                        alert = Alert(rule=rule.name, severity=rule.severity,
                                      fingerprint=fp, source=source, state="pending",
                                      since_t=now, value=value, zscore=zs,
                                      help=rule.help)
                        self._active[fp] = alert
                    alert.value, alert.zscore = value, zs
                    if alert.state == "pending" and now - alert.since_t >= rule.for_s:
                        alert.state = "firing"
                        alert.fired_t = now
                        alert.fired_mono = mono
                        self._count_fire(rule)
                        last = self._last_notify.get(rule.name)
                        if last is None or now - last >= rule.rate_limit_s:
                            self._last_notify[rule.name] = now
                            alert.notified = True
                            self.notifications += 1
                            fired.append(alert)
                elif alert is not None and alert.state in ("pending", "firing"):
                    alert.state = "resolved"
                    alert.resolved_t = now
                    alert.value, alert.zscore = value, zs
                    self._resolved.append(alert)
                    del self._active[fp]
        # a per-source alert whose source vanished (replica reaped) resolves
        for fp in [f for f in self._active if f not in live]:
            alert = self._active.pop(fp)
            alert.state = "resolved"
            alert.resolved_t = now
            self._resolved.append(alert)
        self._gc_resolved(now)
        self._emit_firing_gauge()
        return fired

    def _sources(self, rule: AlertRule, store) -> List[Optional[str]]:
        if rule.per_source:
            pat = re.compile(re.escape(rule.per_source) + r"\d+$")
            return [s for s in store.sources() if pat.match(s)] or []
        return [rule.src]

    def _query(self, rule: AlertRule, store, now: float,
               source: Optional[str]) -> Optional[float]:
        src = source if source is not None else rule.src
        if rule.query == "latest":
            agg = "absmax" if rule.abs_value else ("min" if rule.op in ("<", "<=") else "max")
            v = store.latest(rule.metric, src=src, labels=rule.labels, agg=agg)
        elif rule.query == "rate":
            v = store.rate(rule.metric, rule.window_s, now=now, src=src, labels=rule.labels)
        else:
            q = float(_PCT_RE.match(rule.query).group(1)) / 100.0
            v = store.percentile(rule.metric, q, rule.window_s, now=now,
                                 src=src, labels=rule.labels)
        if v is not None and rule.abs_value:
            v = abs(v)
        return v

    def _condition(self, rule: AlertRule, fp: str, value: Optional[float],
                   now: float, store) -> Tuple[bool, Optional[float]]:
        if value is None:
            return False, None
        zs = None
        if rule.kind == "zscore":
            hist = self._baseline.setdefault(fp, deque(maxlen=1024))
            while hist and now - hist[0][0] > rule.baseline_s:
                hist.popleft()
            baseline = [v for (_t, v) in hist]
            hist.append((now, value))
            if len(baseline) < ZSCORE_MIN_SAMPLES:
                return False, None
            med = _median(baseline)
            mad = _median([abs(v - med) for v in baseline])
            zs = (value - med) / (1.4826 * mad + 1e-9)
            cond = _OPS[rule.op](zs, rule.z) if rule.op in (">", ">=") \
                else _OPS[rule.op](zs, -rule.z)
        else:
            cond = _OPS[rule.op](value, rule.value)
        if cond and rule.guard is not None:
            cond = self._guard_passes(rule, fp, store)
        return cond, zs

    def _guard_passes(self, rule: AlertRule, fp: str, store) -> bool:
        g = rule.guard
        labels = dict(g.get("labels") or {})
        lf = g.get("labels_from_source")
        if lf:
            m = re.search(r"(\d+)$", fp)
            if not m:
                return False
            labels[lf] = m.group(1)
        gv = store.latest(g["metric"], src=g.get("src"),
                          labels=labels or None, agg="max")
        if gv is None:
            return False
        return _OPS[g.get("op", ">")](gv, float(g.get("value", 0.0)))

    # ----------------------------------------------------------- bookkeeping

    def _count_fire(self, rule: AlertRule) -> None:
        if self.registry is None:
            return
        self.registry.counter(
            "serving_alerts_total",
            labels={"rule": sanitize_label_value(rule.name),
                    "severity": sanitize_label_value(rule.severity)},
            help="alert fire transitions (pending->firing) by rule and "
                 "severity",
        ).inc()

    def _emit_firing_gauge(self) -> None:
        if self.registry is None:
            return
        counts: Dict[Tuple[str, str], int] = {}
        for rule in self.rules:
            counts[(rule.name, rule.severity)] = 0
        for a in self._active.values():
            if a.state == "firing":
                key = (a.rule, a.severity)
                counts[key] = counts.get(key, 0) + 1
        for (name, sev), n in counts.items():
            self.registry.gauge(
                "serving_alerts_firing",
                labels={"rule": sanitize_label_value(name),
                        "severity": sanitize_label_value(sev)},
                help="currently-firing alerts by rule and severity",
            ).set(float(n))

    def _gc_resolved(self, now: float) -> None:
        while self._resolved and (self._resolved[0].resolved_t is None or
                                  now - self._resolved[0].resolved_t > self.resolved_keep_s):
            self._resolved.popleft()

    # --------------------------------------------------------------- queries

    def firing(self, severity: Optional[str] = None) -> List[Alert]:
        out = [a for a in self._active.values() if a.state == "firing"
               and (severity is None or a.severity == severity)]
        out.sort(key=lambda a: (SEVERITIES.index(a.severity), a.fired_t or 0.0))
        out.reverse()
        return out

    def active(self) -> List[Alert]:
        sev = {s: i for i, s in enumerate(SEVERITIES)}
        return sorted(self._active.values(),
                      key=lambda a: (-sev.get(a.severity, 0), a.since_t))

    def elastic_hints(self) -> List[Tuple[str, str, float]]:
        """(role, direction, fired_mono) for every firing alert whose rule
        asks to nudge the elastic controller. The router re-seeds the
        ScaleAdvisor's ``hint_since`` from ``fired_mono`` each tick, so a
        long-firing alert counts as a *sustained* hint."""
        rules = {r.name: r for r in self.rules}
        out = []
        for a in self._active.values():
            if a.state != "firing":
                continue
            r = rules.get(a.rule)
            if r is not None and r.hint_role:
                out.append((r.hint_role, r.hint_direction, a.fired_mono or 0.0))
        return out

    def to_dict(self) -> Dict[str, Any]:
        sev = {s: i for i, s in enumerate(SEVERITIES)}
        alerts = sorted(self._active.values(),
                        key=lambda a: (-sev.get(a.severity, 0),
                                       0 if a.state == "firing" else 1, a.since_t))
        return {
            "alerts": [a.to_dict() for a in alerts],
            "resolved": [a.to_dict() for a in list(self._resolved)[-16:]],
            "firing": sum(1 for a in self._active.values() if a.state == "firing"),
            "pending": sum(1 for a in self._active.values() if a.state == "pending"),
            "rules": [{"name": r.name, "metric": r.metric, "query": r.query,
                       "op": r.op, "value": r.value, "kind": r.kind,
                       "severity": r.severity, "for_s": r.for_s,
                       "window_s": r.window_s, "help": r.help}
                      for r in self.rules],
            "evals": self.evals,
            "notifications": self.notifications,
        }


def default_fleet_rules(sample_interval_s: float = 1.0,
                        slo_ttft_s: Optional[float] = None) -> List[AlertRule]:
    """The in-code rule pack. Windows scale with the sample cadence so the
    pack behaves the same at a 0.2 s test tick and a 15 s production tick."""
    dt = max(0.05, float(sample_interval_s))
    rules = [
        AlertRule(
            name="replica_stalled", severity="critical",
            metric="serving_replica_tokens_total", query="rate",
            op="<=", value=0.0, window_s=4 * dt, for_s=dt,
            per_source="replica",
            guard={"metric": "serving_router_replica_live", "src": "router",
                   "op": ">", "value": 0.0, "labels_from_source": "replica"},
            rate_limit_s=30 * dt,
            help="A replica the router believes holds live sequences has "
                 "streamed zero tokens for a full window: wedged engine or "
                 "stalled stream. Critical -> black-box dump.",
        ),
        AlertRule(
            name="breaker_open", severity="critical",
            metric="serving_router_breaker_opens_total", query="rate",
            op=">", value=0.0, window_s=4 * dt, for_s=0.0,
            src="router", rate_limit_s=60 * dt,
            help="The dispatch circuit breaker opened inside the window - "
                 "the fleet is shedding load.",
        ),
        AlertRule(
            name="tier_fallback_spike", severity="warning",
            metric="serving_kv_tier_fallbacks_total", query="rate",
            op=">", kind="zscore", z=3.0, window_s=4 * dt,
            baseline_s=120 * dt, rate_limit_s=60 * dt,
            help="KV tier fallback rate is anomalous vs its own rolling "
                 "median/MAD baseline - cold tier thrash or a dying device.",
        ),
        AlertRule(
            name="journal_bytes_growth", severity="warning",
            metric="serving_router_journal_bytes_total", query="rate",
            op=">", value=1 << 20, window_s=8 * dt, for_s=4 * dt,
            src="router", rate_limit_s=120 * dt,
            help="Router journal is growing past 1 MiB/s sustained - "
                 "compaction is losing to write volume.",
        ),
        AlertRule(
            name="clock_offset_blowup", severity="warning",
            metric="serving_router_replica_clock_offset_s", query="latest",
            op=">", value=0.25, abs_value=True, for_s=2 * dt,
            src="router", rate_limit_s=120 * dt,
            help="A replica's estimated clock offset exceeds 250 ms - "
                 "cross-replica timeline causality is no longer trustworthy.",
        ),
    ]
    if slo_ttft_s is not None and slo_ttft_s > 0:
        rules.insert(1, AlertRule(
            name="ttft_slo_trend", severity="warning",
            metric="serving_router_ttft_s", query="p95",
            op=">", value=float(slo_ttft_s), window_s=20 * dt, for_s=2 * dt,
            src="router", rate_limit_s=60 * dt,
            hint_role="prefill", hint_direction="up",
            help="p95 TTFT over the trailing window breaches the SLO - "
                 "sustained trend, not a single slow request. Feeds the "
                 "elastic controller as a scale-up hint for prefill.",
        ))
    return rules
