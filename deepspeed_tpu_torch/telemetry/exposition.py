"""Opt-in stdlib HTTP endpoint: ``/metrics`` (Prometheus text format) and
``/healthz`` (liveness JSON) for scraping live jobs.

Stdlib-only by constraint (the image has no prometheus_client and the repo
may not grow dependencies) and by taste: the exposition format is lines of
text, and ``ThreadingHTTPServer`` on a daemon thread is enough for a
scraper hitting the job every 15s. The server binds localhost by default —
exposing beyond the host is a deployment decision (port-forward / sidecar),
not a framework default.

Fleet aggregation (the host-0 scrape): ``/metrics?aggregate=1`` serves a
``MetricsRegistry.merge()`` of this process's registry with every peer
snapshot file matching ``peer_glob`` (JSON files written by
``Telemetry.write_snapshot`` on the other hosts — shared filesystem or
sidecar-rsync'd). Counters and histogram buckets add, gauges last-write-
win, so a fleet-wide prefix-hit-rate or TTFT histogram is one scrape of
host 0 instead of N scrapes plus recording-rule math. Unreadable or
mid-write peer files are skipped with a warning — a scrape never 500s on
a torn snapshot.
"""
from __future__ import annotations

import glob as _glob
import json
import os as _os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from ..utils.logging import logger
from .metrics import LABEL_VALUE_MAX_LEN, sanitize_label_value

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
#: content type for ``/metrics?exemplars=1`` — exemplar suffixes are
#: OpenMetrics syntax, which plain 0.0.4 parsers reject
OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


class TelemetryHTTPServer:
    """Serve a registry's metrics + a health probe.

    ``health_fn`` (optional) returns a dict merged into the ``/healthz``
    body — wire job identity / step counters in there. ``port=0`` binds an
    ephemeral port (tests); read it back from ``self.port``.
    ``peer_glob`` (optional) enables ``/metrics?aggregate=1``: peer
    snapshot files matching the glob merge into the response.
    ``peer_staleness_s`` bounds how old (by mtime) a peer snapshot may be
    before the aggregate SKIPS it instead of silently merging dead data —
    a host that stopped writing snapshots an hour ago would otherwise
    freeze its last numbers into every fleet scrape. Skips are counted
    (``telemetry_stale_peers_skipped``) and every peer's snapshot age is
    exposed (``telemetry_peer_snapshot_age_s{peer=...}``) so the scrape
    itself says which host went quiet. 0/None disables the cutoff.
    ``trace_fn`` (optional) returns a Chrome trace-event dict served at
    ``/trace`` — the live process timeline (host spans + request
    lifecycles) fetched over HTTP instead of a file, so a fleet
    postmortem can pull a process's view without filesystem access.
    ``alerts_fn`` (optional) returns the watchtower alert state dict
    served at ``/alerts``; ``series_fn`` (optional) takes the parsed
    query dict and returns history points served at ``/series`` — both
    wired by the router when the fleet watchtower is on (``bin/ds_top``
    is the consumer).
    """

    def __init__(self, registry, health_fn=None, host: str = "127.0.0.1",
                 peer_glob: str | None = None,
                 peer_staleness_s: float | None = 300.0,
                 trace_fn=None, alerts_fn=None, series_fn=None):
        self.registry = registry
        self.health_fn = health_fn
        self.trace_fn = trace_fn
        self.alerts_fn = alerts_fn
        self.series_fn = series_fn
        self.host = host
        self.peer_glob = peer_glob
        self.peer_staleness_s = peer_staleness_s
        self.port: int | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._thread: threading.Thread | None = None
        self._t0 = time.time()

    def render_aggregate(self) -> str:
        """This registry merged with every readable peer snapshot file
        (counters/buckets add, gauges LWW — MetricsRegistry.merge), plus
        a ``telemetry_aggregated_peers`` gauge recording how many peers
        actually folded in (a scrape that silently covered 3 of 8 hosts
        would read as fleet-wide truth otherwise)."""
        from .metrics import MetricsRegistry

        agg = MetricsRegistry()
        agg.merge(self.registry.snapshot())
        n_peers = 0
        n_stale = 0
        ages: list[tuple[str, float]] = []
        now = time.time()
        cutoff = self.peer_staleness_s
        for path in sorted(_glob.glob(self.peer_glob or "")):
            try:
                age = now - _os.path.getmtime(path)
            except OSError as e:            # vanished between glob and stat
                logger.warning(f"telemetry aggregate: cannot stat peer "
                               f"snapshot {path}: {e!r}")
                continue
            # label = the path's TAIL (sanitize keeps '/'): per-host
            # snapshot trees like peers/<host>/snap.json share a
            # basename, and colliding labels would overwrite each
            # other's age — hiding exactly the stale host this gauge
            # exists to expose
            ages.append((sanitize_label_value(path[-LABEL_VALUE_MAX_LEN:]),
                         age))
            if cutoff and age > cutoff:
                # a peer that stopped writing snapshots must not freeze
                # its last numbers into the fleet view — skip, count, log
                n_stale += 1
                logger.warning(f"telemetry aggregate: skipping STALE peer "
                               f"snapshot {path} (age {age:.0f}s > "
                               f"{cutoff:.0f}s)")
                continue
            # each peer folds in ALL-OR-NOTHING: merge into a trial copy
            # and swap on success — a snapshot that fails mid-merge (e.g.
            # histogram bucket mismatch from a peer on an older build)
            # must not leave its earlier families half-counted in a
            # response that then reports the peer as skipped
            try:
                with open(path, encoding="utf-8") as f:
                    snap = json.load(f)
                trial = MetricsRegistry()
                trial.merge(agg.snapshot())
                trial.merge(snap)
            except (OSError, ValueError, KeyError, TypeError) as e:
                # torn mid-write / vanished / malformed / incompatible
                # peer file: skip it loudly, never 500 the scrape
                logger.warning(f"telemetry aggregate: skipping peer "
                               f"snapshot {path}: {e!r}")
                continue
            agg = trial
            n_peers += 1
        for peer, age in ages:
            agg.gauge("telemetry_peer_snapshot_age_s",
                      labels={"peer": peer},
                      help="seconds since each peer snapshot file was "
                           "written (stale peers are skipped, not merged)"
                      ).set(round(age, 3))
        agg.gauge("telemetry_aggregated_peers",
                  help="peer snapshot files merged into this aggregate "
                       "scrape (excludes this process)").set(n_peers)
        agg.gauge("telemetry_stale_peers_skipped",
                  help="peer snapshot files skipped by this scrape because "
                       "their age exceeded the staleness cutoff").set(
            n_stale)
        return agg.render_prometheus()

    def start(self, port: int = 0) -> int:
        if self._httpd is not None:
            return self.port
        server = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):
                try:
                    parts = urlsplit(self.path)
                    if parts.path == "/metrics":
                        q = parse_qs(parts.query)
                        if q.get("aggregate", ["0"])[0] not in ("", "0"):
                            body = server.render_aggregate().encode()
                            ctype = PROMETHEUS_CONTENT_TYPE
                        elif q.get("exemplars", ["0"])[0] not in ("", "0"):
                            # exemplar-bearing buckets use OpenMetrics
                            # syntax -> OpenMetrics content type
                            body = server.registry.render_prometheus(
                                exemplars=True).encode()
                            ctype = OPENMETRICS_CONTENT_TYPE
                        else:
                            body = server.registry.render_prometheus() \
                                .encode()
                            ctype = PROMETHEUS_CONTENT_TYPE
                    elif parts.path == "/trace" \
                            and server.trace_fn is not None:
                        body = json.dumps(server.trace_fn()).encode()
                        ctype = "application/json"
                    elif parts.path == "/alerts" \
                            and server.alerts_fn is not None:
                        body = json.dumps(server.alerts_fn()).encode()
                        ctype = "application/json"
                    elif parts.path == "/series" \
                            and server.series_fn is not None:
                        q = {k: v[0] for k, v in
                             parse_qs(parts.query).items()}
                        body = json.dumps(server.series_fn(q)).encode()
                        ctype = "application/json"
                    elif parts.path == "/healthz":
                        health = {"status": "ok",
                                  "uptime_s": round(time.time() - server._t0, 3)}
                        if server.health_fn is not None:
                            health.update(server.health_fn())
                        body = (json.dumps(health) + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:   # a scrape must never kill the job
                    logger.warning(f"telemetry endpoint error: {e!r}")
                    self.send_error(500)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):   # scraper chatter off stderr
                logger.debug(f"telemetry http: {fmt % args}")

        self._httpd = ThreadingHTTPServer((self.host, int(port)), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="telemetry-http",
            daemon=True)
        self._thread.start()
        logger.info(f"telemetry: serving /metrics + /healthz on "
                    f"http://{self.host}:{self.port}")
        return self.port

    def stop(self) -> None:
        if self._httpd is None:
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        self._httpd = None
        self._thread = None
