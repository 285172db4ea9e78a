"""``ds_top`` — the live fleet ops console
(``python -m deepspeed_tpu_torch.telemetry.console [--url URL] [--once]``).

One screen answering "is the fleet healthy and is it getting worse?",
rendered from three HTTP fetches against the router's exposition
endpoint (stdlib only, no curses — plain ANSI redraw):

- ``/metrics?aggregate=1``: fleet-wide counters/gauges/histograms
  (lifetime TTFT/TBT percentiles come from the merged buckets),
- ``/alerts``: watchtower alert state + fleet health rollup + store
  stats (also the source of the per-replica table),
- ``/series``: time-series points from the watchtower store — goodput
  and tail-latency **trends** as sparklines, the part a snapshot scrape
  cannot answer.

Degrades gracefully: a router without the watchtower still renders the
fleet table and lifetime percentiles (alerts/trends sections say so);
an unreachable endpoint prints the error and, in live mode, retries on
the next refresh. Exit code 0 in ``--once`` mode when the fetch worked,
1 when the endpoint was unreachable.
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple

__all__ = ["main", "parse_prometheus", "sparkline", "render"]

#: one fetch must never wedge the console
FETCH_TIMEOUT_S = 5.0

_SPARK_CHARS = "▁▂▃▄▅▆▇█"

_LINE_RE = re.compile(
    r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)')
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str], float]]]:
    """Prometheus text format -> {family: [(labels, value), ...]}.

    ``_bucket``/``_sum``/``_count`` suffixes stay in the family name —
    the console re-assembles histograms itself. Unparseable lines and
    non-float values (NaN stays) are skipped; a console must render
    whatever subset it got.
    """
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        name, rawlabels, rawval = m.groups()
        try:
            val = float(rawval)
        except ValueError:
            continue
        labels = {k: v for k, v in _LABEL_RE.findall(rawlabels or "")}
        out.setdefault(name, []).append((labels, val))
    return out


def _fetch(url: str):
    with urllib.request.urlopen(url, timeout=FETCH_TIMEOUT_S) as resp:
        return resp.read().decode("utf-8", "replace")


def _fetch_json(url: str):
    return json.loads(_fetch(url))


def _hist_percentile(samples: List[Tuple[Dict[str, str], float]],
                     q: float) -> Optional[float]:
    """Percentile from `<fam>_bucket` samples (cumulative `le` buckets)."""
    buckets: Dict[float, float] = {}
    for labels, v in samples:
        le = labels.get("le")
        if le is None:
            continue
        try:
            b = float("inf") if le in ("+Inf", "inf") else float(le)
        except ValueError:
            continue
        buckets[b] = buckets.get(b, 0.0) + v
    if not buckets:
        return None
    bounds = sorted(buckets)
    total = buckets[bounds[-1]]
    if total <= 0:
        return None
    target = q * total
    prev_bound, prev_cum = 0.0, 0.0
    for b in bounds:
        cum = buckets[b]
        if cum >= target and cum > prev_cum:
            if b == float("inf"):
                return prev_bound
            frac = (target - prev_cum) / (cum - prev_cum)
            return prev_bound + (b - prev_bound) * frac
        prev_bound, prev_cum = b, cum
    return prev_bound if prev_bound else None


def sparkline(values: List[float], width: int = 24) -> str:
    """Block-character trend, newest right. Empty input -> dashes."""
    if not values:
        return "-" * min(width, 8)
    vals = values[-width:]
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(
        _SPARK_CHARS[int((v - lo) / span * (len(_SPARK_CHARS) - 1))]
        for v in vals)


def _counter_rate(points: List[List[float]]) -> Optional[float]:
    """Per-second rate from the cumulative range() points of a counter."""
    if len(points) < 2:
        return None
    (t0, v0), (t1, v1) = points[0], points[-1]
    if t1 <= t0:
        return None
    return max(0.0, (v1 - v0) / (t1 - t0))


def _rate_series(points: List[List[float]]) -> List[float]:
    out = []
    for (t0, v0), (t1, v1) in zip(points, points[1:]):
        if t1 > t0:
            out.append(max(0.0, (v1 - v0) / (t1 - t0)))
    return out


def _fmt(v: Optional[float], unit: str = "", prec: int = 3) -> str:
    if v is None:
        return "-"
    return f"{v:.{prec}f}{unit}"


def _age(now: float, t: Optional[float]) -> str:
    if not t:
        return "-"
    return f"{max(0.0, now - t):.0f}s"


def render(metrics, alerts: dict, series: Dict[str, dict], url: str,
           now: Optional[float] = None) -> str:
    """Assemble the full console frame as one string (pure: testable)."""
    if now is None:
        now = time.time()
    lines: List[str] = []
    lines.append(f"ds_top — fleet watchtower @ {url}    "
                 f"{time.strftime('%Y-%m-%d %H:%M:%S', time.localtime(now))}")
    fleet = (alerts or {}).get("fleet") or {}
    store = (alerts or {}).get("store") or {}

    # -- per-replica table ----------------------------------------------
    reps = fleet.get("replicas") or {}
    lines.append("")
    lines.append(" slot  state       role      ver  live  tier  offset_s  degraded")
    for slot in sorted(reps, key=lambda s: int(s) if s.isdigit() else 0):
        e = reps[slot]
        off = e.get("clock_offset_s")
        wv = e.get("weight_version")
        ver = wv.get("id", "?") if isinstance(wv, dict) else wv
        lines.append(
            f" {slot:<5} {str(e.get('state', '?')):<11} "
            f"{str(e.get('role', '?')):<9} "
            f"v{str(ver):<4}"
            f"{str(e.get('live', '-') if e.get('live') is not None else '-'):<6}"
            f"{str(e.get('tier_entries', 0)):<6}"
            f"{_fmt(off, prec=3) if off is not None else '-':<10}"
            f"{'YES' if e.get('degraded') else '-'}")
    if not reps:
        lines.append(" (no fleet health — is this a router endpoint?)")

    # -- fleet rollup ----------------------------------------------------
    ttft = (metrics or {}).get("serving_router_ttft_s_bucket", [])
    tbt = (metrics or {}).get("serving_router_tbt_s_bucket", [])
    tok_pts = (series.get("tokens") or {}).get("points", [])
    goodput = _counter_rate(tok_pts)
    lines.append("")
    lines.append(
        f" fleet: goodput {_fmt(goodput, ' tok/s', 1)}"
        f"   ttft p50 {_fmt(_hist_percentile(ttft, 0.50), 's')}"
        f" p95 {_fmt(_hist_percentile(ttft, 0.95), 's')}"
        f"   tbt p95 {_fmt(_hist_percentile(tbt, 0.95), 's')}"
        f"   dumps {fleet.get('blackbox_dumps', 0)}")

    # -- trends (the store's reason to exist) ---------------------------
    ttft_pts = (series.get("ttft_p95") or {}).get("points", [])
    lines.append(
        f" trend: tok/s [{sparkline(_rate_series(tok_pts))}]"
        f"  ttft_p95 [{sparkline([v for _t, v in ttft_pts])}]")
    if store:
        lines.append(
            f" store: {store.get('records', 0)} recs, "
            f"{store.get('series', 0)} series, "
            f"{store.get('segments', 0)} segs, "
            f"{(store.get('disk_bytes', 0) or 0) // 1024} KiB on disk"
            + (f", {store.get('bad_records')} bad"
               if store.get("bad_records") else ""))

    # -- alerts, severity-ranked ----------------------------------------
    sev_rank = {"critical": 0, "warning": 1, "info": 2}
    active = sorted((alerts or {}).get("alerts") or [],
                    key=lambda a: (sev_rank.get(a.get("severity"), 9),
                                   0 if a.get("state") == "firing" else 1))
    n_firing = (alerts or {}).get("firing", 0)
    lines.append("")
    if not alerts:
        lines.append(" alerts: (watchtower not attached on this endpoint)")
    elif not active:
        lines.append(f" alerts: none active "
                     f"({len((alerts or {}).get('rules') or [])} rules loaded)")
    else:
        lines.append(f" alerts ({n_firing} firing):")
        tag = {"critical": "CRIT", "warning": "WARN", "info": "INFO"}
        for a in active[:12]:
            state = a.get("state", "?")
            when = a.get("fired_t") if state == "firing" else a.get("since_t")
            lines.append(
                f"  {tag.get(a.get('severity'), '????')} "
                f"{a.get('fingerprint', '?'):<36} {state:<8} "
                f"{_age(now, when):>5}  value={a.get('value')}")
    return "\n".join(lines) + "\n"


def fetch_frame(url: str, window_s: float) -> str:
    """One full fetch + render cycle."""
    metrics = parse_prometheus(_fetch(url.rstrip('/') + "/metrics?aggregate=1"))
    try:
        alerts = _fetch_json(url.rstrip('/') + "/alerts")
    except (urllib.error.URLError, urllib.error.HTTPError, ValueError, OSError):
        alerts = {}   # watchtower off: /alerts 404s — render without it
    series: Dict[str, dict] = {}
    if alerts:
        base = url.rstrip('/') + "/series"
        try:
            series["tokens"] = _fetch_json(
                f"{base}?name=serving_replica_tokens_total&window_s={window_s}")
            series["ttft_p95"] = _fetch_json(
                f"{base}?name=serving_router_ttft_s&window_s={window_s}&q=0.95")
        except (urllib.error.URLError, urllib.error.HTTPError,
                ValueError, OSError):
            series = {}
    return render(metrics, alerts, series, url)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ds_top",
        description="live fleet view from a router's telemetry endpoint "
                    "(/metrics?aggregate=1 + /alerts + /series)")
    ap.add_argument("--url", default="http://127.0.0.1:9100",
                    help="router exposition endpoint base URL")
    ap.add_argument("--once", action="store_true",
                    help="render one frame and exit (no screen clearing)")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh cadence in live mode (seconds)")
    ap.add_argument("--window", type=float, default=60.0,
                    help="trend window for sparklines (seconds)")
    args = ap.parse_args(argv)
    if args.once:
        try:
            sys.stdout.write(fetch_frame(args.url, args.window))
        except (urllib.error.URLError, urllib.error.HTTPError,
                ValueError, OSError) as e:
            sys.stderr.write(f"ds_top: cannot reach {args.url}: {e}\n")
            return 1
        return 0
    try:
        while True:
            try:
                frame = fetch_frame(args.url, args.window)
                sys.stdout.write("\x1b[2J\x1b[H" + frame)
            except (urllib.error.URLError, urllib.error.HTTPError,
                    ValueError, OSError) as e:
                sys.stdout.write(f"\x1b[2J\x1b[Hds_top: cannot reach "
                                 f"{args.url}: {e} (retrying)\n")
            sys.stdout.flush()
            time.sleep(max(0.2, args.interval))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
