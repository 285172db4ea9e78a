"""Flight recorder: the last-N telemetry events, dumped as structured JSON
when something dies.

The resilience layer's hang watchdog already dumps WHERE the job was stuck
(all-thread stacks); the flight recorder adds WHAT it was doing — the most
recent spans, discrete events (bad steps, rewinds, preemptions, checkpoint
commits), and a metrics snapshot — so a postmortem reads like a timeline
instead of a core dump. Dumps are triggered by the watchdog, by
``DivergenceError``, and by preemption exits (runtime/resilience.py), or
manually via :meth:`dump`.
"""
from __future__ import annotations

import collections
import json
import os
import time

from ..utils.logging import logger

#: dump-directory retention defaults (count + bytes, oldest-out) — a
#: breach/alert storm must age out its own history, not fill the disk
DEFAULT_DUMP_MAX_FILES = 64
DEFAULT_DUMP_MAX_BYTES = 256 << 20


def prune_dump_dir(path: str, max_files: int = DEFAULT_DUMP_MAX_FILES,
                   max_bytes: int = DEFAULT_DUMP_MAX_BYTES,
                   prefix: str | None = None, registry=None) -> int:
    """Oldest-out retention for a dump directory. Returns files removed.

    Only files whose basename starts with ``prefix`` are considered (and
    eligible for deletion) — dump directories are often shared (tmp trees,
    ``fleet_trace_dir`` also holds journal segments), and an unscoped
    sweep would eat neighbors. Newest files always survive; removal stops
    as soon as both the count and byte caps hold. Increments
    ``telemetry_dumps_pruned_total`` on ``registry`` when files go.
    Never raises — retention is best-effort housekeeping.
    """
    try:
        names = os.listdir(path)
    except OSError:
        return 0
    entries: list[tuple[float, int, str]] = []
    for n in names:
        if prefix is not None and not n.startswith(prefix):
            continue
        p = os.path.join(path, n)
        try:
            st = os.stat(p)
        except OSError:
            continue
        if not os.path.isfile(p):
            continue
        entries.append((st.st_mtime, st.st_size, p))
    entries.sort()          # oldest first
    count = len(entries)
    total = sum(sz for (_m, sz, _p) in entries)
    removed = 0
    for _mtime, sz, p in entries[:-1]:   # never remove the newest
        if count <= max_files and total <= max_bytes:
            break
        try:
            os.remove(p)
            removed += 1
        except OSError:
            pass
        count -= 1
        total -= sz
    if removed:
        logger.warning(f"flight recorder: pruned {removed} old dump(s) "
                       f"from {path} (caps: {max_files} files / "
                       f"{max_bytes >> 20} MiB)")
        if registry is not None:
            registry.counter(
                "telemetry_dumps_pruned_total",
                help="dump files removed by dump-directory retention "
                     "(count+bytes caps, oldest-out)",
            ).inc(removed)
    return removed


class FlightRecorder:
    """Bounded deque of discrete events + access to the span ring and
    metrics registry at dump time. ``note()`` is safe to call even when
    telemetry is disabled — postmortem breadcrumbs are cheap and only read
    on catastrophic exits."""

    def __init__(self, tracer=None, registry=None, capacity: int = 256,
                 path: str | None = None):
        self.tracer = tracer
        self.registry = registry
        self.capacity = int(capacity)
        #: default dump target; DS_TPU_FLIGHT_RECORDER overrides, dump(path=)
        #: overrides both. None → log-only dump.
        self.path = path or os.environ.get("DS_TPU_FLIGHT_RECORDER")
        self._events: collections.deque = collections.deque(maxlen=capacity)
        self.dumps = 0
        #: retention caps applied to the default dump path's directory
        #: after each numbered dump (prune_dump_dir, scoped to this dump
        #: family's basename); set either to None to disable pruning
        self.max_dump_files: int | None = DEFAULT_DUMP_MAX_FILES
        self.max_dump_bytes: int | None = DEFAULT_DUMP_MAX_BYTES

    def note(self, kind: str, **data) -> None:
        """Record a discrete event (bad step, rewind, ckpt commit, ...).
        Carries BOTH clocks: ``t`` (wall — correlates with external logs
        and other hosts) and ``mono`` (monotonic — orders against span /
        reqtrace timelines in this process and the fleet assembler's
        clock-aligned merge)."""
        rec = {"t": time.time(), "mono": time.monotonic(), "kind": kind}
        if data:
            rec.update(data)
        self._events.append(rec)

    def events(self) -> list[dict]:
        return list(self._events)

    def record(self, reason: str, detail: str | None = None,
               max_spans: int = 128, extra: dict | None = None) -> dict:
        """Assemble the postmortem record (no I/O). ``extra`` attaches
        caller payloads — e.g. the SLO-breach auto-capture's offending
        request timeline + engine state snapshot (telemetry/reqtrace.py)
        — under their own keys, without clobbering the standard ones."""
        rec = {
            "reason": reason,
            "time": time.time(),
            "time_mono": time.monotonic(),
            "pid": os.getpid(),
            "events": self.events(),
            "spans": (self.tracer.events(last=max_spans)
                      if self.tracer is not None else []),
            # the wall anchor of the span clock: span t0s are
            # perf_counter-only, and without this mapping a dump's span
            # timeline cannot be correlated with external logs or other
            # processes (wall ≈ span_epoch_wall + (t0 - span_epoch))
            "span_epoch": (self.tracer._epoch
                           if self.tracer is not None else None),
            "span_epoch_wall": (self.tracer.epoch_wall
                                if self.tracer is not None else None),
            "metrics": (self.registry.snapshot()
                        if self.registry is not None else {}),
        }
        if detail:
            rec["detail"] = detail
        if extra:
            for k, v in extra.items():
                rec.setdefault(k, v)
        return rec

    def dump(self, reason: str, path: str | None = None,
             detail: str | None = None, extra: dict | None = None) -> dict:
        """Write the postmortem record as one JSON file. Dumps to the
        DEFAULT path are append-numbered so repeated dumps of a flapping
        job don't clobber each other; an explicit ``path=`` is honored
        verbatim — callers passing one (the fleet black box numbers its
        own ``fleet_blackbox_N.json`` files) already uniquify, and a
        silent ``.N`` suffix would break their documented names. Always
        returns the record even when the write fails — the caller is
        usually mid-crash and must not die in its own error handler."""
        rec = self.record(reason, detail=detail, extra=extra)
        target = path or self.path
        self.dumps += 1
        if target:
            final = target if path is not None or self.dumps == 1 \
                else f"{target}.{self.dumps}"
            try:
                d = os.path.dirname(os.path.abspath(final))
                os.makedirs(d, exist_ok=True)
                with open(final, "w") as f:
                    json.dump(rec, f, indent=1, default=repr)
                rec["dump_path"] = final
                logger.error(f"flight recorder: '{reason}' dump → {final} "
                             f"({len(rec['events'])} events, "
                             f"{len(rec['spans'])} spans)")
                if path is None and self.max_dump_files is not None \
                        and self.max_dump_bytes is not None:
                    # numbered default-path dumps accumulate; age them out
                    # (scoped to this dump family — the dir may be shared)
                    prune_dump_dir(d, max_files=self.max_dump_files,
                                   max_bytes=self.max_dump_bytes,
                                   prefix=os.path.basename(target),
                                   registry=self.registry)
            except OSError as e:
                logger.error(f"flight recorder write failed: {e}")
        else:
            logger.error(f"flight recorder ('{reason}'): "
                         f"last events: {rec['events'][-10:]}")
        return rec
