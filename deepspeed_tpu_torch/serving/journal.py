"""Write-ahead request journal: the router's crash safety.

The fleet made every data-plane component survivable, but the router
process itself was the last single point of failure: its death lost all
in-flight request state, placement, transfer bookkeeping and any deploy
in progress. This module is the durable half of the fix (the other half
is fleet re-adoption — the ``resync`` exchange in router.py/replica.py):
every router state transition appends one record here BEFORE the action
it describes takes effect, so a restarted router replays the journal and
reconstructs exactly what the dead incarnation knew.

Format — deliberately boring, greppable, torn-tail tolerant::

    <compact json>|<crc32 hex>\\n          one record per line

- **append-only segments** (``wal-00000001.log``, ...): the active
  segment rotates past ``segment_bytes``; when a ``snapshot_fn`` is
  installed (the router's live-state summarizer) rotation writes the
  snapshot as the new segment's first record and deletes every older
  segment — the journal stays bounded by live state, not history.
- **crc'd records**: every line carries the crc32 of its payload. A
  torn tail (the crash raced a write) or a corrupt line fails the crc or
  the parse and is counted + skipped — replay never raises on bad input,
  it recovers everything before the tear.
- **unbuffered writes**: records go through ``os.write`` on an
  ``O_APPEND`` fd, so a SIGKILL'd router loses nothing it logged — the
  bytes are in the page cache regardless of fsync.
- **fsync policy** (what a *host* crash can lose): ``"always"`` fsyncs
  every record, ``"interval"`` at most every ``fsync_interval_s`` (and
  on records marked critical — admits and terminals), ``"none"`` leaves
  it to the OS. Process death (the chaos matrix's SIGKILL) is safe
  under every mode.

Record kinds (written by router.py, reduced by
:func:`reduce_router_records`)::

    boot     a router incarnation opened the journal
    admit    one admitted request (the full replayable RequestRecord)
    place    an assignment: (slot, epoch, attempt nonce, via)
    requeue  the request went back to the queue (replay / recovery)
    prog     committed stream progress: (offset, tokens appended)
    term     terminal transition: done (with the full stream) | failed |
             shed, with the structured reason
    deploy   rolling-deploy phase transition (wid, phase, outcome, and
             the rollback target) — recovery resumes or rolls back from
             the last journaled phase
    snap     compaction snapshot (whole live state; resets the reducer)
"""
from __future__ import annotations

import json
import os
import time
import zlib
from dataclasses import dataclass, field

from .protocol import RequestRecord

#: fsync policies (see module docstring)
FSYNC_MODES = ("always", "interval", "none")

_SEG_PREFIX, _SEG_SUFFIX = "wal-", ".log"

#: journal record kinds (the reducer's vocabulary; bin lint
#: check_protocol_msgs.py does NOT govern these — they are file records,
#: not wire messages)
RECORD_KINDS = ("boot", "admit", "place", "requeue", "prog", "term",
                "deploy", "elastic", "snap")


class JournalError(RuntimeError):
    """Unusable journal configuration or directory."""


class Journal:
    """Append-only crc'd record log with segment rotation. One writer
    (the router); replay happens once, at construction time of the next
    incarnation, via :meth:`replay`."""

    def __init__(self, path: str, fsync: str = "interval",
                 fsync_interval_s: float = 0.2,
                 segment_bytes: int = 4 << 20):
        if fsync not in FSYNC_MODES:
            raise JournalError(f"unknown fsync mode {fsync!r} "
                               f"(want one of {FSYNC_MODES})")
        self.path = path
        self.fsync = fsync
        self.fsync_interval_s = float(fsync_interval_s)
        self.segment_bytes = int(segment_bytes)
        try:
            os.makedirs(path, exist_ok=True)
        except OSError as e:
            raise JournalError(f"journal dir {path!r} unusable: {e}")
        #: live-state summarizer installed by the owner; called at
        #: rotation so the new segment opens with a complete snapshot
        #: and every older segment becomes garbage
        self.snapshot_fn = None
        self._fd: int | None = None
        self._size = 0
        self._seq = 0
        self._last_fsync = 0.0
        self.records_appended = 0
        self.bytes_appended = 0
        self.records_replayed = 0
        self.bad_records = 0
        segs = self.segments()
        if segs:
            self._seq = self._seg_num(segs[-1])

    # -- segments --------------------------------------------------------
    def segments(self) -> list[str]:
        """Existing segment file names, oldest first."""
        try:
            names = os.listdir(self.path)
        except OSError:
            return []
        return sorted(n for n in names
                      if n.startswith(_SEG_PREFIX)
                      and n.endswith(_SEG_SUFFIX))

    @staticmethod
    def _seg_num(name: str) -> int:
        try:
            return int(name[len(_SEG_PREFIX):-len(_SEG_SUFFIX)])
        except ValueError:
            return 0

    def _seg_path(self, seq: int) -> str:
        return os.path.join(self.path,
                            f"{_SEG_PREFIX}{seq:08d}{_SEG_SUFFIX}")

    def _open_active(self) -> None:
        if self._seq == 0:
            self._seq = 1
        p = self._seg_path(self._seq)
        self._fd = os.open(p, os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                           0o644)
        try:
            self._size = os.fstat(self._fd).st_size
        except OSError:
            self._size = 0

    def rotate(self) -> None:
        """Open the next segment; if a ``snapshot_fn`` is installed,
        write its snapshot as the first record and delete every older
        segment (compaction — replay then starts from the snapshot)."""
        if self._fd is not None:
            if self.fsync != "none":
                try:
                    os.fsync(self._fd)
                except OSError:
                    pass            # best effort on the outgoing segment
            os.close(self._fd)
            self._fd = None
        old = self.segments()
        self._seq += 1
        self._open_active()
        if self.snapshot_fn is not None:
            snap = self.snapshot_fn()
            self._write({"k": "snap", **(snap or {})}, critical=True)
            # the new segment's DIRECTORY entry must be durable before
            # the old segments go away, or a host crash can come back
            # with neither the snapshot nor the history it replaced
            self._fsync_dir()
            for name in old:
                if self._seg_num(name) < self._seq:
                    try:
                        os.unlink(os.path.join(self.path, name))
                    except OSError:
                        pass        # already gone; replay tolerates both
            self._fsync_dir()

    def _fsync_dir(self) -> None:
        if self.fsync == "none":
            return
        try:
            fd = os.open(self.path, os.O_RDONLY)
        except OSError:
            return
        try:
            os.fsync(fd)
        except OSError:
            pass                    # e.g. a filesystem without dir fsync
        finally:
            os.close(fd)

    # -- append ----------------------------------------------------------
    def append(self, kind: str, data: dict | None = None,
               critical: bool = False) -> None:
        rec = {"k": kind}
        if data:
            rec.update(data)
        if self._fd is None:
            self._open_active()
        elif self._size >= self.segment_bytes:
            self.rotate()
        self._write(rec, critical)

    def _write(self, rec: dict, critical: bool) -> None:
        line = json.dumps(rec, separators=(",", ":")).encode()
        buf = line + b"|%08x\n" % (zlib.crc32(line) & 0xFFFFFFFF)
        os.write(self._fd, buf)
        self._size += len(buf)
        self.records_appended += 1
        self.bytes_appended += len(buf)
        if self.fsync == "none":
            return
        now = time.monotonic()
        if self.fsync == "always" or critical \
                or now - self._last_fsync >= self.fsync_interval_s:
            self._last_fsync = now
            try:
                os.fsync(self._fd)
            except OSError:
                pass                # e.g. tmpfs without fsync; best effort

    # -- replay ----------------------------------------------------------
    def replay(self) -> list[dict]:
        """Every intact record across all segments, oldest first. Bad
        lines (torn tail, corruption) are counted in ``bad_records`` and
        skipped — replay NEVER raises on journal content."""
        out: list[dict] = []
        for name in self.segments():
            try:
                with open(os.path.join(self.path, name), "rb") as f:
                    data = f.read()
            except OSError:
                continue
            for raw in data.split(b"\n"):
                if not raw.strip():
                    continue
                body, _, crc = raw.rpartition(b"|")
                try:
                    if int(crc, 16) != (zlib.crc32(body) & 0xFFFFFFFF):
                        raise ValueError("crc mismatch")
                    rec = json.loads(body)
                    if not isinstance(rec, dict) or "k" not in rec:
                        raise ValueError("not a journal record")
                except (ValueError, UnicodeDecodeError):
                    self.bad_records += 1
                    continue
                out.append(rec)
        self.records_replayed = len(out)
        return out

    def stats(self) -> dict:
        return {"segments": len(self.segments()),
                "records_appended": self.records_appended,
                "bytes_appended": self.bytes_appended,
                "records_replayed": self.records_replayed,
                "bad_records": self.bad_records,
                "fsync": self.fsync}

    def close(self) -> None:
        if self._fd is not None:
            if self.fsync != "none":
                try:
                    os.fsync(self._fd)
                except OSError:
                    pass
            os.close(self._fd)
            self._fd = None


# ---------------------------------------------------------------------------
# reducer: records -> recovered router state
# ---------------------------------------------------------------------------

#: recovered-request statuses ("open" = non-terminal: the restarted
#: router holds it in RECOVERING until resync re-adopts it or the hold
#: window expires and it replays)
OPEN = "open"


@dataclass
class RecoveredRequest:
    rec: RequestRecord
    committed: list[int] = field(default_factory=list)
    status: str = OPEN                # "open" | "done" | "failed" | "shed"
    reason: str | None = None
    result: list[int] | None = None
    attempt: int = 0
    retries: int = 0
    last_slot: int = -1               # last journaled placement (info only)


@dataclass
class RecoveredState:
    reqs: dict[str, RecoveredRequest] = field(default_factory=dict)
    #: the last journaled deploy payload with no terminal outcome — the
    #: restarted router rolls it back deterministically (see router.py)
    deploy: dict | None = None
    #: a deploy record (terminal or not) appeared at all — the CLI uses
    #: this to avoid re-starting a deploy the journal already carries
    saw_deploy: bool = False
    #: the last journaled elastic transition (serving/elastic.py) with no
    #: terminal outcome — a restart mid-drain must neither resurrect a
    #: retiring replica nor forget a half-spawned one, so the controller
    #: re-adopts this action instead of re-deriving it from hints
    elastic: dict | None = None
    boots: int = 0

    @property
    def open_reqs(self) -> dict[str, RecoveredRequest]:
        return {t: r for t, r in self.reqs.items() if r.status == OPEN}


def _req_from_snap(e: dict) -> RecoveredRequest:
    return RecoveredRequest(
        rec=RequestRecord(trace_id=str(e["id"]),
                          prompt=[int(x) for x in e.get("prompt", ())],
                          max_new_tokens=int(e.get("max_new", 16)),
                          eos_token_id=e.get("eos"),
                          tenant=str(e.get("tenant", "default")),
                          priority=int(e.get("prio", 0))),
        committed=[int(x) for x in e.get("committed", ())],
        attempt=int(e.get("a", 0)), retries=int(e.get("retries", 0)))


def reduce_router_records(records: list[dict]) -> RecoveredState:
    """Fold journal records into the state a restarted router resumes
    from. Tolerant by construction: records for unknown requests (their
    admit fell in a compacted segment or a torn tail) are dropped, and
    progress offsets dedup against the committed prefix exactly like the
    live router's stream folding does."""
    st = RecoveredState()
    for rec in records:
        k = rec.get("k")
        if k == "boot":
            st.boots += 1
        elif k == "snap":
            st.reqs = {}
            for e in rec.get("reqs") or []:
                try:
                    st.reqs[str(e["id"])] = _req_from_snap(e)
                except (KeyError, TypeError, ValueError):
                    continue
            # terminal history survives compaction: duplicate-admit
            # dedup and result fidelity must not depend on how recently
            # the journal rotated
            for e in rec.get("terms") or []:
                try:
                    r = _req_from_snap(e)
                except (KeyError, TypeError, ValueError):
                    continue
                r.status = str(e.get("status", "failed"))
                r.reason = e.get("reason")
                if "toks" in e:
                    r.result = [int(x) for x in e["toks"]]
                st.reqs[r.rec.trace_id] = r
            st.deploy = rec.get("deploy") or None
            st.elastic = rec.get("elastic") or None
            st.boots = max(st.boots, int(rec.get("boots", 0)))
            if st.deploy or rec.get("saw_deploy"):
                st.saw_deploy = True
        elif k == "admit":
            try:
                r = _req_from_snap(rec)
            except (KeyError, TypeError, ValueError):
                continue
            st.reqs[r.rec.trace_id] = r
        else:
            tid = str(rec.get("id"))
            req = st.reqs.get(tid)
            if k == "deploy":
                st.saw_deploy = True
                st.deploy = None if rec.get("outcome") else dict(rec)
                continue
            if k == "elastic":
                # same shape as deploy: a terminal outcome clears the
                # in-flight action, anything else IS the action to resume
                st.elastic = None if rec.get("outcome") else dict(rec)
                continue
            if req is None or req.status != OPEN:
                continue
            if k == "place":
                req.attempt = int(rec.get("a", req.attempt))
                req.last_slot = int(rec.get("slot", -1))
                if rec.get("via") != "readopt":
                    req.retries = max(req.retries, req.attempt - 1)
            elif k == "requeue":
                req.attempt = int(rec.get("a", req.attempt))
                req.last_slot = -1
            elif k == "prog":
                off = int(rec.get("off", 0))
                toks = [int(x) for x in rec.get("toks", ())]
                have = len(req.committed)
                if off <= have:
                    req.committed.extend(toks[have - off:])
            elif k == "term":
                req.status = str(rec.get("status", "failed"))
                req.reason = rec.get("reason")
                if "toks" in rec:
                    req.result = [int(x) for x in rec["toks"]]
    return st
