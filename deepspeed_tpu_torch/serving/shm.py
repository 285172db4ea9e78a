"""Shared-memory page-payload ring: the intra-host fast path for KV
transfers (serving/disagg.py handoffs, placement-time radix pulls).

The router relay works anywhere but pays twice for intra-host transfers:
every page crosses two pipes AND gets base64'd into newline-JSON. This
module keeps the CONTROL flow exactly where it is (chunk descriptors
still ride the deadline-bounded line protocol through the router — the
ownership/resume/abort story is untouched) and moves only the PAYLOAD:

- each replica may own one :class:`ShmRing` (``shm_bytes`` in its
  config), a fixed-size ``multiprocessing.shared_memory`` segment it
  alone writes; the segment name rides the replica's ready message.
- an exporting replica writes each chunk's raw bytes into its ring and
  sends the descriptor (``ref`` = ring offset, plus the same ``n``/
  ``crc`` every chunk carries) instead of base64 data.
- the importer attaches the exporter's ring READ-ONLY by name — once per
  replica pair, result cached (the "negotiation"; a cross-host daemon's
  attach simply fails) — copies the payload out through a
  ``memoryview`` slice and verifies the descriptor's crc.

There are deliberately NO locks and NO waits anywhere (this package's
every-wait-bounded law, bin/check_deadlines.py): the writer is the
segment's single mutator and simply overwrites oldest-first when it
wraps; a reader that loses the race (or attaches a dead/foreign ring)
sees a crc mismatch and falls back to the router-relay transport — the
always-correct slow path. Integrity is end-to-end: the crc in the
descriptor is computed by the exporter from the page bytes, so a torn
ring read can never be silently adopted.
"""
from __future__ import annotations

import zlib

from ..utils.logging import logger

#: refuse rings smaller than this (one toy bundle must fit comfortably;
#: a ring that thrashes on every bundle is slower than the relay)
MIN_RING_BYTES = 4096


def _shared_memory():
    """Deferred import: host-only deployments without POSIX shared memory
    (or with /dev/shm mounted noexec-weird) degrade to relay, never fail."""
    from multiprocessing import shared_memory
    return shared_memory


class ShmRing:
    """Writer side: a bump-cursor byte ring over one shared segment.

    ``write`` never blocks and never fails for want of space — the cursor
    wraps and overwrites the oldest payload (the reader's crc check is
    what makes that safe). Only a blob larger than the whole ring is
    refused (``None``), in which case the caller sends that chunk as an
    ordinary base64 relay chunk — transports mix freely per chunk.
    """

    def __init__(self, size: int):
        if size < MIN_RING_BYTES:
            raise ValueError(f"ring of {size}B is below the "
                             f"{MIN_RING_BYTES}B minimum")
        self._shm = _shared_memory().SharedMemory(create=True, size=size)
        self.size = size
        self._w = 0

    @property
    def name(self) -> str:
        return self._shm.name

    def write(self, blob: bytes) -> int | None:
        """Copy ``blob`` into the ring; returns its offset (the chunk
        descriptor's ``ref``) or None when the blob cannot fit at all."""
        n = len(blob)
        if n > self.size:
            return None
        if self._w + n > self.size:
            self._w = 0                  # never split a blob across the wrap
        off = self._w
        self._shm.buf[off:off + n] = blob
        self._w = off + n
        return off

    def close(self) -> None:
        try:
            self._shm.close()
            self._shm.unlink()
        except (OSError, FileNotFoundError):  # pragma: no cover — torn down
            pass


class ShmReader:
    """Read-only attachment to a peer's ring, by segment name."""

    def __init__(self, name: str):
        shm = _shared_memory().SharedMemory(name=name)
        # python 3.10's SharedMemory registers EVERY attachment with the
        # resource tracker, which unlinks registered segments when this
        # process exits — destroying the writer's live ring. Unregister:
        # the writer owns the segment's lifetime, we only borrow a view.
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name, "shared_memory")
        except (ImportError, AttributeError, KeyError, OSError) as e:
            # pragma: no cover — stdlib API drift; worst case is a
            # spurious tracker warning at exit, never a wrong unlink here
            logger.debug(f"shm: resource_tracker unregister skipped: {e}")
        self._shm = shm

    def read(self, off: int, n: int, crc: int) -> bytes | None:
        """Copy ``n`` payload bytes at ``off`` out of the ring; None when
        the crc disagrees (the writer lapped this extent, or the offset
        is garbage) — the caller falls back to the relay transport."""
        if not 0 <= off <= len(self._shm.buf) - n or n < 0:
            return None
        raw = bytes(self._shm.buf[off:off + n])
        return raw if zlib.crc32(raw) == int(crc) else None

    def close(self) -> None:
        try:
            self._shm.close()
        except (OSError, BufferError):   # pragma: no cover — torn down
            pass


def open_ring(size: int) -> ShmRing | None:
    """Best-effort ring creation: a host without usable POSIX shared
    memory serves over the relay transport instead of failing startup."""
    if size <= 0:
        return None
    try:
        return ShmRing(size)
    except (OSError, ValueError, ImportError) as e:
        logger.warning(f"shm: ring of {size}B unavailable ({e}); "
                       f"falling back to router relay")
        return None


def attach_ring(name: str) -> ShmReader | None:
    """Best-effort read-only attach; None means 'use the relay' (cached
    per peer by the caller — this is the per-pair transport negotiation)."""
    try:
        return ShmReader(name)
    except (OSError, ValueError, ImportError, FileNotFoundError) as e:
        logger.info(f"shm: attach of ring {name!r} failed ({e}); "
                    f"using router relay for this peer")
        return None
