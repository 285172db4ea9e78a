"""Async file I/O handle over the host library's thread pool.

Counterpart of ``deepspeed_tpu/ops/aio.py`` (reference
``csrc/aio/py_lib/deepspeed_py_aio_handle.cpp`` and its
``AsyncIOBuilder`` wrapper). :class:`AsyncIOHandle` schedules positioned
reads and writes of C-contiguous CPU tensors (pinned or not) or numpy
arrays on the native pool (``csrc/aio.cpp``), which splits each request
into ``block_size`` chunks. ``native=False`` runs the same requests on a
``ThreadPoolExecutor`` instead, for tests that ask for it.

A request keeps its buffer alive until :meth:`AsyncIOHandle.wait`
returns; a failed request raises OSError there (a file that cannot be
opened raises at submission on the native route).
"""
from __future__ import annotations

import os
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from .native import load_library


def _address(buf) -> tuple[int, int]:
    """(address, bytes) of a contiguous CPU tensor or numpy array."""
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu" or not buf.is_contiguous():
            raise ValueError("aio needs a C-contiguous CPU tensor")
        return buf.data_ptr(), buf.numel() * buf.element_size()
    if isinstance(buf, np.ndarray) and buf.flags.c_contiguous:
        return buf.ctypes.data, buf.nbytes
    raise ValueError("aio needs a C-contiguous CPU tensor or numpy array")


def _bytes_view(buf) -> np.ndarray:
    if isinstance(buf, torch.Tensor):
        buf = buf.view(torch.uint8).numpy() if buf.numel() else \
            np.empty(0, np.uint8)
    return buf.reshape(-1).view(np.uint8)


class AsyncIOHandle:
    """Reference ``aio_handle(block_size, queue_depth, single_submit,
    overlap_events, num_threads)``: here ``(num_threads, block_size)``; the
    other knobs are libaio's."""

    def __init__(self, num_threads: int = 8, block_size: int = 1 << 20,
                 native: bool = True):
        self.num_threads = int(num_threads)
        self.block_size = int(block_size)
        self.native = bool(native)
        self._lib = load_library() if self.native else None
        self._handle = None
        self._pool: ThreadPoolExecutor | None = None
        self._futures: dict[int, Future] = {}
        self._next_id = 1
        self._keepalive: dict[int, object] = {}
        if self.native:
            self._handle = self._lib.dstpu_aio_create(self.num_threads,
                                                      self.block_size)
        else:
            self._pool = ThreadPoolExecutor(max_workers=self.num_threads)

    # -- submission -----------------------------------------------------
    def async_pread(self, buf, path: str, file_offset: int = 0) -> int:
        """Read ``buf``'s size in bytes from ``path`` at ``file_offset``
        into ``buf``; returns the request id."""
        addr, nbytes = _address(buf)
        if self.native:
            return self._native(self._lib.dstpu_aio_read, buf, addr, nbytes,
                                path, file_offset)

        def work():
            with open(path, "rb") as f:
                f.seek(file_offset)
                data = f.read(nbytes)
            if len(data) != nbytes:
                raise OSError(f"short read from {path}")
            _bytes_view(buf)[:] = np.frombuffer(data, np.uint8)

        return self._plain(work, buf)

    def async_pwrite(self, buf, path: str, file_offset: int = 0) -> int:
        """Write ``buf`` to ``path`` at ``file_offset`` (the file is created
        when missing); returns the request id."""
        addr, nbytes = _address(buf)
        if self.native:
            return self._native(self._lib.dstpu_aio_write, buf, addr, nbytes,
                                path, file_offset)

        def work():
            fd = os.open(path, os.O_WRONLY | os.O_CREAT, 0o644)
            try:
                os.pwrite(fd, _bytes_view(buf).tobytes(), file_offset)
            finally:
                os.close(fd)

        return self._plain(work, buf)

    def _native(self, fn, buf, addr, nbytes, path, file_offset) -> int:
        rid = fn(self._handle, os.fsencode(path), addr, nbytes, file_offset)
        if rid < 0:
            raise OSError(-rid, os.strerror(-rid), path)
        self._keepalive[rid] = buf
        return rid

    def _plain(self, work, buf) -> int:
        rid = self._next_id
        self._next_id += 1
        self._futures[rid] = self._pool.submit(work)
        self._keepalive[rid] = buf
        return rid

    # -- completion -----------------------------------------------------
    def wait(self, request_id: int) -> None:
        """Block until the request completes; raises OSError on failure."""
        try:
            if self.native:
                st = self._lib.dstpu_aio_wait(self._handle, request_id)
                if st < 0:
                    raise OSError(-st, os.strerror(-st))
            else:
                self._futures.pop(request_id).result()
        finally:
            self._keepalive.pop(request_id, None)

    def pending(self) -> int:
        """Requests submitted and not yet waited for (native) or not yet
        done (plain)."""
        if self.native:
            return self._lib.dstpu_aio_pending(self._handle)
        return sum(1 for f in self._futures.values() if not f.done())

    def sync_pread(self, buf, path: str, file_offset: int = 0) -> None:
        self.wait(self.async_pread(buf, path, file_offset))

    def sync_pwrite(self, buf, path: str, file_offset: int = 0) -> None:
        self.wait(self.async_pwrite(buf, path, file_offset))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dstpu_aio_destroy(self._handle)
            self._handle = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
