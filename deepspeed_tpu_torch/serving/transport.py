"""Remote transport: TCP / unix-socket drop-ins for the pipe protocol.

The serving protocol is newline-JSON over fds precisely so the transport
is swappable (ROADMAP): :class:`~.protocol.LineChannel` already runs on
any pair of non-blocking fds, and a connected socket IS such an fd on
POSIX. This module adds the two missing pieces, with the same
deadline-on-every-wait discipline ``bin/check_deadlines.py`` enforces:

- :func:`connect_channel` — dial ``host:port`` or ``unix:/path`` with a
  bounded non-blocking connect (``connect_ex`` + ``select``; the lint
  bans blocking ``.connect()`` outright) and return a
  :class:`SocketChannel`.
- :class:`SocketListener` — bind/listen once, then hand out one
  :class:`SocketChannel` per ``accept_channel(timeout)`` call. The
  accept itself runs only after ``select`` reports the listener readable
  within the deadline (the one allowlisted ``accept`` call site).

Topology: a remote replica runs ``python -m deepspeed_tpu_torch.serving.replica
--listen <addr> '<cfg json>'`` as a daemon — it accepts one router at a
time and goes back to accepting when that router disappears — and the
fleet dials out to it (``FleetConfig.replica["address"]`` / per-slot):
the router side keeps its restart policy (reconnect with backoff,
breaker) while the replica process's lifetime belongs to whoever started
it. Role-split replicas therefore need not share a pipe parent — or a
host.
"""
from __future__ import annotations

import errno
import os
import select
import socket
import time

from .protocol import LineChannel


def parse_address(address: str) -> tuple[int, object]:
    """``"unix:/path"`` -> (AF_UNIX, path); ``"host:port"`` ->
    (AF_INET, (host, port))."""
    if address.startswith("unix:"):
        return socket.AF_UNIX, address[5:]
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"bad address {address!r}: want host:port or "
                         f"unix:/path")
    return socket.AF_INET, (host, int(port))


class SocketChannel(LineChannel):
    """A :class:`LineChannel` over one connected socket: same fd for both
    directions, the socket object owned (and closed) by the channel."""

    def __init__(self, sock: socket.socket):
        self._sock = sock
        sock.setblocking(False)
        super().__init__(sock.fileno(), sock.fileno(), own_fds=False)

    def close(self) -> None:
        super().close()
        try:
            self._sock.close()
        except OSError:        # pragma: no cover — already torn down
            pass


def connect_channel(address: str, timeout: float = 5.0) -> SocketChannel:
    """Dial a listening replica/router with a bounded non-blocking
    connect. Raises ``OSError`` (including ``TimeoutError``) on failure —
    the caller's restart policy decides what a dead address means."""
    fam, target = parse_address(address)
    sock = socket.socket(fam, socket.SOCK_STREAM)
    sock.setblocking(False)
    rc = sock.connect_ex(target)
    if rc not in (0, errno.EINPROGRESS, errno.EWOULDBLOCK, errno.EAGAIN):
        sock.close()
        raise OSError(rc, f"connect to {address!r} failed: "
                          f"{os.strerror(rc)}")
    deadline = time.perf_counter() + max(timeout, 0.0)
    while rc != 0:
        wait = deadline - time.perf_counter()
        if wait <= 0:
            sock.close()
            raise TimeoutError(f"connect to {address!r} timed out after "
                               f"{timeout}s")
        _, w, _ = select.select([], [sock], [], wait)
        if not w:
            continue
        rc = sock.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if rc not in (0, errno.EINPROGRESS):
            sock.close()
            raise OSError(rc, f"connect to {address!r} failed: "
                              f"{os.strerror(rc)}")
    if fam == socket.AF_INET:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return SocketChannel(sock)


class SocketListener:
    """Bound + listening endpoint handing out :class:`SocketChannel`\\ s.
    Every wait is a ``select`` with an explicit timeout; ``accept`` runs
    only on a readable listener (allowlisted in check_deadlines.py for
    exactly this function)."""

    def __init__(self, address: str, backlog: int = 4):
        self.address = address
        fam, target = parse_address(address)
        if fam == socket.AF_UNIX and isinstance(target, str) \
                and os.path.exists(target):
            os.unlink(target)      # a previous daemon's stale socket file
        self._sock = socket.socket(fam, socket.SOCK_STREAM)
        if fam == socket.AF_INET:
            self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR,
                                  1)
        self._sock.setblocking(False)
        self._sock.bind(target)
        self._sock.listen(backlog)

    @property
    def bound_address(self) -> str:
        """The concrete address (TCP port 0 resolves to the real port)."""
        fam = self._sock.family
        if fam == socket.AF_UNIX:
            return f"unix:{self._sock.getsockname()}"
        host, port = self._sock.getsockname()[:2]
        return f"{host}:{port}"

    def accept_channel(self, timeout: float) -> SocketChannel | None:
        """One bounded accept: ``None`` if nobody dialed in within the
        deadline."""
        r, _, _ = select.select([self._sock], [], [], max(timeout, 0.0))
        if not r:
            return None
        try:
            sock, _ = self._sock.accept()
        except OSError:            # the dialer gave up between select/accept
            return None
        if sock.family == socket.AF_INET:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return SocketChannel(sock)

    def close(self) -> None:
        fam, target = self._sock.family, None
        try:
            if fam == socket.AF_UNIX:
                target = self._sock.getsockname()
        except OSError:            # pragma: no cover
            pass
        try:
            self._sock.close()
        except OSError:            # pragma: no cover
            pass
        if target and isinstance(target, str) and os.path.exists(target):
            os.unlink(target)
