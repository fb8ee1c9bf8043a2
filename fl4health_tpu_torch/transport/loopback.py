"""Host-level RPC loopback, the cross-silo transport seam (counterpart of
``fl4health_tpu/transport/loopback.py``, a copy): length-prefixed frames
(``transport/codec.py``) over TCP, one request and one response a
connection. The in-process simulation stays the fast path; this is the
boundary for silos that do not share a process.
"""

from __future__ import annotations

import socket
import struct
import threading
from typing import Callable

_LEN = struct.Struct("<Q")


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    # bytearray accumulation: linear cost for multi-MB model frames (bytes
    # concatenation would re-copy the growing buffer every chunk).
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        received = conn.recv_into(view[got:], min(n - got, 1 << 20))
        if not received:
            raise ConnectionError("peer closed mid-frame")
        got += received
    return bytes(buf)


def send_frame(conn: socket.socket, frame: bytes) -> None:
    conn.sendall(_LEN.pack(len(frame)) + frame)


def recv_frame(conn: socket.socket) -> bytes:
    (n,) = _LEN.unpack(_recv_exact(conn, _LEN.size))
    return _recv_exact(conn, n)


class LoopbackServer:
    """One-thread request/response server: handler(frame_bytes) -> frame_bytes."""

    def __init__(self, handler: Callable[[bytes], bytes], host: str = "127.0.0.1",
                 port: int = 0):
        # port=0: OS-assigned (in-process silos); a fixed port for a real
        # cross-host deployment
        self.handler = handler
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(8)
        self.host, self.port = self.sock.getsockname()
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self) -> None:
        self.sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self.sock.accept()
            except socket.timeout:
                continue
            with conn:
                try:
                    request = recv_frame(conn)
                    send_frame(conn, self.handler(request))
                except Exception:
                    # One bad peer/frame (corrupt bytes -> FrameError, handler
                    # bugs, disconnects) must not kill the serve loop; the
                    # connection closes, the server lives on.
                    import logging

                    logging.getLogger(__name__).exception(
                        "loopback request failed; connection dropped"
                    )

    def close(self) -> None:
        self._stop.set()
        self.thread.join(timeout=2)
        self.sock.close()


def call(host: str, port: int, frame: bytes, timeout: float = 10.0) -> bytes:
    with socket.create_connection((host, port), timeout=timeout) as conn:
        send_frame(conn, frame)
        return recv_frame(conn)
