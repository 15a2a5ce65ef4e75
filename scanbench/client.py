"""The scan server's ``--via`` protocol, client side (a copy of
``grab_tpu_torch.server.client``'s framing, which the benchmark may not
import): one JSON line out; frames back, ``[u32 len][tag byte][payload]``
with tag 0 for stdout and 1 for stderr, ending in ``[u32 0][u32 exit
code]``."""

from __future__ import annotations

import json
import socket
import struct
from typing import List, Tuple


def request(sock_path: str, argv: List[str], timeout: float = 600.0) -> Tuple[int, bytes, bytes]:
    """Send one request; returns (exit code, stdout bytes, stderr bytes).
    Raises ConnectionError if the server closes the connection early."""
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    out, err = bytearray(), bytearray()
    try:
        conn.connect(sock_path)
        conn.sendall(json.dumps({"argv": argv}).encode() + b"\n")
        buf = bytearray()

        def recv_exact(n: int) -> bytes:
            while len(buf) < n:
                chunk = conn.recv(1 << 20)
                if not chunk:
                    raise ConnectionError("server closed the connection early")
                buf.extend(chunk)
            piece = bytes(buf[:n])
            del buf[:n]
            return piece

        while True:
            (length,) = struct.unpack("!I", recv_exact(4))
            if length == 0:
                (rc,) = struct.unpack("!I", recv_exact(4))
                return rc, bytes(out), bytes(err)
            frame = recv_exact(length)
            (out if frame[0] == 0 else err).extend(frame[1:])
    finally:
        conn.close()
