"""The benchmark's RTP receiver, a process of its own.

It binds the daemon's data ports on 127.0.0.1, drains them while the daemon
runs (the measured process never reads a socket), and keeps, for every
datagram, its SSRC, RTP timestamp and payload size, and for the SSRCs it was asked to
keep, the payload. It imports neither torch nor the program.
"""
from __future__ import annotations

import array
import select
import socket
import struct
import time

__all__ = ["serve"]

_BUF = 64 << 20  # socket receive buffer asked for (SO_RCVBUFFORCE where allowed)


def _rcvbuf_errors() -> int:
    """The host's UDP receive-buffer overflows so far (/proc/net/snmp)."""
    try:
        with open("/proc/net/snmp") as fh:
            rows = [ln.split() for ln in fh if ln.startswith("Udp:")]
        return int(rows[1][rows[0].index("RcvbufErrors")])
    except (OSError, ValueError, IndexError):
        return -1


def _bind(port: int) -> socket.socket:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.setsockopt(socket.SOL_SOCKET, 33, _BUF)  # SO_RCVBUFFORCE
    except OSError:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, _BUF)
    s.bind(("127.0.0.1", port))
    s.setblocking(False)
    return s


def serve(conn, ports: list[int], keep: list[int]) -> None:
    """Receive on `ports` until `conn` says "stop", then drain until the
    sockets are quiet for 0.3 s and send back a dict: per packet the SSRC,
    timestamp and payload bytes (arrays), the kept SSRCs' (timestamp,
    payload) lists, the bytes and datagrams of each port, the socket buffer
    granted and the host's UDP buffer overflows during the run."""
    socks = [_bind(p) for p in ports]
    keep_set = set(int(k) for k in keep)
    ssrc, ts, size = array.array("I"), array.array("I"), array.array("I")
    kept: dict[int, list] = {k: [] for k in keep_set}
    per_port = {p: [0, 0] for p in ports}
    err0 = _rcvbuf_errors()
    granted = socks[0].getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF) if socks else 0
    conn.send(("ready", granted))
    unpack = struct.Struct("!II").unpack_from
    stopping, quiet_since = False, None
    while True:
        ready, _, _ = select.select(socks + [conn], [], [], 0.05)
        got = False
        for s in ready:
            if s is conn:
                if conn.recv() == "stop":
                    stopping = True
                continue
            port = s.getsockname()[1]
            while True:
                try:
                    pkt = s.recv(65536)
                except BlockingIOError:
                    break
                got = True
                if len(pkt) < 12:
                    continue
                t, sc = unpack(pkt, 4)
                ssrc.append(sc)
                ts.append(t)
                size.append(len(pkt) - 12)
                pp = per_port[port]
                pp[0] += 1
                pp[1] += len(pkt)
                if sc in keep_set:
                    kept[sc].append((t, pkt[12:]))
        if stopping:
            now = time.monotonic()
            if got or quiet_since is None:
                quiet_since = now
            elif now - quiet_since > 0.3:
                break
    for s in socks:
        s.close()
    err1 = _rcvbuf_errors()
    conn.send({"ssrc": ssrc, "ts": ts, "size": size, "kept": kept, "per_port": per_port,
               "rcvbuf_granted": granted,
               "rcvbuf_errors": err1 - err0 if err0 >= 0 and err1 >= 0 else None})
    conn.close()
