"""Minimal mDNS/DNS-SD service advertise + browse (avahi.c analog).

The reference forks avahi-publish to advertise `_ka9q-ctl._udp`,
`_rtp._udp` and `_opus._udp` services and browses them from `control`
(avahi_browse.c). This is a dependency-free responder/browser speaking
just enough mDNS (RFC 6762/6763): PTR + SRV + TXT + A records, answering
queries and sending unsolicited announcements; the browser one-shots a PTR
query and collects responses.

Only the subset the ka9q toolset needs — not a general mDNS stack.
"""
from __future__ import annotations

import select
import socket
import struct
import threading
import time

__all__ = ["MdnsAdvertiser", "browse", "SVC_CTL", "SVC_RTP", "SVC_OPUS"]

MDNS_GRP = "224.0.0.251"
MDNS_PORT = 5353
SVC_CTL = "_ka9q-ctl._udp.local."
SVC_RTP = "_rtp._udp.local."
SVC_OPUS = "_opus._udp.local."


def _qname(name: str) -> bytes:
    out = b""
    for label in name.rstrip(".").split("."):
        b = label.encode()
        out += bytes([len(b)]) + b
    return out + b"\0"


def _parse_name(data: bytes, off: int) -> tuple[str, int]:
    labels = []
    jumps = 0
    pos = off
    end = None
    while True:
        if pos >= len(data) or jumps > 16:
            break
        ln = data[pos]
        if ln == 0:
            pos += 1
            break
        if ln & 0xC0 == 0xC0:
            if end is None:
                end = pos + 2
            pos = ((ln & 0x3F) << 8) | data[pos + 1]
            jumps += 1
            continue
        labels.append(data[pos + 1 : pos + 1 + ln].decode(errors="replace"))
        pos += 1 + ln
    return ".".join(labels) + ".", (end if end is not None else pos)


def _record(name: str, rtype: int, rdata: bytes, ttl: int = 120) -> bytes:
    return _qname(name) + struct.pack(">HHIH", rtype, 0x8001, ttl, len(rdata)) + rdata


class MdnsAdvertiser:
    """Advertises one or more (service_type, instance, port, txt) tuples."""

    def __init__(self, hostname: str | None = None):
        self.hostname = (hostname or socket.gethostname().split(".")[0]) + ".local."
        self.services: list[tuple[str, str, int, dict]] = []
        self._stop = threading.Event()
        self._thread = None
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        try:
            self.sock.bind(("", MDNS_PORT))
            self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                                 socket.inet_aton(MDNS_GRP) + socket.inet_aton("0.0.0.0"))
        except OSError:
            pass
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        self.addr = self._local_ip()

    @staticmethod
    def _local_ip() -> str:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("239.1.1.1", 1))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()

    def add_service(self, service_type: str, instance: str, port: int, txt: dict | None = None):
        self.services.append((service_type, instance, port, txt or {}))

    def _answers(self, only_type: str | None = None) -> bytes:
        out = b""
        n = 0
        for stype, inst, port, txt in self.services:
            if only_type and stype != only_type:
                continue
            full = f"{inst}.{stype}"
            out += _record(stype, 12, _qname(full))  # PTR
            srv = struct.pack(">HHH", 0, 0, port) + _qname(self.hostname)
            out += _record(full, 33, srv)  # SRV
            txt_data = b"".join(
                bytes([len(f"{k}={v}".encode())]) + f"{k}={v}".encode() for k, v in txt.items()
            ) or b"\0"
            out += _record(full, 16, txt_data)  # TXT
            out += _record(self.hostname, 1, socket.inet_aton(self.addr))  # A
            n += 4
        return struct.pack(">HHHHHH", 0, 0x8400, 0, n, 0, 0) + out

    def announce(self, only_type: str | None = None):
        pkt = self._answers(only_type)
        try:
            self.sock.sendto(pkt, (MDNS_GRP, MDNS_PORT))
        except OSError:
            pass

    def _serve(self):
        next_announce = 0.0
        while not self._stop.is_set():
            now = time.monotonic()
            if now >= next_announce:
                self.announce()
                next_announce = now + 60.0
            r, _, _ = select.select([self.sock], [], [], 0.5)
            if not r:
                continue
            try:
                pkt, addr = self.sock.recvfrom(9000)
            except OSError:
                continue
            if len(pkt) < 12:
                continue
            _, flags, qd, *_ = struct.unpack(">HHHHHH", pkt[:12])
            if flags & 0x8000:  # response, not a query
                continue
            off = 12
            for _ in range(qd):
                qname, off = _parse_name(pkt, off)
                if off + 4 > len(pkt):
                    break
                qtype, _qclass = struct.unpack(">HH", pkt[off : off + 4])
                off += 4
                for stype, *_rest in self.services:
                    if qname.lower() == stype.lower():
                        self.announce(stype)
                        break

    def start(self):
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self.sock.close()


def browse(service_type: str, timeout: float = 2.0) -> list[dict]:
    """One-shot DNS-SD browse: returns [{instance, host, addr, port, txt}]."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    try:
        s.bind(("", MDNS_PORT))
    except OSError:
        s.bind(("", 0))
    try:
        s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP,
                     socket.inet_aton(MDNS_GRP) + socket.inet_aton("0.0.0.0"))
    except OSError:
        pass
    s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 1)
    s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
    q = struct.pack(">HHHHHH", 0, 0, 1, 0, 0, 0) + _qname(service_type) + struct.pack(">HH", 12, 1)
    s.sendto(q, (MDNS_GRP, MDNS_PORT))

    found: dict[str, dict] = {}
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        r, _, _ = select.select([s], [], [], deadline - time.monotonic())
        if not r:
            break
        pkt, _ = s.recvfrom(9000)
        if len(pkt) < 12:
            continue
        _, flags, qd, an, ns, ar = struct.unpack(">HHHHHH", pkt[:12])
        if not flags & 0x8000:
            continue
        off = 12
        for _ in range(qd):
            _, off = _parse_name(pkt, off)
            off += 4
        recs = []
        for _ in range(an + ns + ar):
            name, off = _parse_name(pkt, off)
            if off + 10 > len(pkt):
                break
            rtype, _cls, _ttl, rdlen = struct.unpack(">HHIH", pkt[off : off + 10])
            off += 10
            rdata = pkt[off : off + rdlen]
            recs.append((name, rtype, rdata, off))
            off += rdlen
        addrs = {n: socket.inet_ntoa(d) for n, t, d, _ in recs if t == 1 and len(d) == 4}
        for name, rtype, rdata, doff in recs:
            if rtype == 33 and len(rdata) >= 6:  # SRV
                _, _, port = struct.unpack(">HHH", rdata[:6])
                host, _ = _parse_name(pkt, doff + 6)
                inst = name[: -len(service_type) - 1] if name.endswith("." + service_type) else name.split(".")[0]
                e = found.setdefault(name, {"instance": inst, "port": port, "host": host,
                                            "addr": addrs.get(host), "txt": {}})
                e["port"], e["host"] = port, host
                e["addr"] = addrs.get(host, e.get("addr"))
            elif rtype == 16:
                e = found.setdefault(name, {"instance": name.split(".")[0], "txt": {}})
                j = 0
                while j < len(rdata):
                    ln = rdata[j]
                    item = rdata[j + 1 : j + 1 + ln].decode(errors="replace")
                    j += 1 + ln
                    if "=" in item:
                        k, _, v = item.partition("=")
                        e["txt"][k] = v
    s.close()
    return list(found.values())
