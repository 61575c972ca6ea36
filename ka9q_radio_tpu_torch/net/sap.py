"""SAP/SDP session announcements (radio.c:1244-1366 sap_send).

Announces each RTP output stream on the well-known SAP group
(224.2.127.254:9875, RFC 2974) with an SDP body describing the multicast
session and its payload types, so SAP-aware players can discover streams.
"""
from __future__ import annotations

import socket
import struct
import time

__all__ = ["SAP_GROUP", "SAP_PORT", "build_sap", "build_sdp", "parse_sap", "SapAnnouncer"]

SAP_GROUP = "224.2.127.254"
SAP_PORT = 9875


def build_sdp(name: str, group: str, port: int, origin_ip: str,
              pts: list[tuple[int, str, int, int]], session_id: int | None = None,
              ttl: int = 1) -> str:
    """pts: [(payload_type, encoding_name, clock_rate, channels)]."""
    sid = session_id if session_id is not None else int(time.time())
    lines = [
        "v=0",
        f"o=radiod {sid} {sid} IN IP4 {origin_ip}",
        f"s={name}",
        f"c=IN IP4 {group}/{ttl}",
        "t=0 0",
        f"m=audio {port} RTP/AVP " + " ".join(str(pt) for pt, *_ in pts),
    ]
    for pt, enc, rate, ch in pts:
        lines.append(f"a=rtpmap:{pt} {enc}/{rate}/{ch}")
    return "\r\n".join(lines) + "\r\n"


def build_sap(sdp: str, origin_ip: str, msg_id: int = 0, deletion: bool = False) -> bytes:
    flags = 0x20 | (0x04 if deletion else 0)  # V=1, IPv4, announce/delete
    head = struct.pack(">BBH", flags, 0, msg_id & 0xFFFF)
    head += socket.inet_aton(origin_ip)
    head += b"application/sdp\0"
    return head + sdp.encode()


def parse_sap(pkt: bytes):
    """Returns (origin_ip, msg_id, deletion, sdp_text) or None."""
    if len(pkt) < 8 or (pkt[0] & 0xE0) != 0x20:
        return None
    auth_len = pkt[1]
    msg_id = struct.unpack(">H", pkt[2:4])[0]
    origin = socket.inet_ntoa(pkt[4:8])
    body = pkt[8 + auth_len * 4 :]
    if body.startswith(b"application/sdp\0"):
        body = body[len(b"application/sdp\0") :]
    elif b"\0" in body[:64]:
        body = body.split(b"\0", 1)[1]
    return origin, msg_id, bool(pkt[0] & 0x04), body.decode(errors="replace")


class SapAnnouncer:
    def __init__(self, ttl: int = 1):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, max(ttl, 1))
        self.sock.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        self.origin = self._local_ip()
        self.msg_id = int(time.time()) & 0xFFFF

    @staticmethod
    def _local_ip() -> str:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect((SAP_GROUP, SAP_PORT))
            return s.getsockname()[0]
        except OSError:
            return "127.0.0.1"
        finally:
            s.close()

    def announce(self, name: str, group: str, port: int, pts, ttl: int = 1):
        sdp = build_sdp(name, group, port, self.origin, pts, ttl=ttl)
        try:
            self.sock.sendto(build_sap(sdp, self.origin, self.msg_id), (SAP_GROUP, SAP_PORT))
        except OSError:
            pass

    def close(self):
        self.sock.close()
