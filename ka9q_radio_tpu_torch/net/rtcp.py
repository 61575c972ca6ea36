"""RTCP sender reports / source description / bye (rtcp.c).

radiod emits SR+SDES compound packets on the RTCP port (data port + 1,
rtp.h:7-10) so stock RTP tools can track stream clocks and names.
"""
from __future__ import annotations

import struct
import time

__all__ = ["ntp_timestamp", "build_sr", "build_sdes", "build_bye", "compound", "parse_rtcp"]

_NTP_EPOCH_DELTA = 2208988800  # 1900 -> 1970


def ntp_timestamp(t: float | None = None) -> tuple[int, int]:
    t = time.time() if t is None else t
    sec = int(t) + _NTP_EPOCH_DELTA
    frac = int((t - int(t)) * (1 << 32))
    return sec & 0xFFFFFFFF, frac & 0xFFFFFFFF


def _hdr(pt: int, count: int, length_words: int) -> bytes:
    return struct.pack(">BBH", 0x80 | (count & 0x1F), pt, length_words)


def build_sr(ssrc: int, rtp_timestamp: int, packets: int, octets: int,
             when: float | None = None) -> bytes:
    """Sender report, no reception blocks (rtcp.c gen_sr)."""
    sec, frac = ntp_timestamp(when)
    body = struct.pack(">IIIIII", ssrc & 0xFFFFFFFF, sec, frac,
                       rtp_timestamp & 0xFFFFFFFF, packets & 0xFFFFFFFF,
                       octets & 0xFFFFFFFF)
    return _hdr(200, 0, len(body) // 4) + body


def build_sdes(ssrc: int, cname: str) -> bytes:
    item = cname.encode()[:255]
    chunk = struct.pack(">I", ssrc & 0xFFFFFFFF) + bytes([1, len(item)]) + item + b"\0"
    pad = (-len(chunk)) % 4
    chunk += b"\0" * pad
    return _hdr(202, 1, len(chunk) // 4) + chunk


def build_bye(ssrcs: list[int]) -> bytes:
    body = b"".join(struct.pack(">I", s & 0xFFFFFFFF) for s in ssrcs)
    return _hdr(203, len(ssrcs), len(body) // 4) + body


def compound(*pkts: bytes) -> bytes:
    return b"".join(pkts)


def parse_rtcp(data: bytes):
    """Minimal parser -> list of (pt, dict) for SR/SDES/BYE."""
    out = []
    i = 0
    while i + 4 <= len(data):
        b0, pt, length = data[i], data[i + 1], struct.unpack(">H", data[i + 2 : i + 4])[0]
        count = b0 & 0x1F
        seg = data[i + 4 : i + 4 + 4 * length]
        i += 4 + 4 * length
        if pt == 200 and len(seg) >= 24:
            ssrc, sec, frac, rtpts, pkts, octs = struct.unpack(">IIIIII", seg[:24])
            out.append((200, dict(ssrc=ssrc, ntp_sec=sec, ntp_frac=frac,
                                  rtp_timestamp=rtpts, packets=pkts, octets=octs)))
        elif pt == 202 and len(seg) >= 6:
            ssrc = struct.unpack(">I", seg[:4])[0]
            items = {}
            j = 4
            while j + 2 <= len(seg) and seg[j] != 0:
                t, ln = seg[j], seg[j + 1]
                items[t] = seg[j + 2 : j + 2 + ln].decode(errors="replace")
                j += 2 + ln
            out.append((202, dict(ssrc=ssrc, items=items)))
        elif pt == 203:
            ssrcs = [struct.unpack(">I", seg[k : k + 4])[0] for k in range(0, 4 * count, 4)]
            out.append((203, dict(ssrcs=ssrcs)))
        else:
            out.append((pt, dict(raw=seg)))
    return out
