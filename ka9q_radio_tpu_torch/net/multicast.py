"""Multicast addressing and socket setup (multicast.c).

Implements the reference's deterministic name -> 239.x.x.x group hashing
(FNV-1, multicast.c:839-852) so stream names resolve to the same multicast
groups as a stock radiod, plus output/listen socket helpers. In containers
without multicast routing, names of the form "host:port" or plain IPs are
honored directly and loopback TTL=0 operation works like the reference's
(radio.c:483-487).
"""
from __future__ import annotations

import socket
import struct

__all__ = ["fnv1hash", "make_maddr", "resolve_dest", "output_socket",
           "output_socket_unconnected", "listen_socket",
           "DEFAULT_RTP_PORT", "DEFAULT_STAT_PORT"]

DEFAULT_RTP_PORT = 5004
DEFAULT_RTCP_PORT = 5005
DEFAULT_STAT_PORT = 5006


def fnv1hash(data: bytes) -> int:
    h = 0x811C9DC5
    for b in data:
        h = (h * 0x01000193) & 0xFFFFFFFF
        h ^= b
    return h


def make_maddr(name: str) -> str:
    """Deterministic stream-name -> 239.x.x.x group (multicast.c:839-852)."""
    if not name:
        return "0.0.0.0"
    addr = (239 << 24) | (fnv1hash(name.encode()) & 0xFFFFFF)
    if (addr & 0x007FFF00) == 0:
        addr |= (addr & 0xFF) << 8
    if (addr & 0x007FFF00) == 0:
        addr |= 0x00100000
    return socket.inet_ntoa(struct.pack(">I", addr))


def _is_ip(s: str) -> bool:
    try:
        socket.inet_aton(s)
        return True
    except OSError:
        return False


def resolve_dest(name: str, default_port: int, use_dns: bool = False) -> tuple[str, int]:
    """Stream name -> (ip, port). 'a.b.c.d:p' and bare IPs pass through;
    anything else hashes like the reference (so 'test-pcm.local' lands on
    the same group a stock radiod would advertise). `dns = yes` tries a
    real lookup first, falling back to the hash (radio.c:739-742)."""
    name = name.strip()
    port = default_port
    if ":" in name:
        name, _, p = name.rpartition(":")
        port = int(p)
    if _is_ip(name):
        return name, port
    if use_dns:
        try:
            infos = socket.getaddrinfo(name, port, socket.AF_INET, socket.SOCK_DGRAM)
            if infos:
                return infos[0][4][0], port
        except OSError:
            pass
    return make_maddr(name), port




def _set_output_iface(s: socket.socket, iface: "str | None"):
    """IP_MULTICAST_IF from an interface name or address (the `iface =`
    key / -A flags; multicast.c:185-196 uses struct ip_mreqn)."""
    if not iface:
        return
    import struct as _struct
    addr, ifindex = "0.0.0.0", 0
    try:
        socket.inet_aton(iface)
        addr = iface
    except OSError:
        try:
            ifindex = socket.if_nametoindex(iface)
        except OSError:
            return
    try:
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                     _struct.pack("=4s4si", socket.inet_aton("0.0.0.0"),
                                  socket.inet_aton(addr), ifindex))
    except OSError:
        pass

def output_socket(dest: tuple[str, int], ttl: int = 1, tos: int = 46 << 2,
                  iface: "str | None" = None) -> socket.socket:
    """UDP sender socket, multicast-ready (mcast TTL/loopback, DSCP EF
    default like radio.c:60; `tos =` / `iface =` config overrides)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, tos)
    except OSError:
        pass
    ip = dest[0]
    if ip.startswith("2") and int(ip.split(".")[0]) >= 224:
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, max(ttl, 0))
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        _set_output_iface(s, iface)
    s.connect(dest)
    return s


def output_socket_unconnected(dest: tuple[str, int], ttl: int = 1, tos: int = 46 << 2,
                              iface: "str | None" = None) -> socket.socket:
    """Like output_socket but UNCONNECTED (sendto per packet): one socket
    — hence ONE source port — can feed both the RTP port and the status
    port of a group. Stock ka9q clients (pcmrecord.c process_status:
    "Assumes same IP source address *and UDP source port* for status and
    data") match sessions on that source port, like the reference's
    single shared Output_fd."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.setsockopt(socket.IPPROTO_IP, socket.IP_TOS, tos)
    except OSError:
        pass
    ip = dest[0]
    if ip.startswith("2") and int(ip.split(".")[0]) >= 224:
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, max(ttl, 0))
        s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 1)
        _set_output_iface(s, iface)
    return s


def listen_socket(dest: tuple[str, int]) -> socket.socket:
    """UDP receive socket; joins the group for multicast addresses."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    ip, port = dest
    first_octet = int(ip.split(".")[0])
    if 224 <= first_octet <= 239:
        # bind the GROUP address, not INADDR_ANY: an any-bound socket would
        # receive datagrams for every group any socket on this host joined
        # on this port (classic Linux multicast gotcha)
        try:
            s.bind((ip, port))
        except OSError:
            s.bind(("", port))
        mreq = socket.inet_aton(ip) + socket.inet_aton("0.0.0.0")
        try:
            s.setsockopt(socket.IPPROTO_IP, socket.IP_ADD_MEMBERSHIP, mreq)
        except OSError:
            pass  # no multicast routing in this container; loopback still works
    else:
        s.bind((ip, port))
    s.setblocking(False)
    return s
