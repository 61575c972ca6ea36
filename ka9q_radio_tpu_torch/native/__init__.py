"""Native (C++) host edge, loaded through ctypes: batched RTP egress
(sendmmsg) and the at-rate RTP ingest ring (recvmmsg). The library is built
with the system g++ from this package's copy of rtp_edge.cpp on first use,
never on import, into build/native/ at the root of the checkout. Every
consumer has a pure-Python fallback."""
from .edge import RtpEdge, RtpIngest, native_available, native_has_opus

__all__ = ["RtpEdge", "RtpIngest", "native_available", "native_has_opus"]
