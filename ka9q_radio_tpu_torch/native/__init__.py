"""Native (C++) host edge, loaded through ctypes: batched RTP egress
(sendmmsg), the at-rate RTP ingest ring (recvmmsg) and its paced sender
(ingest_blast). The library is built with the system g++ from this
package's copy of rtp_edge.cpp on first use, never on import, into
build/native/ at the root of the checkout. Every consumer has a
pure-Python fallback."""
from .edge import RtpEdge, RtpIngest, ingest_blast, native_available, native_has_opus

__all__ = ["RtpEdge", "RtpIngest", "ingest_blast", "native_available", "native_has_opus"]
