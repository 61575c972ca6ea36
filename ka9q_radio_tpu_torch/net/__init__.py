"""The port's own copy of the host-edge wire protocols: TLV status and
commands, RTP framing, multicast, RTCP, SAP, mDNS, Opus and the Rice-coded
spectrum. The bytes on the wire are the JAX package's, byte for byte, so
stock ka9q-radio clients talk to either daemon."""
from .status import StatusType, PacketType, encode_status, decode_status
from .rtp import RtpHeader, Encoding, PayloadRegistry

__all__ = ["StatusType", "PacketType", "encode_status", "decode_status", "RtpHeader",
           "Encoding", "PayloadRegistry"]
