"""RTP framing, payload-type registry, and PCM encodings (rtp.c/rtp.h).

Wire-compatible with the reference so monitor/pcmrecord can consume our
streams: the same static payload-type assignments (0=mu-law, 8=A-law,
10/11=44.1k S16BE) and the same dynamic allocation policy (types 77-127,
skipping 100, first-fit; rtp.c:272-301), and the same sample encodings
(rtp.h:26-40). Opus packets are produced by the host edge when libopus is
importable (gated — the baked environment may not ship it).
"""
from __future__ import annotations

import dataclasses
import enum
import struct

import numpy as np

__all__ = ["Encoding", "RtpHeader", "PayloadRegistry", "RtpState", "encode_samples", "decode_samples", "OPUS_SAMPRATE"]

OPUS_SAMPRATE = 48_000


class Encoding(enum.IntEnum):
    NO_ENCODING = 0
    S16LE = 1
    S16BE = 2
    OPUS = 3
    F32LE = 4
    AX25 = 5
    F16LE = 6
    OPUS_VOIP = 7
    F32BE = 8
    F16BE = 9
    MULAW = 10
    ALAW = 11


@dataclasses.dataclass
class RtpHeader:
    """Internal representation; pack()/unpack() handle the wire format
    (rtp.c ntoh_rtp/hton_rtp, byte-order independent)."""

    type: int = 0
    seq: int = 0
    timestamp: int = 0
    ssrc: int = 0
    marker: bool = False
    pad: bool = False
    extension: bool = False
    version: int = 2
    csrc: tuple = ()

    def pack(self) -> bytes:
        w = (
            (self.version & 3) << 30
            | (1 if self.pad else 0) << 29
            | (1 if self.extension else 0) << 28
            | (len(self.csrc) & 0xF) << 24
            | (1 if self.marker else 0) << 23
            | (self.type & 0x7F) << 16
            | (self.seq & 0xFFFF)
        )
        out = struct.pack(">III", w, self.timestamp & 0xFFFFFFFF, self.ssrc & 0xFFFFFFFF)
        for c in self.csrc:
            out += struct.pack(">I", c & 0xFFFFFFFF)
        return out

    @classmethod
    def unpack(cls, data: bytes) -> tuple["RtpHeader", bytes]:
        (w, ts, ssrc) = struct.unpack(">III", data[:12])
        h = cls(
            version=w >> 30,
            pad=bool((w >> 29) & 1),
            extension=bool((w >> 28) & 1),
            marker=bool((w >> 23) & 1),
            type=(w >> 16) & 0x7F,
            seq=w & 0xFFFF,
            timestamp=ts,
            ssrc=ssrc,
        )
        off = 12
        cc = (w >> 24) & 0xF
        h.csrc = struct.unpack(f">{cc}I", data[off : off + 4 * cc]) if cc else ()
        off += 4 * cc
        if h.extension:
            (ext,) = struct.unpack(">I", data[off : off + 4])
            off += 4 + 4 * (ext & 0xFFFF)
        return h, data[off:]


class PayloadRegistry:
    """(samprate, channels, encoding) <-> payload type (rtp.c:15-40,272-301)."""

    def __init__(self):
        # static entries + the reference's pre-registered dynamic PTs
        # (rtp.c:15-143) so both sides hand out identical numbers for the
        # common formats — stock clients see familiar payload types
        self.table: dict[int, tuple[int, int, Encoding]] = {
            0: (8000, 1, Encoding.MULAW),
            8: (8000, 1, Encoding.ALAW),
            10: (44100, 2, Encoding.S16BE),
            11: (44100, 1, Encoding.S16BE),
            111: (48000, 2, Encoding.OPUS),
            112: (48000, 1, Encoding.S16BE),
            113: (48000, 2, Encoding.S16BE),
            116: (24000, 1, Encoding.S16BE),
            117: (24000, 2, Encoding.S16BE),
            119: (16000, 1, Encoding.S16BE),
            120: (16000, 2, Encoding.S16BE),
            122: (12000, 1, Encoding.S16BE),
            123: (12000, 2, Encoding.S16BE),
            125: (8000, 1, Encoding.S16BE),
            126: (8000, 2, Encoding.S16BE),
        }

    def pt_from_info(self, samprate: int, channels: int, encoding: Encoding) -> int:
        if samprate <= 0 or channels <= 0 or channels > 2 or encoding == Encoding.NO_ENCODING:
            return -1
        if encoding in (Encoding.OPUS, Encoding.OPUS_VOIP):
            samprate, channels = OPUS_SAMPRATE, 2
            encoding = Encoding.OPUS
        want = (samprate, channels, encoding)
        for pt, info in self.table.items():
            if info == want:
                return pt
        for pt in range(77, 128):
            if pt == 100:  # de-facto RTP Event type (rtp.c:289-291)
                continue
            if pt not in self.table:
                self.table[pt] = want
                return pt
        return -1

    def info_from_pt(self, pt: int):
        return self.table.get(pt)


@dataclasses.dataclass
class RtpState:
    """Sender/receiver sequence state with drop/dup accounting (rtp.c)."""

    ssrc: int = 0
    seq: int = 0
    timestamp: int = 0
    init: bool = False
    packets: int = 0
    bytes: int = 0
    drops: int = 0
    dupes: int = 0

    def process(self, h: RtpHeader, samples: int) -> int:
        """Receiver side: returns samples skipped (gap) or <0 for dup/old."""
        if not self.init:
            self.ssrc, self.seq, self.timestamp, self.init = h.ssrc, h.seq, h.timestamp, True
        self.packets += 1
        seq_diff = (h.seq - self.seq) & 0xFFFF
        if seq_diff >= 0x8000:  # old/duplicate
            self.dupes += 1
            return -1
        skipped = ((h.timestamp - self.timestamp) & 0xFFFFFFFF) if seq_diff else 0
        if seq_diff:
            self.drops += seq_diff
        self.seq = (h.seq + 1) & 0xFFFF
        self.timestamp = (h.timestamp + samples) & 0xFFFFFFFF
        return int(skipped)


# ---------------------------------------------------------------------------
# Sample encodings (audio.c:116-172 output path, rtp.h:26-40)
# ---------------------------------------------------------------------------

def _mulaw(x: np.ndarray) -> np.ndarray:
    """G.711 mu-law compress (classic bias-132 algorithm)."""
    BIAS, CLIP = 0x84, 32635
    s = np.clip(x * 32767.0, -CLIP, CLIP).astype(np.int32)
    sign = np.where(s < 0, 0x80, 0)
    mag = np.abs(s) + BIAS
    exp = (np.floor(np.log2(mag)).astype(np.int32) - 7).clip(0, 7)
    mant = (mag >> (exp + 3)) & 0x0F
    return (~(sign | (exp << 4) | mant)).astype(np.uint8)


def _alaw(x: np.ndarray) -> np.ndarray:
    """G.711 A-law compress (even-bit-inverted wire format)."""
    s = np.clip(x * 32767.0, -32635, 32635).astype(np.int32)
    sign = np.where(s < 0, 0x80, 0)
    pcm = np.abs(s)
    exp = np.where(pcm > 0, (np.floor(np.log2(np.maximum(pcm, 1))).astype(np.int32) - 7), 0).clip(0, 7)
    mant = np.where(exp == 0, pcm >> 4, pcm >> (exp + 3)) & 0x0F
    return ((sign | (exp << 4) | mant) ^ 0xD5).astype(np.uint8)


def encode_samples(audio: np.ndarray, encoding: Encoding) -> bytes:
    """float32 [-1,1] (interleaved if stereo) -> wire bytes."""
    a = np.asarray(audio, np.float32).reshape(-1)
    if encoding == Encoding.S16BE:
        return np.rint(np.clip(a * 32767.0, -32768, 32767)).astype(">i2").tobytes()
    if encoding == Encoding.S16LE:
        return np.rint(np.clip(a * 32767.0, -32768, 32767)).astype("<i2").tobytes()
    if encoding == Encoding.F32BE:
        return a.astype(">f4").tobytes()
    if encoding == Encoding.F32LE:
        return a.astype("<f4").tobytes()
    if encoding == Encoding.F16BE:
        return a.astype(">f2").tobytes()
    if encoding == Encoding.F16LE:
        return a.astype("<f2").tobytes()
    if encoding == Encoding.MULAW:
        return _mulaw(a).tobytes()
    if encoding == Encoding.ALAW:
        return _alaw(a).tobytes()
    raise ValueError(f"unsupported encoding {encoding}")


_MULAW_DEC = None
_ALAW_DEC = None


def _mulaw_table() -> np.ndarray:
    global _MULAW_DEC
    if _MULAW_DEC is None:
        u = ~np.arange(256, dtype=np.uint8)
        sign = (u & 0x80) != 0
        exp = ((u >> 4) & 7).astype(np.int32)
        mant = (u & 0x0F).astype(np.int32)
        mag = (((mant << 3) + 0x84) << exp) - 0x84
        _MULAW_DEC = np.where(sign, -mag, mag).astype(np.float32) / 32767.0
    return _MULAW_DEC


def _alaw_table() -> np.ndarray:
    global _ALAW_DEC
    if _ALAW_DEC is None:
        a = np.arange(256, dtype=np.int32) ^ 0xD5
        sign = (a & 0x80) != 0
        exp = (a >> 4) & 7
        mant = a & 0x0F
        mag = np.where(exp > 0, ((mant << 4) + 0x108) << np.maximum(exp - 1, 0), (mant << 4) + 8)
        _ALAW_DEC = np.where(sign, -mag, mag).astype(np.float32) / 32767.0
    return _ALAW_DEC


def decode_samples(data: bytes, encoding: Encoding) -> np.ndarray:
    if encoding == Encoding.S16BE:
        return np.frombuffer(data, ">i2").astype(np.float32) / 32767.0
    if encoding == Encoding.S16LE:
        return np.frombuffer(data, "<i2").astype(np.float32) / 32767.0
    if encoding == Encoding.F32BE:
        return np.frombuffer(data, ">f4").astype(np.float32)
    if encoding == Encoding.F32LE:
        return np.frombuffer(data, "<f4").astype(np.float32)
    if encoding == Encoding.F16BE:
        return np.frombuffer(data, ">f2").astype(np.float32)
    if encoding == Encoding.F16LE:
        return np.frombuffer(data, "<f2").astype(np.float32)
    if encoding == Encoding.MULAW:
        return _mulaw_table()[np.frombuffer(data, np.uint8)]
    if encoding == Encoding.ALAW:
        return _alaw_table()[np.frombuffer(data, np.uint8)]
    raise ValueError(f"unsupported encoding {encoding}")
