"""TLV status/command protocol codec — wire-compatible with ka9q-radio.

Implements the command/status encoding of docs/ka9q-api.md (reference
status.c/status.h): a packet is one type byte (STATUS=0 / CMD=1) followed
by TLV entries and a terminating EOL. Lengths 0-127 are one byte; longer
values set the high bit and give a length-of-length (ka9q-api.md:36-42).
Integers are MSB-first with leading zeros stripped (zero -> empty value);
float32/float64 are IEEE-754 big-endian (zero -> empty); strings UTF-8;
sockets are addr+port in network order (6 bytes IPv4, 18 IPv6, empty for
null); BIN_DATA is a vector of big-endian float32s.

The StatusType enum mirrors status.h:20-165 by VALUE — entries must never
be renumbered (the reference keeps wire compatibility the same way).
"""
from __future__ import annotations

import enum
import math
import socket
import struct
from typing import Any

__all__ = ["PacketType", "StatusType", "Kind", "encode_status", "decode_status", "encode_tlv", "dump_text"]


class PacketType(enum.IntEnum):
    STATUS = 0
    CMD = 1


class StatusType(enum.IntEnum):
    # mirrors /root/reference/src/status.h:20-165 — order IS the wire format
    EOL = 0
    COMMAND_TAG = 1
    CMD_CNT = 2
    GPS_TIME = 3
    DESCRIPTION = 4
    STATUS_DEST_SOCKET = 5
    SETOPTS = 6
    CLEAROPTS = 7
    RTP_TIMESNAP = 8
    BIN_BYTE_DATA = 9
    INPUT_SAMPRATE = 10
    SPECTRUM_BASE = 11
    SPECTRUM_AVG = 12
    INPUT_SAMPLES = 13
    WINDOW_TYPE = 14
    NOISE_BW = 15
    OUTPUT_DATA_SOURCE_SOCKET = 16
    OUTPUT_DATA_DEST_SOCKET = 17
    OUTPUT_SSRC = 18
    OUTPUT_TTL = 19
    OUTPUT_SAMPRATE = 20
    OUTPUT_METADATA_PACKETS = 21
    OUTPUT_DATA_PACKETS = 22
    OUTPUT_ERRORS = 23
    CALIBRATE = 24
    LNA_GAIN = 25
    MIXER_GAIN = 26
    IF_GAIN = 27
    DC_I_OFFSET = 28
    DC_Q_OFFSET = 29
    IQ_IMBALANCE = 30
    IQ_PHASE = 31
    DIRECT_CONVERSION = 32
    RADIO_FREQUENCY = 33
    FIRST_LO_FREQUENCY = 34
    SECOND_LO_FREQUENCY = 35
    SHIFT_FREQUENCY = 36
    DOPPLER_FREQUENCY = 37
    DOPPLER_FREQUENCY_RATE = 38
    LOW_EDGE = 39
    HIGH_EDGE = 40
    KAISER_BETA = 41
    FILTER_BLOCKSIZE = 42
    FILTER_FIR_LENGTH = 43
    FILTER2 = 44
    IF_POWER = 45
    BASEBAND_POWER = 46
    NOISE_DENSITY = 47
    DEMOD_TYPE = 48
    OUTPUT_CHANNELS = 49
    INDEPENDENT_SIDEBAND = 50
    PLL_ENABLE = 51
    PLL_LOCK = 52
    PLL_SQUARE = 53
    PLL_PHASE = 54
    PLL_BW = 55
    ENVELOPE = 56
    SNR_SQUELCH = 57
    PLL_SNR = 58
    FREQ_OFFSET = 59
    PEAK_DEVIATION = 60
    PL_TONE = 61
    AGC_ENABLE = 62
    HEADROOM = 63
    AGC_HANGTIME = 64
    AGC_RECOVERY_RATE = 65
    FM_SNR = 66
    AGC_THRESHOLD = 67
    GAIN = 68
    OUTPUT_LEVEL = 69
    OUTPUT_SAMPLES = 70
    OPUS_BIT_RATE = 71
    MAXDELAY = 72
    FILTER2_BLOCKSIZE = 73
    FILTER2_FIR_LENGTH = 74
    FILTER2_KAISER_BETA = 75
    SPECTRUM_FFT_N = 76
    FILTER_DROPS = 77
    LOCK = 78
    TP1 = 79
    TP2 = 80
    UNUSED4 = 81
    AD_BITS_PER_SAMPLE = 82
    SQUELCH_OPEN = 83
    SQUELCH_CLOSE = 84
    PRESET = 85
    DEEMPH_TC = 86
    DEEMPH_GAIN = 87
    UNUSED3 = 88
    PL_DEVIATION = 89
    THRESH_EXTEND = 90
    SPECTRUM_SHAPE = 91
    UNUSED2 = 92
    RESOLUTION_BW = 93
    BIN_COUNT = 94
    CROSSOVER = 95
    BIN_DATA = 96
    RF_ATTEN = 97
    RF_GAIN = 98
    RF_AGC = 99
    FE_LOW_EDGE = 100
    FE_HIGH_EDGE = 101
    FE_ISREAL = 102
    UNUSED = 103
    AD_OVER = 104
    RTP_PT = 105
    STATUS_INTERVAL = 106
    OUTPUT_ENCODING = 107
    SAMPLES_SINCE_OVER = 108
    PLL_WRAPS = 109
    RF_LEVEL_CAL = 110
    OPUS_DTX = 111
    OPUS_APPLICATION = 112
    OPUS_BANDWIDTH = 113
    OPUS_FEC = 114
    SPECTRUM_STEP = 115
    SPECTRUM_OVERLAP = 116
    LIFETIME = 117
    # ---- private extensions (above upstream's last assigned key, 117;
    # TLV readers skip unknown keys, so stock clients are unaffected)
    BIN_RICE_DATA = 125  # Rice-coded spectrum levels (net/rice.py)


class Kind(enum.Enum):
    INT = "int"
    FLOAT = "float"  # f32 on the wire
    DOUBLE = "double"  # f64 on the wire
    STRING = "string"
    SOCKET = "socket"
    VECTOR = "vector"  # float32 list (BIN_DATA)
    BYTES = "bytes"  # raw (BIN_BYTE_DATA)


_T = StatusType
# wire data type of each key (from the encode_* calls in radio_status.c/dump.c)
KINDS: dict[StatusType, Kind] = {
    _T.COMMAND_TAG: Kind.INT, _T.CMD_CNT: Kind.INT, _T.GPS_TIME: Kind.INT,
    _T.DESCRIPTION: Kind.STRING, _T.STATUS_DEST_SOCKET: Kind.SOCKET,
    _T.SETOPTS: Kind.INT, _T.CLEAROPTS: Kind.INT, _T.RTP_TIMESNAP: Kind.INT,
    _T.BIN_BYTE_DATA: Kind.BYTES, _T.BIN_RICE_DATA: Kind.BYTES,
    _T.INPUT_SAMPRATE: Kind.INT,
    _T.SPECTRUM_BASE: Kind.FLOAT, _T.SPECTRUM_AVG: Kind.INT,
    _T.INPUT_SAMPLES: Kind.INT, _T.WINDOW_TYPE: Kind.INT, _T.NOISE_BW: Kind.FLOAT,
    _T.OUTPUT_DATA_SOURCE_SOCKET: Kind.SOCKET, _T.OUTPUT_DATA_DEST_SOCKET: Kind.SOCKET,
    _T.OUTPUT_SSRC: Kind.INT, _T.OUTPUT_TTL: Kind.INT, _T.OUTPUT_SAMPRATE: Kind.INT,
    _T.OUTPUT_METADATA_PACKETS: Kind.INT, _T.OUTPUT_DATA_PACKETS: Kind.INT,
    _T.OUTPUT_ERRORS: Kind.INT, _T.CALIBRATE: Kind.DOUBLE,
    _T.LNA_GAIN: Kind.INT, _T.MIXER_GAIN: Kind.INT, _T.IF_GAIN: Kind.INT,
    _T.DC_I_OFFSET: Kind.FLOAT, _T.DC_Q_OFFSET: Kind.FLOAT,
    _T.IQ_IMBALANCE: Kind.FLOAT, _T.IQ_PHASE: Kind.FLOAT,
    _T.DIRECT_CONVERSION: Kind.INT,
    _T.RADIO_FREQUENCY: Kind.DOUBLE, _T.FIRST_LO_FREQUENCY: Kind.DOUBLE,
    _T.SECOND_LO_FREQUENCY: Kind.DOUBLE, _T.SHIFT_FREQUENCY: Kind.DOUBLE,
    _T.DOPPLER_FREQUENCY: Kind.DOUBLE, _T.DOPPLER_FREQUENCY_RATE: Kind.DOUBLE,
    _T.LOW_EDGE: Kind.FLOAT, _T.HIGH_EDGE: Kind.FLOAT, _T.KAISER_BETA: Kind.FLOAT,
    _T.FILTER_BLOCKSIZE: Kind.INT, _T.FILTER_FIR_LENGTH: Kind.INT, _T.FILTER2: Kind.INT,
    _T.IF_POWER: Kind.FLOAT, _T.BASEBAND_POWER: Kind.FLOAT, _T.NOISE_DENSITY: Kind.FLOAT,
    _T.DEMOD_TYPE: Kind.INT, _T.OUTPUT_CHANNELS: Kind.INT,
    _T.INDEPENDENT_SIDEBAND: Kind.INT, _T.PLL_ENABLE: Kind.INT, _T.PLL_LOCK: Kind.INT,
    _T.PLL_SQUARE: Kind.INT, _T.PLL_PHASE: Kind.FLOAT, _T.PLL_BW: Kind.FLOAT,
    _T.ENVELOPE: Kind.INT, _T.SNR_SQUELCH: Kind.INT,
    _T.PLL_SNR: Kind.FLOAT, _T.FREQ_OFFSET: Kind.FLOAT, _T.PEAK_DEVIATION: Kind.FLOAT,
    _T.PL_TONE: Kind.FLOAT,
    _T.AGC_ENABLE: Kind.INT, _T.HEADROOM: Kind.FLOAT, _T.AGC_HANGTIME: Kind.FLOAT,
    _T.AGC_RECOVERY_RATE: Kind.FLOAT, _T.FM_SNR: Kind.FLOAT, _T.AGC_THRESHOLD: Kind.FLOAT,
    _T.GAIN: Kind.FLOAT, _T.OUTPUT_LEVEL: Kind.FLOAT, _T.OUTPUT_SAMPLES: Kind.INT,
    _T.OPUS_BIT_RATE: Kind.INT, _T.MAXDELAY: Kind.INT,
    _T.FILTER2_BLOCKSIZE: Kind.INT, _T.FILTER2_FIR_LENGTH: Kind.INT,
    _T.FILTER2_KAISER_BETA: Kind.FLOAT, _T.SPECTRUM_FFT_N: Kind.INT,
    _T.FILTER_DROPS: Kind.INT, _T.LOCK: Kind.INT, _T.TP1: Kind.FLOAT, _T.TP2: Kind.FLOAT,
    _T.AD_BITS_PER_SAMPLE: Kind.INT,
    _T.SQUELCH_OPEN: Kind.FLOAT, _T.SQUELCH_CLOSE: Kind.FLOAT, _T.PRESET: Kind.STRING,
    _T.DEEMPH_TC: Kind.FLOAT, _T.DEEMPH_GAIN: Kind.FLOAT, _T.PL_DEVIATION: Kind.FLOAT,
    _T.THRESH_EXTEND: Kind.INT,
    _T.SPECTRUM_SHAPE: Kind.FLOAT, _T.RESOLUTION_BW: Kind.FLOAT, _T.BIN_COUNT: Kind.INT,
    _T.CROSSOVER: Kind.FLOAT, _T.BIN_DATA: Kind.VECTOR,
    _T.RF_ATTEN: Kind.FLOAT, _T.RF_GAIN: Kind.FLOAT, _T.RF_AGC: Kind.INT,
    _T.FE_LOW_EDGE: Kind.FLOAT, _T.FE_HIGH_EDGE: Kind.FLOAT, _T.FE_ISREAL: Kind.INT,
    _T.AD_OVER: Kind.INT, _T.RTP_PT: Kind.INT, _T.STATUS_INTERVAL: Kind.INT,
    _T.OUTPUT_ENCODING: Kind.INT, _T.SAMPLES_SINCE_OVER: Kind.INT,
    _T.PLL_WRAPS: Kind.INT, _T.RF_LEVEL_CAL: Kind.FLOAT,
    _T.OPUS_DTX: Kind.INT, _T.OPUS_APPLICATION: Kind.INT, _T.OPUS_BANDWIDTH: Kind.INT,
    _T.OPUS_FEC: Kind.INT, _T.SPECTRUM_STEP: Kind.FLOAT, _T.SPECTRUM_OVERLAP: Kind.FLOAT,
    _T.LIFETIME: Kind.INT,
}


def _encode_length(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    body = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([0x80 | len(body)]) + body


def _int_value(x: int) -> bytes:
    if x == 0:
        return b""
    if x < 0:  # ka9q ints are unsigned on the wire; clamp like the C casts
        x &= (1 << 64) - 1
    return x.to_bytes((x.bit_length() + 7) // 8, "big")


def _value_bytes(kind: Kind, value: Any) -> bytes:
    if kind == Kind.INT:
        return _int_value(int(value))
    if kind == Kind.FLOAT:
        v = float(value)
        if v == 0.0 and not math.copysign(1.0, v) < 0:
            return b""
        return struct.pack(">f", v)
    if kind == Kind.DOUBLE:
        v = float(value)
        if v == 0.0 and not math.copysign(1.0, v) < 0:
            return b""
        return struct.pack(">d", v)
    if kind == Kind.STRING:
        return str(value).encode("utf-8")
    if kind == Kind.SOCKET:
        host, port = value
        try:
            addr = socket.inet_pton(socket.AF_INET, host)
        except OSError:
            addr = socket.inet_pton(socket.AF_INET6, host)
        return addr + struct.pack(">H", port)
    if kind == Kind.VECTOR:
        return b"".join(struct.pack(">f", float(v)) for v in value)
    if kind == Kind.BYTES:
        return bytes(value)
    raise ValueError(kind)


def encode_tlv(t: StatusType, value: Any, kind: Kind | None = None) -> bytes:
    kind = kind or KINDS.get(t, Kind.INT)
    if isinstance(value, bool):
        value = int(value)
    body = _value_bytes(kind, value)
    return bytes([int(t)]) + _encode_length(len(body)) + body


def encode_status(fields: dict[StatusType, Any], cmd: bool = False) -> bytes:
    """Build one status/command packet. fields preserve insertion order;
    put OUTPUT_SSRC / COMMAND_TAG first like the reference recommends."""
    out = bytearray([PacketType.CMD if cmd else PacketType.STATUS])
    for t, v in fields.items():
        out += encode_tlv(StatusType(t), v)
    out.append(int(StatusType.EOL))
    return bytes(out)


def _decode_value(kind: Kind, raw: bytes) -> Any:
    if len(raw) == 0:
        if kind in (Kind.INT,):
            return 0
        if kind in (Kind.FLOAT, Kind.DOUBLE):
            return 0.0
        if kind == Kind.STRING:
            return ""
        if kind == Kind.SOCKET:
            return None
        if kind == Kind.VECTOR:
            return []
        return b""
    if kind == Kind.INT:
        return int.from_bytes(raw, "big")
    if kind == Kind.FLOAT:
        # tolerate shortened floats like the reference's decode_float
        return struct.unpack(">f", raw.rjust(4, b"\0"))[0] if len(raw) <= 4 else struct.unpack(">d", raw)[0]
    if kind == Kind.DOUBLE:
        return struct.unpack(">d", raw.rjust(8, b"\0"))[0] if len(raw) != 4 else struct.unpack(">f", raw)[0]
    if kind == Kind.STRING:
        return raw.decode("utf-8", errors="replace")
    if kind == Kind.SOCKET:
        if len(raw) == 6:
            return (socket.inet_ntop(socket.AF_INET, raw[:4]), struct.unpack(">H", raw[4:])[0])
        if len(raw) == 18:
            return (socket.inet_ntop(socket.AF_INET6, raw[:16]), struct.unpack(">H", raw[16:])[0])
        return None
    if kind == Kind.VECTOR:
        return list(struct.unpack(f">{len(raw) // 4}f", raw[: len(raw) // 4 * 4]))
    return raw


def decode_status(pkt: bytes) -> tuple[PacketType, dict[StatusType, Any], dict[int, bytes]]:
    """Parse a packet. Returns (pkt_type, typed fields, unknown raw TLVs)."""
    if not pkt:
        raise ValueError("empty packet")
    ptype = PacketType(pkt[0])
    i = 1
    fields: dict[StatusType, Any] = {}
    unknown: dict[int, bytes] = {}
    n = len(pkt)
    while i < n:
        t = pkt[i]
        i += 1
        if t == StatusType.EOL:
            break
        if i >= n:
            break
        ln = pkt[i]
        i += 1
        if ln & 0x80:
            nlen = ln & 0x7F
            ln = int.from_bytes(pkt[i : i + nlen], "big")
            i += nlen
        raw = pkt[i : i + ln]
        i += ln
        try:
            st = StatusType(t)
        except ValueError:
            unknown[t] = raw
            continue
        fields[st] = _decode_value(KINDS.get(st, Kind.BYTES), raw)
    return ptype, fields, unknown


def dump_text(pkt: bytes) -> str:
    """Human-readable packet dump (the metadump client's core)."""
    ptype, fields, unknown = decode_status(pkt)
    lines = [f"[{ptype.name}]"]
    for t, v in fields.items():
        lines.append(f"  {t.name} = {v!r}")
    for t, raw in unknown.items():
        lines.append(f"  unknown({t}) = {raw.hex()}")
    return "\n".join(lines)
