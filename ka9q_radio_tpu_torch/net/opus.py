"""Opus codec via ctypes on the system libopus (gated — no pip installs).

Gives the host edge the reference's in-radiod Opus output (audio.c Opus
branch, OPUS_* status keys) and the monitor's decode-with-PLC path
(monitor-data.c:525-633). Opus streams are always 48 kHz (OPUS_SAMPRATE,
rtp.h:18); stereo on the wire, and frame sizes must be one of the legal
2.5/5/10/20/40/60/80/100/120 ms durations.
"""
from __future__ import annotations

import ctypes
import ctypes.util

import numpy as np

__all__ = ["available", "OpusEncoder", "OpusDecoder", "OPUS_APPLICATION_AUDIO",
           "OPUS_APPLICATION_VOIP", "LEGAL_FRAME_MS"]

OPUS_APPLICATION_VOIP = 2048
OPUS_APPLICATION_AUDIO = 2049
OPUS_SET_BITRATE = 4002
OPUS_SET_DTX = 4016
OPUS_SET_BANDWIDTH = 4008
OPUS_SET_INBAND_FEC = 4012
OPUS_SET_PACKET_LOSS_PERC = 4014
OPUS_AUTO = -1000

LEGAL_FRAME_MS = (2.5, 5.0, 10.0, 20.0, 40.0, 60.0, 80.0, 100.0, 120.0)

_lib = None


def _load():
    global _lib
    if _lib is None:
        name = ctypes.util.find_library("opus")
        if name is None:
            raise OSError("libopus not found")
        _lib = ctypes.CDLL(name)
        _lib.opus_encoder_create.restype = ctypes.c_void_p
        _lib.opus_decoder_create.restype = ctypes.c_void_p
        _lib.opus_encode_float.restype = ctypes.c_int32
        _lib.opus_decode_float.restype = ctypes.c_int32
    return _lib


def available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


class OpusEncoder:
    def __init__(self, samprate: int = 48_000, channels: int = 2,
                 application: int = OPUS_APPLICATION_AUDIO, bitrate: int = 0,
                 dtx: bool = False, fec_pct: int = 0):
        lib = _load()
        err = ctypes.c_int(0)
        self.channels = channels
        self.samprate = samprate
        self._enc = lib.opus_encoder_create(samprate, channels, application, ctypes.byref(err))
        if err.value != 0:
            raise OSError(f"opus_encoder_create: {err.value}")
        if bitrate:
            lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_SET_BITRATE, ctypes.c_int32(bitrate))
        if dtx:
            lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_SET_DTX, ctypes.c_int32(1))
        if fec_pct:
            lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_SET_INBAND_FEC, ctypes.c_int32(1))
            lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), OPUS_SET_PACKET_LOSS_PERC, ctypes.c_int32(fec_pct))

    def bandwidth(self) -> int:
        """Current encoder audio bandwidth (OPUS_GET_BANDWIDTH ctl) — the
        reference emits it in status (radio_status.c OPUS_BANDWIDTH)."""
        lib = _load()
        bw = ctypes.c_int32(0)
        lib.opus_encoder_ctl(ctypes.c_void_p(self._enc), 4009, ctypes.byref(bw))
        return int(bw.value)

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm: float32 [frames, channels] (or [frames] mono upmixed)."""
        lib = _load()
        x = np.asarray(pcm, np.float32)
        if x.ndim == 1:
            x = np.stack([x] * self.channels, axis=-1) if self.channels > 1 else x[:, None]
        frames = x.shape[0]
        buf = ctypes.create_string_buffer(4000)
        n = lib.opus_encode_float(
            ctypes.c_void_p(self._enc),
            np.ascontiguousarray(x).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(frames), buf, ctypes.c_int32(len(buf)),
        )
        if n < 0:
            raise OSError(f"opus_encode_float: {n}")
        return buf.raw[:n]

    def __del__(self):
        try:
            _load().opus_encoder_destroy(ctypes.c_void_p(self._enc))
        except Exception:
            pass


class OpusDecoder:
    def __init__(self, samprate: int = 48_000, channels: int = 2):
        lib = _load()
        err = ctypes.c_int(0)
        self.channels = channels
        self.samprate = samprate
        self._dec = lib.opus_decoder_create(samprate, channels, ctypes.byref(err))
        if err.value != 0:
            raise OSError(f"opus_decoder_create: {err.value}")

    def decode(self, data: bytes | None, frames: int = 5760) -> np.ndarray:
        """Decode one packet -> float32 [frames, channels]. data=None runs
        packet-loss concealment (monitor-data.c PLC path)."""
        lib = _load()
        out = np.empty((frames, self.channels), np.float32)
        n = lib.opus_decode_float(
            ctypes.c_void_p(self._dec),
            data if data is not None else None,
            ctypes.c_int32(len(data) if data else 0),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ctypes.c_int(frames), ctypes.c_int(0),
        )
        if n < 0:
            raise OSError(f"opus_decode_float: {n}")
        return out[:n]

    def __del__(self):
        try:
            _load().opus_decoder_destroy(ctypes.c_void_p(self._dec))
        except Exception:
            pass
