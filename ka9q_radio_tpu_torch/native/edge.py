"""ctypes bindings and the lazy build of the native RTP edge (rtp_edge.cpp).

The library is compiled with g++ from this package's rtp_edge.cpp the first
time a consumer asks for it (never on import), into build/native/ at the
root of the checkout, a directory git ignores. The file name carries a hash
of the source, so an edited source builds anew."""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

__all__ = ["RtpEdge", "RtpIngest", "ingest_blast", "native_available", "native_has_opus",
           "build"]

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "rtp_edge.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build", "native")
_lock = threading.Lock()
_lib = None
_build_failed = False


def build() -> str:
    """Compile the shared library unless this source's build exists.
    Returns its path."""
    with open(_SRC, "rb") as fh:
        key = hashlib.sha256(fh.read()).hexdigest()[:16]
    lib = os.path.join(_BUILD_DIR, f"librtp_edge-{key}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC, "-ldl"],
                   check=True, capture_output=True)
    os.replace(tmp, lib)
    return lib


def _load():
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            raise OSError("native build previously failed")
        try:
            lib = ctypes.CDLL(build())
        except Exception:
            _build_failed = True
            raise
        lib.rtp_edge_open.restype = ctypes.c_int
        lib.rtp_edge_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.rtp_edge_close.argtypes = [ctypes.c_int]
        lib.rtp_edge_send_block.restype = ctypes.c_int
        lib.rtp_edge_send_block.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p,
        ]
        lib.rtp_edge_has_opus.restype = ctypes.c_int
        lib.rtp_edge_send_ctl.restype = ctypes.c_int
        lib.rtp_edge_send_ctl.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                          ctypes.c_int, ctypes.c_int]
        lib.rtp_edge_send_indexed.restype = ctypes.c_int
        lib.rtp_edge_send_indexed.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint16), ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_char_p,
        ]
        lib.rtp_ingest_open.restype = ctypes.c_int
        lib.rtp_ingest_open.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_int]
        lib.rtp_ingest_read.restype = ctypes.c_long
        lib.rtp_ingest_read.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_long,
            ctypes.c_int]
        lib.rtp_ingest_stats.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
        lib.rtp_ingest_close.argtypes = [ctypes.c_int]
        lib.rtp_ingest_blast.restype = ctypes.c_longlong
        lib.rtp_ingest_blast.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_uint32, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int]
        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def native_has_opus() -> bool:
    """True when the edge can encode Opus (libopus.so.0 dlopens)."""
    try:
        return bool(_load().rtp_edge_has_opus())
    except Exception:
        return False


class RtpEdge:
    """Batched RTP output for one channel group sharing (dest, nframes, nch).

    Owns the per-channel RTP sequence state as numpy arrays the C side
    updates in place; one `send_block` call packetizes and transmits the
    whole [C, ...] audio block via sendmmsg.
    """

    def __init__(self, dest: tuple[str, int], C: int, nch: int = 1,
                 ttl: int = 1, tos: int = 48 << 2):
        lib = _load()
        self._lib = lib
        self.fd = lib.rtp_edge_open(dest[0].encode(), dest[1], ttl, tos)
        if self.fd < 0:
            raise OSError(f"rtp_edge_open failed: {self.fd}")
        self.C, self.nch = C, nch
        self.ssrc = np.zeros(C, np.uint32)
        self.pt = np.zeros(C, np.uint8)
        self.encoding = np.full(C, 2, np.int32)  # S16BE
        self.samprate = np.zeros(C, np.int32)  # needed for Opus channels
        self.opus_bitrate = np.zeros(C, np.int32)  # 0 = auto
        self.opus_dtx = np.zeros(C, np.uint8)
        self.opus_app = np.zeros(C, np.int32)  # 0 = derive from encoding
        self.seq = np.zeros(C, np.uint16)
        self.ts = np.zeros(C, np.uint32)
        self.packets = 0

    def send_block(self, audio: np.ndarray, send: np.ndarray, marker: np.ndarray) -> int:
        """audio [C, nframes(, nch)] float32; send/marker [C] bool."""
        a = np.ascontiguousarray(audio, np.float32)
        nframes = a.shape[1]
        sends = np.ascontiguousarray(send, np.uint8)
        marks = np.ascontiguousarray(marker, np.uint8)
        n = self._lib.rtp_edge_send_block(
            self.fd,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.C, nframes, self.nch,
            sends.tobytes(),
            self.ssrc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self.pt.tobytes(),
            self.encoding.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.samprate.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.opus_bitrate.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.opus_dtx.tobytes(),
            self.opus_app.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self.ts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            marks.tobytes(),
        )
        if n > 0:
            self.packets += n
        return n

    def send_indexed(self, audio: np.ndarray, idx: np.ndarray, count: int,
                     marker: np.ndarray) -> int:
        """Compacted-egress send: audio [K, nframes(, nch)] holds only
        the open channels' rows; idx[i] is row i's channel index (device
        squelch gather). Timestamps advance for ALL channels; marker is
        per-CHANNEL [C]. PCM encodings only."""
        a = np.ascontiguousarray(audio, np.float32)
        nframes = a.shape[1]
        idxs = np.ascontiguousarray(idx[:count], np.int32)
        marks = np.ascontiguousarray(marker, np.uint8)
        n = self._lib.rtp_edge_send_indexed(
            self.fd,
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(count), self.C, nframes, self.nch,
            idxs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.ssrc.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self.pt.tobytes(),
            self.encoding.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            self.seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self.ts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            marks.tobytes(),
        )
        if n > 0:
            self.packets += n
        return n

    def send_ctl(self, pkt: bytes, port: int) -> int:
        """Send a status/beacon packet from the audio socket's source
        port to the data group's `port` (stock clients match on it)."""
        if self.fd < 0:
            return -1
        return self._lib.rtp_edge_send_ctl(self.fd, pkt, len(pkt), port)

    def close(self):
        if self.fd >= 0:
            self._lib.rtp_edge_close(self.fd)
            self.fd = -1


_STAT_NAMES = ("packets", "bytes", "gap_frames", "dups", "overrun_frames",
               "starve_frames", "malformed", "buffered_floats")


class RtpIngest:
    """Native at-rate RTP A/D ingest: recvmmsg batches + vectorized
    payload->f32 conversion into a preallocated ring on a C++ reader
    thread (the rx888.c:668-744 completion-callback analog). The Python
    side only does one blocking bulk read per 20 ms block."""

    #: encoding codes the native reader converts (net/rtp.py values)
    SUPPORTED = {1: "s16le", 2: "s16be", 4: "f32le", 8: "f32be"}

    def __init__(self, dest: tuple[str, int], encoding: int = 2,
                 width: int = 1, ssrc: int = 0, ring_log2: int = 26,
                 rcvbuf_mb: int = 64):
        if int(encoding) not in self.SUPPORTED:
            raise ValueError(f"encoding {encoding} not native-ingestable")
        lib = _load()
        self._lib = lib
        self.width = int(width)
        self.fd = lib.rtp_ingest_open(dest[0].encode(), dest[1], int(encoding),
                                      self.width, ssrc or 0, ring_log2,
                                      rcvbuf_mb)
        if self.fd < 0:
            raise OSError(f"rtp_ingest_open failed: {self.fd}")

    def read(self, nfloats: int, timeout: float = 1.0) -> tuple[np.ndarray, int]:
        """Blocking bulk read: returns (floats [nfloats], got) — got <
        nfloats means the tail was zero-filled (starvation)."""
        out = np.empty(nfloats, np.float32)
        got = self._lib.rtp_ingest_read(
            self.fd, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            nfloats, int(timeout * 1000))
        return out, int(got)

    def stats(self) -> dict[str, int]:
        buf = (ctypes.c_longlong * 8)()
        self._lib.rtp_ingest_stats(self.fd, buf)
        return dict(zip(_STAT_NAMES, [int(v) for v in buf]))

    def close(self):
        if self.fd >= 0:
            self._lib.rtp_ingest_close(self.fd)
            self.fd = -1


def ingest_blast(dest: tuple[str, int], encoding: int = 2, width: int = 1,
                 ssrc: int = 0x5D12, frames_per_pkt: int = 704,
                 nframes: int = 1_000_000, pace_fps: int = 0,
                 ttl: int = 0) -> int:
    """Native paced RTP sender (the bench and feeder peer): streams the
    ramp ((frame & 0x3fff) - 0x2000) as s16 (or that over 32767 as f32),
    the same value on each of `width` samples of a frame, at pace_fps
    frames/s (0: flat out). Blocks until sent: run it in a thread.
    Returns frames sent (whole packets), < 0 on error."""
    return int(_load().rtp_ingest_blast(
        dest[0].encode(), dest[1], int(encoding), int(width), ssrc,
        frames_per_pkt, nframes, pace_fps, ttl))
