"""Front ends beyond sig_gen: file playback and network (RTP) ingest.

The reference's front-end layer (SURVEY.md §2.3) is a dlopen ABI over USB
SDR hardware; a TPU pod has no USB bus, so the hardware contract becomes a
*stream* contract: anything that can deliver blocks of float32/complex64
samples at a declared rate is a front end. Three implementations:

  SigGen      (source.py) — synthetic carrier+noise test fixture
  FileSource  — IQ/real recordings (f32/s16/c64/wav-style raw), looping
  RtpSource   — live network ingest: an SDR host streams s16/f32 (real or
                I/Q interleaved) over RTP multicast — the pcmsend/pcmcat
                path of the reference (pcmsend.c) — and the TPU radiod
                consumes it as its A/D stream

Each exposes: samprate, real, and read_block(L) -> np.ndarray[L].
"""
from __future__ import annotations

import select
import sys

import numpy as np

from ..net.rtp import RtpHeader, RtpState, Encoding, decode_samples
from ..net.multicast import resolve_dest, listen_socket, DEFAULT_RTP_PORT

__all__ = ["FileSource", "RtpSource"]

_FORMATS = {
    "f32le": (np.dtype("<f4"), 1),
    "f32be": (np.dtype(">f4"), 1),
    "s16le": (np.dtype("<i2"), 1),
    "s16be": (np.dtype(">i2"), 1),
    "cf32le": (np.dtype("<f4"), 2),
    "cs16le": (np.dtype("<i2"), 2),
    "cs8": (np.dtype("i1"), 2),  # rtl_sdr style offset-binary handled below
}


class FileSource:
    """Sample playback from a raw capture file.

    format: f32le/f32be/s16le/s16be (real) or cf32le/cs16le/cs8 (complex
    interleaved I/Q). cs8 is treated as rtl_sdr unsigned-offset bytes when
    `rtl_offset` is set.
    """

    def __init__(self, path: str, samprate: float, format: str = "cf32le",
                 loop: bool = False, rtl_offset: bool = False):
        if format not in _FORMATS:
            raise ValueError(f"unknown format {format!r} (choose from {sorted(_FORMATS)})")
        self.path = path
        self.samprate = float(samprate)
        self.format = format
        self.dtype, self.width = _FORMATS[format]
        self.real = self.width == 1
        self.loop = loop
        self.rtl_offset = rtl_offset
        self._fh = open(path, "rb")
        self.exhausted = False

    def read_block(self, L: int) -> np.ndarray:
        need = L * self.width * self.dtype.itemsize
        buf = b""
        while len(buf) < need:
            chunk = self._fh.read(need - len(buf))
            if not chunk:
                if self.loop:
                    self._fh.seek(0)
                    continue
                self.exhausted = True
                buf += b"\0" * (need - len(buf))
                break
            buf += chunk
        raw = np.frombuffer(buf, self.dtype)
        if self.dtype.kind == "i":
            if self.rtl_offset:
                # rtl_sdr bytes are UNSIGNED offset binary — reinterpret
                # before centering or the top half of the range wraps sign
                u = np.frombuffer(buf, np.uint8).astype(np.float32)
                x = (u - 127.5) / 127.5
            else:
                scale = 1.0 / 127.0 if self.dtype.itemsize == 1 else 1.0 / 32767.0
                x = raw.astype(np.float32) * scale
        else:
            x = raw.astype(np.float32)
        if self.real:
            return x
        return (x[0::2] + 1j * x[1::2]).astype(np.complex64)

    def close(self):
        self._fh.close()


class RtpSource:
    """Live A/D ingest from an RTP stream (the network front end).

    Reassembles in timestamp order with zero-fill on loss, buffering up to
    `max_buffer` samples. Encoding/rate must be declared (an RTP IQ sender
    like pcmsend doesn't beacon status).

    The default path is the NATIVE reader (native/rtp_edge.cpp
    rtp_ingest): a C++ thread doing recvmmsg batches + vectorized
    s16/f32 -> f32 conversion into a preallocated ring — the
    rx888.c:668-744 completion-callback analog; the Python recvfrom loop
    tops out around 1 Msps. Python remains the fallback where the native
    reader cannot take the encoding or cannot build or open; the reason
    goes to stderr and `fallback_reason`, and stats()["native"] says which
    reader runs.
    """

    def __init__(self, stream: str, samprate: float, real: bool = False,
                 encoding: str = "s16be", ssrc: int | None = None,
                 max_buffer_s: float = 2.0, native: bool = True):
        self.samprate = float(samprate)
        self.real = real
        self.encoding = Encoding[encoding.upper()]
        self.ssrc = ssrc
        self.width = 1 if real else 2
        self.timeouts = 0
        self._native = None
        self.fallback_reason = None
        dest = resolve_dest(stream, DEFAULT_RTP_PORT)
        if native:
            self._native, self.fallback_reason = self._open_native(dest, max_buffer_s)
            if self._native is None:
                print(f"RtpSource {stream}: the Python reader runs: {self.fallback_reason}",
                      file=sys.stderr, flush=True)
        if self._native is not None:
            self.sock = None
            self.rtp = RtpState()  # stats shadow (native keeps its own)
            return
        self.sock = listen_socket(dest)
        self.rtp = RtpState()
        self._buf = np.zeros(0, np.float32)
        self.max_buffer = int(max_buffer_s * self.samprate) * self.width

    def _open_native(self, dest, max_buffer_s: float):
        """(the native reader, None), or (None, why it cannot run)."""
        from ..native import RtpIngest, native_available

        if int(self.encoding) not in RtpIngest.SUPPORTED:
            return None, f"the native reader does not convert {self.encoding.name}"
        if not native_available():
            return None, "the native edge did not build or load"
        # ring sized >= 2 * max_buffer_s of stream
        need = 2.0 * max_buffer_s * self.samprate * self.width
        log2 = max(20, min(30, int(np.ceil(np.log2(max(need, 1))))))
        try:
            return RtpIngest(dest, encoding=int(self.encoding), width=self.width,
                             ssrc=self.ssrc or 0, ring_log2=log2), None
        except Exception as e:  # noqa: BLE001 - any failure leaves the Python reader
            return None, f"the native reader did not open: {e!r}"

    def _pump(self, timeout: float):
        r, _, _ = select.select([self.sock], [], [], timeout)
        if not r:
            self.timeouts += 1
            return False
        pkt, _ = self.sock.recvfrom(65536)
        try:
            hdr, payload = RtpHeader.unpack(pkt)
        except Exception:
            return True
        if self.ssrc is not None and hdr.ssrc != self.ssrc:
            return True
        x = decode_samples(payload, self.encoding)
        gap = self.rtp.process(hdr, x.size // self.width)
        if gap is not None and gap > 0:  # fill drops with silence
            fill = min(gap * self.width, self.max_buffer)
            self._buf = np.concatenate([self._buf, np.zeros(fill, np.float32)])
        if gap is not None and gap < 0:
            return True  # duplicate/old
        self._buf = np.concatenate([self._buf, x])
        if self._buf.size > self.max_buffer:
            self._buf = self._buf[-self.max_buffer :]
        return True

    def read_block(self, L: int, timeout: float = 1.0) -> np.ndarray:
        need = L * self.width
        if self._native is not None:
            x, got = self._native.read(need, timeout)
            if got < need:  # starved: native zero-filled the tail
                self.timeouts += 1
        else:
            while self._buf.size < need:
                if not self._pump(timeout):
                    # starved: pad with silence so the engine keeps cadence
                    self._buf = np.concatenate([self._buf, np.zeros(need - self._buf.size, np.float32)])
            x, self._buf = self._buf[:need], self._buf[need:]
        if self.real:
            return x
        return (x[0::2] + 1j * x[1::2]).astype(np.complex64)

    def stats(self) -> dict:
        """Ingest loss accounting (native reader) — the analog of the
        reference's USB transfer-loss counters (rx888.c:675-688)."""
        if self._native is not None:
            return {**self._native.stats(), "native": True}
        return {"packets": self.rtp.packets, "bytes": self.rtp.bytes,
                "gap_frames": self.rtp.drops, "dups": self.rtp.dupes,
                "overrun_frames": 0, "starve_frames": 0,
                "malformed": 0, "buffered_floats": self._buf.size, "native": False}

    def close(self):
        if self._native is not None:
            self._native.close()
        if self.sock is not None:
            self.sock.close()
