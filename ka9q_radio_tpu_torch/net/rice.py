"""Rice-coded spectrum bins — a WORKING version of the reference's dead
experiment (/root/reference/src/spectrum.c:718-795).

Upstream ships the Rice coder behind `#if RICE`, and even when compiled
in, its guard (`if(step == 0 || bin_count) return;`) disables it for
every real channel; it never produces a wire format — it only prints
the bit count the encoding WOULD take. This module finishes the
experiment: the same quantization as the v2 byte format
(spectrum-base/-step dB steps, clamped at 0, most-negative-frequency
first), the same parameter search (k in 1..5, plain vs zig-zag delta,
pick whichever costs fewest bits — mirroring the reference's two cost
loops), and an actual MSB-first bitstream with a decoder.

Wire format (TLV key BIN_RICE_DATA = 125 — a PRIVATE extension chosen
above upstream's last assigned key, 117; TLV readers skip unknown keys,
so stock clients are unaffected):

  byte 0   flags: bit 0 = delta (zig-zag) mode, bits 1-3 = k
  byte 1+  bin_count Rice codewords, MSB-first: value v >= 0 is emitted
           as (v >> k) zero bits, a one bit, then the low k bits of v.

Typical sweeps code at 25-50% of the byte format's 1 byte/bin.
"""
from __future__ import annotations

import numpy as np

__all__ = ["rice_encode", "rice_decode", "quantize_bins", "dequantize_bins"]


def quantize_bins(bins_power: np.ndarray, base: float, step: float) -> np.ndarray:
    """Power bins -> the byte-format dB quantization (uint levels >= 0)."""
    db = 10.0 * np.log10(np.maximum(np.asarray(bins_power, np.float64), 1e-30))
    return np.rint(np.clip((db - base) / step, 0, None)).astype(np.int64)


def dequantize_bins(levels: np.ndarray, base: float, step: float) -> np.ndarray:
    """Quantized levels -> dB values (same reading as BIN_BYTE_DATA)."""
    return base + np.asarray(levels, np.float64) * step


def _zigzag(deltas: np.ndarray) -> np.ndarray:
    return (np.abs(deltas) << 1) | (deltas < 0)


def _unzigzag(values: np.ndarray) -> np.ndarray:
    return np.where(values & 1, -(values >> 1), values >> 1)


def _cost_bits(values: np.ndarray, k: int) -> int:
    return int(np.sum((values >> k) + 1 + k))


def rice_encode(levels: np.ndarray) -> bytes:
    """Encode non-negative quantized levels; picks k and delta mode by
    exact bit cost (the reference's selection loops, spectrum.c:741-790)."""
    vals = np.asarray(levels, np.int64)
    if vals.size == 0:
        return bytes([1 << 1])
    if np.any(vals < 0):
        raise ValueError("rice_encode needs non-negative levels")
    deltas = np.diff(vals, prepend=np.int64(0))
    zz = _zigzag(deltas)
    best = None  # (bits, delta_mode, k)
    for k in range(1, 6):
        for delta_mode, v in ((False, vals), (True, zz)):
            bits = _cost_bits(v, k)
            if best is None or bits < best[0]:
                best = (bits, delta_mode, v, k)
    _, delta_mode, v, k = best
    out = bytearray([(k << 1) | (1 if delta_mode else 0)])
    acc = 0
    nacc = 0
    for value in v.tolist():
        q = value >> k
        # q zero bits, a one bit, then k remainder bits — as one integer
        word = (1 << k) | (value & ((1 << k) - 1))
        nbits = q + 1 + k
        acc = (acc << nbits) | word
        nacc += nbits
        while nacc >= 8:
            nacc -= 8
            out.append((acc >> nacc) & 0xFF)
        acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF)
    return bytes(out)


def rice_decode(data: bytes, count: int) -> np.ndarray:
    """Decode `count` levels; inverse of rice_encode."""
    if not data:
        raise ValueError("empty rice stream")
    flags = data[0]
    delta_mode = bool(flags & 1)
    k = (flags >> 1) & 0x7
    if not 1 <= k <= 5:
        raise ValueError(f"rice stream: bad k={k}")
    bits = int.from_bytes(data[1:], "big")
    nbits = 8 * (len(data) - 1)
    vals = np.empty(count, np.int64)
    pos = nbits  # read MSB-first: pos = bits remaining to the right
    for i in range(count):
        q = 0
        while pos > 0 and not (bits >> (pos - 1)) & 1:
            q += 1
            pos -= 1
        if pos <= k:
            raise ValueError("rice stream truncated")
        pos -= 1  # the stop bit
        r = (bits >> (pos - k)) & ((1 << k) - 1)
        pos -= k
        vals[i] = (q << k) | r
    if delta_mode:
        vals = np.cumsum(_unzigzag(vals))
    if np.any(vals < 0):
        raise ValueError("rice stream: negative level after delta")
    return vals
