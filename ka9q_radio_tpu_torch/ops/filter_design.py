"""Channel filter-response synthesis (host side, float64).

Behavioral equivalent of the reference's `set_filter` (filter.c:934-1007):
a Kaiser-windowed sinc lowpass of half-bandwidth (high-low)/2, rotated to
the passband center, embedded in the first M = N_points - olen + 1 taps of
an N_points buffer, forward-FFT'd into the channel's frequency response.

Gain conventions carried into the response so the device hot path is a bare
gather-multiply-IDFT:
  * 1/window_gain          — windowed-sinc passband normalization
  * 1/master_points        — the unnormalized master forward FFT's gain
  * sqrt(2) if real master — half the energy lives in the implicit negative
                             spectrum (filter.c:983-990)
  * N_points               — the channel IDFT normalizes by 1/N, the
                             reference IFFT doesn't; pre-scale so outputs match.
The channel Nyquist bin is zeroed at design time (filter.c "Zero out Nyquist
bin").
"""
from __future__ import annotations

import numpy as np

from .windows import kaiser

__all__ = ["design_bandpass_response", "response_to_device_order"]


def design_bandpass_response(
    n_points: int,
    olen: int,
    low: float,
    high: float,
    kaiser_beta: float = 11.0,
    real_master: bool = True,
    master_points: int | None = None,
    real_output: bool = False,
) -> np.ndarray:
    """Synthesize a complex channel frequency response.

    Args:
      n_points: channel IFFT size N (bins, FFT order: DC first, negative
        frequencies in the upper half).
      olen: output samples kept per block (L); kernel length M = N - L + 1.
      low, high: passband edges as fractions of the output sample rate,
        each in [-0.5, +0.5].
      kaiser_beta: Kaiser window beta.
      real_master: True when the master input stream is real (adds +3 dB).
      master_points: master FFT length (for 1/N gain of the unnormalized
        master forward transform). Defaults to n_points for standalone use.
      real_output: channel IFFT is c2r (e.g. WFM composite mono slave);
        edges are folded to positive frequencies.

    Returns:
      complex128 [n_points] response in FFT bin order (convert with
      `response_to_device_order` or cast directly for the device).
    """
    N = int(n_points)
    L = int(olen)
    M = N - L + 1
    if M < 2:
        raise ValueError(f"impulse length M={M} too short (N={N}, olen={L})")
    if master_points is None:
        master_points = N
    if real_output:
        low, high = abs(low), abs(high)
    if low > high:
        low, high = high, low
    low = min(max(low, -0.5), 0.5)
    high = min(max(high, -0.5), 0.5)

    bw2 = 1e-4 if high == low else abs(high - low) / 2.0
    center = (high + low) / 2.0

    win = kaiser(M, kaiser_beta)
    n = np.arange(M, dtype=np.float64) - (M - 1) / 2.0
    r = win * 2.0 * bw2 * np.sinc(2.0 * bw2 * n)
    window_gain = float(np.sum(r))
    gain = (np.sqrt(2.0) if real_master else 1.0) / (window_gain * master_points)
    # pre-compensate the channel IDFT's 1/N normalization (reference IFFT is raw)
    gain *= N

    impulse = np.zeros(N, dtype=np.complex128)
    impulse[:M] = r * gain * np.exp(1j * np.pi * (2.0 * center * n))
    response = np.fft.fft(impulse)  # unnormalized forward FFT, like FFTW
    # zero the channel Nyquist bin (filter.c:896)
    response[(N + 1) // 2] = 0.0
    return response


def response_to_device_order(response: np.ndarray) -> np.ndarray:
    """Cast a designed response for device upload (complex64, FFT bin order)."""
    return np.ascontiguousarray(response.astype(np.complex64))
