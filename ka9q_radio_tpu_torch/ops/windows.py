"""Window functions for filter synthesis and spectral analysis.

Host-side (numpy, float64): windows are only computed at channel-configuration
time, never on the device hot path — the same division of labor as the
reference, where `set_filter` synthesizes responses on demand (window.h:17-28).

Window menu matches the reference's `enum window_type`: kaiser, rect,
blackman, exact_blackman, gaussian, hann, hamming, blackman_harris, hp5ft.
All cosine-sum windows use the symmetric (N-1) denominator convention, as in
the reference.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_window", "kaiser", "WINDOW_TYPES", "window_noise_bandwidth"]


def kaiser(M: int, beta: float) -> np.ndarray:
    """Kaiser window of length M (reference: make_kaiserf, window.c:218-236)."""
    n = np.arange(M, dtype=np.float64)
    x = 2.0 * n / (M - 1) - 1.0 if M > 1 else np.zeros(1)
    return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta)


def _cos_terms(M: int, a) -> np.ndarray:
    """sum_k (-1)^k a[k] cos(2 pi k n / (M-1))."""
    n = np.arange(M, dtype=np.float64)
    w = np.full(M, a[0], dtype=np.float64)
    for k in range(1, len(a)):
        w += ((-1.0) ** k) * a[k] * np.cos(2.0 * np.pi * k * n / (M - 1))
    return w


def gaussian(M: int, sigma: float) -> np.ndarray:
    n = np.arange(M, dtype=np.float64) - (M - 1) / 2.0
    s = sigma * (M - 1) / 2.0
    if s <= 0:
        w = np.zeros(M)
        w[M // 2] = 1.0
        return w
    return np.exp(-0.5 * (n / s) ** 2)


WINDOW_TYPES = (
    "kaiser",
    "rect",
    "blackman",
    "exact_blackman",
    "gaussian",
    "hann",
    "hamming",
    "blackman_harris",
    "hp5ft",
)


def make_window(kind: str, M: int, param: float | None = None) -> np.ndarray:
    """Build a window of length M. `param` is Kaiser beta or Gaussian sigma."""
    kind = kind.lower().replace("-", "_").replace(" ", "_")
    if M <= 1:
        return np.ones(max(M, 1), dtype=np.float64)
    if kind == "kaiser":
        return kaiser(M, 11.0 if param is None else float(param))
    if kind == "rect":
        return np.ones(M, dtype=np.float64)
    if kind == "blackman":
        return _cos_terms(M, [0.42, 0.5, 0.08])
    if kind == "exact_blackman":
        return _cos_terms(M, [7938.0 / 18608, 9240.0 / 18608, 1430.0 / 18608])
    if kind == "gaussian":
        return gaussian(M, 0.4 if param is None else float(param))
    if kind == "hann":
        return _cos_terms(M, [0.5, 0.5])
    if kind == "hamming":
        return _cos_terms(M, [25.0 / 46.0, 21.0 / 46.0])
    if kind == "blackman_harris":
        return _cos_terms(M, [0.35875, 0.48829, 0.14128, 0.01168])
    if kind == "hp5ft":
        # 5-term HP/Agilent flat-top (Heinzel et al), as in window.c
        return _cos_terms(M, [1.0, 1.912510941, 1.079173272, 0.1832630879, 0.0066586847])
    raise ValueError(f"unknown window type {kind!r} (choose from {WINDOW_TYPES})")


def window_noise_bandwidth(w: np.ndarray) -> float:
    """Equivalent noise bandwidth of a window, in bins
    (reference: spectrum.c:608-614): N * sum(w^2) / sum(w)^2."""
    w = np.asarray(w, dtype=np.float64)
    return float(len(w) * np.sum(w * w) / (np.sum(w) ** 2))
