"""Quantile-based noise-floor (N0) estimation.

The reference's estimate_noise (radio.c:1821-1904, spec in the comment at
radio.c:1690-1755): take the energies of master FFT bins around each
channel, find the 10% quantile, average the bins below 1.5x that quantile
(hopefully noise-only), and apply the exact exponential-distribution
correction factor for the truncated mean.

Only order statistics i and i+1 (i = floor(NQ*(nbins-1))) are needed, not a
sorted prefix. Non-negative float32 energies viewed as int32 order
identically, so each statistic is found EXACTLY by a 31-step bisection on
the key space counting `keys <= mid` per row.

`gather_noise_bins` + `estimate_noise_keys` here are the plain PyTorch
version of the CUDA kernel in ops/cuda_channelize.py; the engine calls the
kernel's wrapper, which runs these for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["NQ", "N_CUTOFF", "POWER_ALPHA", "MIN_NOISE_BINS", "noise_correction",
           "noise_window_fits", "gather_noise_bins", "estimate_noise_keys",
           "estimate_noise"]

NQ = 0.10  # quantile assumed noise-only (radio.c:74)
_TILE = 128  # noise-window placement granularity, bins
N_CUTOFF = 1.5  # averaging threshold multiplier (radio.c:75)
POWER_ALPHA = 0.10  # per-block EMA smoothing of N0 (radio.c:73)
MIN_NOISE_BINS = 1000  # widen the window for narrow channels (radio.c:77)
_INT32_MAX = 2**31 - 1


def noise_correction(q: float = NQ, cutoff: float = N_CUTOFF) -> float:
    """Unbiasing factor for the truncated exponential mean (radio.c:1878-1882)."""
    z = cutoff * (-np.log(1.0 - q))
    return float(1.0 / (1.0 - z * np.exp(-z) / (1.0 - np.exp(-z))))


def noise_window_fits(nbins: int, real_master: bool, master_N: int) -> bool:
    """Whether the tile-aligned window placement applies to this master
    (the per-element placement for small or odd masters is a later slice)."""
    W = -(-nbins // _TILE) * _TILE
    m_bins = master_N // 2 + 1 if real_master else master_N
    return m_bins >= W and (real_master or m_bins % _TILE == 0)


def gather_noise_bins(F: torch.Tensor, shifts: torch.Tensor, nbins: int,
                      real_master: bool, master_N: int) -> torch.Tensor:
    """Energies |F|^2 of the noise-estimation window of every channel.

    The window is `nbins` rounded up to whole 128-bin tiles, placed as in
    radio.c:1845-1872 on a 128-bin grid: around |shift| clamped inside
    [DC, Nyquist] for real masters; around the signed shift, clamped inside
    the signed band and wrapped through DC, for complex masters.
    Returns [C, W] float32.
    """
    if not noise_window_fits(nbins, real_master, master_N):
        raise NotImplementedError(
            "per-element noise windows (small or odd masters) are a later slice of the port")
    T = _TILE
    W = -(-nbins // T) * T
    m_bins = master_N // 2 + 1 if real_master else master_N
    # square before the gather, as a*a + b*b with no fused multiply-add:
    # the CUDA kernel rounds the same two products and sum
    E = F.real * F.real + F.imag * F.imag
    sh = shifts.to(torch.int64)
    k = torch.arange(W, dtype=torch.int64, device=F.device)[None, :]
    if real_master:
        lo = torch.clamp(sh.abs() - W // 2, 0, m_bins - W)
        start = torch.div(lo, T, rounding_mode="floor") * T
        return E[start[:, None] + k]
    lo = torch.clamp(sh - W // 2, -(m_bins // 2), (m_bins - 1) // 2 - (W - 1))
    start = torch.div(lo, T, rounding_mode="floor") * T
    return E[torch.remainder(start[:, None] + k, m_bins)]


def _quantile_terms(nbins: int):
    """(i, has_next, weight of statistic i, weight of statistic i+1)."""
    pos = NQ * (nbins - 1)
    i = int(np.floor(pos))
    frac = pos - i
    return i, min(i + 1, nbins - 1) != i, float(np.float32(1.0 - frac)), float(np.float32(frac))


def estimate_noise_keys(energies: torch.Tensor, master_bins: int, samprate: float):
    """N0 (power spectral density per Hz) per channel from bin energies.

    energies: [C, nbins] float32 (from gather_noise_bins). master_bins: the
    master's bin count (N/2+1 real, N complex) — the reference normalizes
    by bins*samprate (radio.c:1901-1903).
    Returns (n0 [C] float32, keys [C, 2] int32): the int32 views of order
    statistics i and i+1.
    """
    nbins = energies.shape[-1]
    i, has_next, w_lo, w_hi = _quantile_terms(nbins)
    keys = energies.view(torch.int32)
    C = keys.shape[0]
    lo = torch.zeros(C, dtype=torch.int32, device=keys.device)
    hi = torch.full((C,), _INT32_MAX, dtype=torch.int32, device=keys.device)
    for _ in range(31):
        # smallest v with count(keys <= v) >= i+1; hi - lo never overflows
        mid = lo + torch.bitwise_right_shift(hi - lo, 1)
        take_lo = (keys <= mid[:, None]).sum(-1) >= i + 1
        lo, hi = torch.where(take_lo, lo, mid + 1), torch.where(take_lo, mid, hi)
    vi = lo
    v1 = vi
    if has_next:
        # statistic i+1 in two passes: the i-th key's tie group reaches rank
        # i+1, or the next statistic is the smallest key strictly above it
        cnt_le = (keys <= vi[:, None]).sum(-1)
        bigger = torch.where(keys > vi[:, None], keys, _INT32_MAX)
        v1 = torch.where(cnt_le >= i + 2, vi, bigger.amin(-1))
    q = vi.view(torch.float32) * w_lo + v1.view(torch.float32) * w_hi
    thresh = N_CUTOFF * q
    mask = energies <= thresh[:, None]
    count = torch.clamp(mask.sum(-1), min=1)
    mean = torch.where(mask, energies, 0.0).sum(-1) / count
    n0 = mean * float(np.float32(noise_correction())) / float(np.float32(float(master_bins) * float(samprate)))
    return n0, torch.stack([vi, v1], dim=-1)


def estimate_noise(energies: torch.Tensor, master_bins: int, samprate: float) -> torch.Tensor:
    """[C] float32 N0 estimates (see estimate_noise_keys)."""
    return estimate_noise_keys(energies, master_bins, samprate)[0]
