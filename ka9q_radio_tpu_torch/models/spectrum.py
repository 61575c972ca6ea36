"""Spectrum-analysis pseudo-demodulator (spectrum.c), wideband algorithm.

The wideband algorithm (spectrum.c:317-531) takes windowed FFTs straight off
the raw A/D stream; the engine uses it when the resolution bandwidth is
coarser than the crossover (default 200 Hz, modes.c:69), so the analysis FFT
is small. The frame schedule is static — `frames_per_block = L // hop`
windowed FFTs per block — and polls read the continuously maintained
average. Averaging is a per-frame EMA with alpha = 1/fft_avg after a boxcar
warm-up of fft_avg frames, the streaming equivalent of the reference's
boxcar of `fft_avg` FFTs (modes.c:73).

The narrowband algorithm (downconverted baseband) is a later slice of the
port.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.windows import make_window, window_noise_bandwidth

__all__ = ["WideGeometry", "wide_geometry", "wide_constants", "wide_init", "wide_accumulate",
           "wide_extract"]


@dataclasses.dataclass(frozen=True)
class WideGeometry:
    samprate: float  # raw front-end rate
    L: int  # master block (samples per engine step)
    real: bool
    fft_n: int
    hop: int
    fft_avg: int
    window: np.ndarray

    @property
    def frames_per_block(self) -> int:
        return self.L // self.hop

    @property
    def carry(self) -> int:
        return self.fft_n - self.hop if self.fft_n > self.hop else 0

    @property
    def bins(self) -> int:
        return self.fft_n // 2 + 1 if self.real else self.fft_n

    @property
    def rbw(self) -> float:
        return self.samprate / self.fft_n

    @property
    def noise_bw(self) -> float:
        """Window equivalent noise bandwidth, Hz (spectrum.c:608-614)."""
        return window_noise_bandwidth(self.window) * self.rbw


def wide_geometry(samprate: float, L: int, real: bool, bin_bw: float, window: str = "kaiser",
                  window_param: float = 7.0, fft_avg: int = 10,
                  overlap: float = 0.0) -> WideGeometry:
    fft_n = max(int(round(samprate / bin_bw)), 8)
    frac = max(1.0 - overlap, 1.0 / 8)
    hop = max(int(round(fft_n * frac)), 1)
    divisors = [d for d in (range(1, 4097)) if L % d == 0]
    # hop must divide L for a static frame schedule; fft_n rescaled to match
    hop = min((d for d in divisors), key=lambda d: abs(d - hop)) if hop <= 4096 else hop
    if L % hop:
        for d in range(hop, 0, -1):
            if L % d == 0:
                hop = d
                break
    fft_n = max(int(round(hop / frac)), 8)
    w = make_window(window, fft_n, window_param).astype(np.float64)
    w = w / w.sum()
    return WideGeometry(samprate=samprate, L=L, real=real, fft_n=fft_n, hop=hop,
                        fft_avg=fft_avg, window=w.astype(np.float32))


def wide_init(geo: WideGeometry, device=None):
    dtype = torch.float32 if geo.real else torch.complex64
    return {
        "carry": torch.zeros((geo.carry,), dtype=dtype, device=device),
        "power": torch.zeros((geo.bins,), dtype=torch.float32, device=device),
        "frames": torch.zeros((), dtype=torch.int32, device=device),
    }


def wide_constants(geo: WideGeometry, device=None) -> dict:
    """Device constants of the wide algorithm, made once per group so the
    per-block path copies nothing from the host: the analysis window and
    the steady-state EMA weights of one block's frames."""
    nf = geo.frames_per_block
    alpha = np.float32(1.0 / geo.fft_avg)
    # pw' = (1-a)^nf pw + sum_k a (1-a)^(nf-1-k) p_k  — nf EMA steps exactly
    wts = alpha * (1.0 - alpha) ** np.arange(nf - 1, -1, -1, dtype=np.float64)
    return {
        "window": torch.as_tensor(geo.window, device=device),
        "steady": torch.as_tensor(wts.astype(np.float32), device=device),
        "decay": float(np.float32((1.0 - alpha) ** nf)),
    }


def _fold_frames(power: torch.Tensor, nstart: int, p: torch.Tensor, fft_avg: int,
                 consts: dict) -> torch.Tensor:
    """Streaming per-frame average of the frame powers p [nf, ...]: the
    first fft_avg frames fill a boxcar, then an EMA with alpha = 1/fft_avg.

    nstart is the host mirror of the frames already folded, so choosing the
    warm-up loop or the steady closed form reads no device value.
    """
    if nstart >= fft_avg:
        return power * consts["decay"] + torch.tensordot(consts["steady"], p, dims=([0], [0]))
    alpha = float(np.float32(1.0 / fft_avg))
    pw = power
    for k in range(p.shape[0]):
        n = nstart + k
        a = float(np.float32(1.0) / np.float32(n + 1)) if n < fft_avg else alpha
        pw = pw + a * (p[k] - pw)
    return pw


def wide_accumulate(state, block: torch.Tensor, geo: WideGeometry, consts: dict, nstart: int):
    """Fold one raw input block into the wideband average.

    consts: wide_constants(geo) on the block's device; nstart: host mirror
    of state["frames"]. Returns (new_state, power [bins]) in raw FFT bin
    order.
    """
    data = torch.cat([state["carry"], block]) if geo.carry else block
    nf = geo.frames_per_block
    frames = data.unfold(0, geo.fft_n, geo.hop)[:nf] * consts["window"]
    X = torch.fft.rfft(frames) if geo.real else torch.fft.fft(frames)
    p = X.real * X.real + X.imag * X.imag
    if geo.real:
        p = p * 2.0  # one-sided spectrum carries half the energy (spectrum.c)
    pwr = _fold_frames(state["power"], nstart, p, geo.fft_avg, consts)
    new_state = {
        "carry": data[geo.L:] if geo.carry else state["carry"],
        "power": pwr,
        "frames": state["frames"] + nf,
    }
    return new_state, pwr


def wide_extract(power: torch.Tensor, shifts: torch.Tensor, master_N: int, geo: WideGeometry,
                 bin_count: int) -> torch.Tensor:
    """Per-channel slice of the shared wideband average.

    shifts: [C] master-FFT bin shifts; scaled down to analysis bins like
    spectrum.c:359 (shift * fft_n / master_points) in float32, as the JAX
    package does. Output lowest frequency first, [C, bin_count].
    """
    scaled = torch.round(shifts.to(torch.float32) * float(np.float32(geo.fft_n / master_N)))
    k = torch.arange(bin_count, dtype=torch.int64, device=power.device)[None, :] - bin_count // 2
    idx = scaled.to(torch.int64)[:, None] + k
    if geo.real:
        m = geo.bins
        mi = idx.abs()
        return torch.where(mi < m, power[torch.clamp(mi, 0, m - 1)], 0.0)
    return power[torch.remainder(idx, geo.fft_n)]
