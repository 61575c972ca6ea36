"""Overlap-save fast-convolution filter bank, main-path part.

ONE shared forward FFT over each wideband input block feeds every receiver
channel; each channel takes a slice of master bins (integer-bin coarse
tuning), multiplies by its own frequency response, inverse-transforms at its
own (smaller) output size, discards the contaminated overlap, and applies a
fine-tune phase ramp (the reference's filter.c, Borgerding's "overlap-save
as a multiband mixing, downsampling filter bank").

The master transform is `torch.fft` (cuFFT on the card), batched over a
leading [B] axis for an engine of B inputs. The channel stage is the tiled
channelizer: `tiled_channelize` here is the plain PyTorch version of the
CUDA kernel in ops/cuda_channelize.py, which the engine calls (it runs this
function for CPU tensors only). Groups the tiled form does not cover
(complex masters that are not whole 128-bin tiles, n_bins^2 >= 2^31, a wide
slice whose fold would wrap twice) take the per-element `channelize`, and
beamforming groups `channelize_beam`: a gather and a batched inverse FFT
(cuFFT on the card), as the JAX package computes them outside any kernel.

Several inputs: F is [B, ld] (B spectra, rows ld >= m_bins bins apart; the
engine pads them to whole 128-bin tiles, so every row starts 16-byte
aligned) and `inputs` [C] names each channel's row; each channel's bins are
placed (clamped or wrapped) inside its own row first, then read from it.

Tiled-channelizer derivation (the slice of every channel is a contiguous
run of master bins):

  1. gather whole _CTILE-bin tile rows covering each slice,
  2. multiply a host-prepared PADDED response laid out in the tile frame
     (the within-tile offset o_c is folded into the padding),
  3. one [C, S] x [S, olen] complex product with a SHARED natural-order
     IDFT matrix,
  4. per-channel phase ramp e^{2pi i s_c t / n} correcting the offset, with
     a conjugate select for inverted (negative-shift real-master) slices.

bb[t] = (1/n) sum_k F[shift+signed(k)] resp[k] e^{2pi i k t/n}; with
m = signed(k) + n//2 (natural order), F[lo+m] = cover[o+m]:
  upright:  bb[t] = e^{-2pi i o t/n} * (cover .* rpad  @ E')[t]
  inverted: bb[t] = conj((cover .* r~pad @ E')[t]) * e^{2pi i (o+c1-n//2)t/n}
where E'[j, t] = e^{2pi i (j - n//2) t / n} / n, c1 = ceil(n/2)-1, and
r~pad is the conjugated index-reversed response. Validity zeroing (slices
poking past DC/Nyquist, filter.c:777-859) is baked into the padding.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .osc import phase_ramp_q32, wrap_i32

__all__ = [
    "MasterConfig",
    "master_init",
    "master_fft",
    "master_transform",
    "tile_plan",
    "tiled_idft_matrix",
    "build_tile_params",
    "tiled_channelize",
    "gather_bins",
    "channelize",
    "finish_channelize",
    "isb_unpack",
    "channelize_beam",
    "fine_tune",
    "compute_tuning",
    "block_phase_adjust_q32",
]

_CTILE = 128  # channel-slice gather granularity (bins per tile row)


@dataclasses.dataclass(frozen=True)
class MasterConfig:
    """Geometry of the shared master forward FFT (filter.c:156-301).

    L: new samples consumed per block (ilen = samprate * blocktime)
    M: impulse-response length; M-1 samples of context carried between blocks
    real: True for real A/D streams (rx888 etc.), False for complex IQ
    """

    L: int
    M: int
    real: bool = True

    @property
    def N(self) -> int:
        return self.L + self.M - 1

    @property
    def bins(self) -> int:
        """Number of master frequency bins (N/2+1 for real, N for complex)."""
        return self.N // 2 + 1 if self.real else self.N

    @property
    def overlap(self) -> int:
        """Overlap factor V = N/(M-1) (5 for the default 20% overlap)."""
        return 1 + self.L // (self.M - 1)

    @classmethod
    def from_rate(cls, samprate: float, blocktime: float = 0.02, overlap: int = 5,
                  real: bool = True) -> "MasterConfig":
        """Size L, M from sample rate and block time (radio.c:644-652)."""
        L = int(round(samprate * blocktime))
        M = L // (overlap - 1) + 1
        return cls(L=L, M=M, real=real)


def master_transform(cfg: MasterConfig, x: torch.Tensor) -> torch.Tensor:
    """Forward transform of one assembled [N] window -> [bins] complex64."""
    return torch.fft.rfft(x) if cfg.real else torch.fft.fft(x)


def master_init(cfg: MasterConfig, device=None):
    """Fresh master state: the (M-1)-sample tail (zeros) and block counter."""
    dtype = torch.float32 if cfg.real else torch.complex64
    return {
        "tail": torch.zeros(cfg.M - 1, dtype=dtype, device=device),
        "jobnum": torch.zeros((), dtype=torch.int32, device=device),
    }


def master_fft(cfg: MasterConfig, state, block: torch.Tensor):
    """Run the shared forward FFT over one input block.

    block: [L] float32 (real) or complex64 (complex) new samples.
    Returns (new_state, F): F is the [bins] complex64 spectrum of the
    N-point window [previous M-1 samples | block]. Batches over leading
    axes: [B, L] blocks with a [B, M-1] tail give [B, bins] spectra.
    """
    x = torch.cat([state["tail"], block], dim=-1)
    F = master_transform(cfg, x)
    new_state = {"tail": x[..., cfg.L:], "jobnum": state["jobnum"] + 1}
    return new_state, F


def tile_plan(n_bins: int) -> int:
    """Number of _CTILE rows covering an n_bins slice at any offset."""
    return -(-n_bins // _CTILE) + 1


def tiled_idft_matrix(n_bins: int, olen: int, S: int) -> np.ndarray:
    """[S, olen] natural-order IDFT producing the LAST olen samples.

    E'[j, t] = exp(2j pi (j - n//2) t / n) / n for t in [n-olen, n); the
    matrix is defined for all j < S so one shared constant serves every
    offset.
    """
    j = np.arange(S, dtype=np.float64)[:, None]
    t = np.arange(n_bins - olen, n_bins, dtype=np.float64)[None, :]
    return (np.exp(2j * np.pi * ((j - n_bins // 2) * t % n_bins) / n_bins) / n_bins).astype(np.complex64)


def build_tile_params(responses: np.ndarray, shifts: np.ndarray, real_master: bool,
                      master_N: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side tile-frame layout of channel responses (numpy).

    responses: [C, n_bins] complex64 FFT-order responses.
    shifts: [C] int32 coarse bin shifts.
    Returns (resp_tiles [C, S] c64, tile_lo [C] i32, slope [C] i32): the
    padded responses (validity-zeroed, conj-reversed for inverted slices),
    each channel's first tile row, and the phase-ramp slope s_c.
    """
    C, n = responses.shape
    T = _CTILE
    S = tile_plan(n) * T
    m_bins = master_N // 2 + 1 if real_master else master_N
    n_rows = -(-m_bins // T) if real_master else m_bins // T
    resp_tiles = np.zeros((C, S), np.complex64)
    tile_lo = np.zeros(C, np.int32)
    slope = np.zeros(C, np.int32)
    m = np.arange(n)
    c1 = (n + 1) // 2 - 1  # ceil(n/2) - 1
    # natural-order response: resp_nat[m] = resp[(m - n//2) mod n]
    for c in range(C):
        sh = int(shifts[c])
        inverted = real_master and sh < 0
        if not inverted:
            lo = sh - n // 2
            vals = responses[c][(m - n // 2) % n]
            bins = lo + m
        else:
            lo = -sh - c1  # ascending window of the mirrored slice
            vals = np.conj(responses[c][(c1 - m) % n])
            bins = lo + m  # mirrored master bin index (>= 0 side)
        if real_master:
            valid = (bins >= 0) & (bins < m_bins)
        else:
            half = master_N // 2
            valid = (bins >= -half) & (bins <= (master_N - 1) // 2)
        lt = lo >> 7 if T == 128 else lo // T  # floor division
        if real_master:
            lt = min(max(lt, 0), max(n_rows - S // T, 0))
        o = lo - lt * T
        j = o + m
        ok = valid & (j >= 0) & (j < S)
        resp_tiles[c, j[ok]] = np.where(ok, vals, 0)[ok]
        tile_lo[c] = lt
        slope[c] = (o + c1 - n // 2) if inverted else -o
    return resp_tiles, tile_lo, slope


def _take(F: torch.Tensor, idx: torch.Tensor, inputs: torch.Tensor | None) -> torch.Tensor:
    """F[idx] of one spectrum, or with `inputs` [C] F[inputs[c], idx[c]] of
    the [B, ld] spectra (idx [C, ...])."""
    if inputs is None:
        return F[idx]
    return F[inputs.to(torch.int64).reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def tiled_channelize(F: torch.Tensor, resp_tiles: torch.Tensor, tile_lo: torch.Tensor,
                     slope: torch.Tensor, shifts: torch.Tensor, E: torch.Tensor | None,
                     n_bins: int, olen: int, real_master: bool, master_N: int,
                     inputs: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch tiled channelizer (see module docstring).

    F: [m_bins] complex64, or [B, ld >= m_bins] with `inputs` [C] naming
    each channel's row (the bins past m_bins are not read); resp_tiles
    [C, S] c64, tile_lo/slope/shifts [C] int32 (from build_tile_params); E
    [S, olen] c64 (tiled_idft_matrix), or None for the FFT-IDFT form of
    wideband slices (WFM's 9,600-bin composite, whose [S, olen] constant
    would take hundreds of MB): E'[j, t] is periodic in j with period
    n_bins, so the padded frame folds S -> n_bins (valid while S - n_bins
    <= n_bins), rotates by n_bins//2 (natural -> FFT order) and goes through
    one batched inverse FFT (cuFFT on the card); the engine calls this form
    directly, on the card too.
    Returns [C, olen] complex64 baseband (before fine tuning).
    """
    T = _CTILE
    C, S = resp_tiles.shape
    ntiles = S // T
    m_bins = master_N // 2 + 1 if real_master else master_N
    t_idx = torch.arange(ntiles, dtype=torch.int64, device=F.device)[None, :]
    lo = tile_lo.to(torch.int64)[:, None]
    Fm = F[..., :m_bins]
    if real_master:
        # rows of a real master clamp inside [DC, Nyquist]; its last row is
        # zero past m_bins
        Fm = torch.nn.functional.pad(Fm, (0, (-m_bins) % T))
        tidx = torch.clamp(lo + t_idx, 0, Fm.shape[-1] // T - 1)
    else:
        if m_bins % T:
            raise ValueError(f"complex master of {m_bins} bins is not whole {T}-bin tiles")
        tidx = torch.remainder(lo + t_idx, m_bins // T)
    rows = Fm.reshape(Fm.shape[:-1] + (-1, T))
    cover = _take(rows, tidx, inputs).reshape(C, S)
    x = cover * resp_tiles
    if E is None:
        n = n_bins
        if S - n > n:
            raise ValueError(f"the FFT-IDFT fold needs S - n_bins <= n_bins (S {S}, n {n})")
        y = x[:, :n].clone()
        y[:, : S - n] += x[:, n:]
        Y = torch.fft.ifft(torch.roll(y, -(n // 2), dims=-1))[:, n - olen:]
    else:
        Y = x @ E
    if real_master:
        Y = torch.where((shifts < 0)[:, None], Y.conj(), Y)
    t_abs = torch.arange(n_bins - olen, n_bins, dtype=torch.int64, device=F.device)[None, :]
    ph = torch.remainder(slope.to(torch.int64)[:, None] * t_abs, n_bins).to(torch.float32)
    ang = ph * float(np.float32(2.0 * np.pi / n_bins))
    return Y * torch.complex(torch.cos(ang), torch.sin(ang))


def _signed_bins(n_bins: int, device) -> torch.Tensor:
    """Output bin index -> signed baseband frequency bin (FFT order), [1, n]."""
    k = torch.arange(n_bins, dtype=torch.int64, device=device)
    return torch.where(k < (n_bins + 1) // 2, k, k - n_bins)[None, :]


def gather_bins(F: torch.Tensor, shifts: torch.Tensor, n_bins: int, real_master: bool,
                master_N: int, inputs: torch.Tensor | None = None) -> torch.Tensor:
    """Each channel's slice of master bins, before its response: the four
    cases of filter.c:695-860. A real master's slice is zero outside
    [0, N/2], and for a negative shift inverted and conjugated (high-side
    LO); a complex master's wraps through DC and is zero past the master
    Nyquist. F and inputs as in tiled_channelize.
    Returns [C, n_bins] complex64 in FFT order."""
    g = shifts.to(torch.int64)[:, None] + _signed_bins(n_bins, F.device)
    if real_master:
        m_bins = master_N // 2 + 1
        inverted = (shifts < 0)[:, None]
        mi = torch.where(inverted, -g, g)
        valid = (mi >= 0) & (mi < m_bins)
        vals = _take(F, torch.clamp(mi, 0, m_bins - 1), inputs)
        vals = torch.where(inverted, vals.conj(), vals)
    else:
        valid = (g >= -(master_N // 2)) & (g <= (master_N - 1) // 2)
        vals = _take(F, torch.remainder(g, master_N), inputs)
    return torch.where(valid, vals, 0.0)


def isb_unpack(fd: torch.Tensor) -> torch.Tensor:
    """Independent sideband: LSB/USB of [C, n] FFT-order bins into I/Q
    (filter.c:862-876): pos' = pos + conj(neg), neg' = neg - conj(pos),
    DC = 0."""
    n = fd.shape[-1]
    rev = torch.flip(torch.roll(fd, -1, dims=-1), dims=[-1]).conj()  # bin -k for each k
    k = torch.arange(n, device=fd.device)[None, :]
    return torch.where((k >= 1) & (k < n // 2), fd + rev,
                       torch.where(k > n // 2, fd - rev, torch.where(k == 0, 0.0, fd)))


def finish_channelize(fd: torch.Tensor, olen: int, isb: bool = False) -> torch.Tensor:
    """After the gather and the response: the optional ISB unpack, a batched
    inverse FFT (cuFFT on the card), the overlap discarded.
    Returns [C, olen] complex64."""
    n = fd.shape[-1]
    if isb:
        fd = isb_unpack(fd)
    return torch.fft.ifft(fd, dim=-1)[:, n - olen:]


def channelize(F: torch.Tensor, responses: torch.Tensor, shifts: torch.Tensor, olen: int,
               real_master: bool, master_N: int, isb: bool = False,
               inputs: torch.Tensor | None = None) -> torch.Tensor:
    """The per-element channelizer: gather_bins x responses [C, n_bins],
    then finish_channelize. The engine's path for what the tiled form does
    not cover (small or odd complex masters). Returns [C, olen] complex64
    baseband (before fine tuning)."""
    fd = gather_bins(F, shifts, responses.shape[-1], real_master, master_N, inputs) * responses
    return finish_channelize(fd, olen, isb)


def channelize_beam(F: torch.Tensor, responses: torch.Tensor, shifts: torch.Tensor, olen: int,
                    master_N: int, alpha: torch.Tensor, beta: torch.Tensor,
                    inputs: torch.Tensor | None = None) -> torch.Tensor:
    """Dual-antenna beamforming channelizer (filter.c:723-742): two real
    antennas ride the I and Q rails of one complex master (the Fobos
    independent-input mode), and each output bin combines the master bin
    and the conjugate of its mirror with per-channel complex weights,
        out[k] = (alpha F[rp] + beta conj(F[-rp])) response[k];
    DC and Nyquist carry the two antennas as their real and imaginary
    parts. alpha/beta [C] complex64; F and inputs as in tiled_channelize.
    Returns [C, olen] complex64."""
    nb = responses.shape[-1]
    g = shifts.to(torch.int64)[:, None] + _signed_bins(nb, F.device)
    valid = (g >= -(master_N // 2)) & (g <= (master_N - 1) // 2)
    rp = torch.remainder(g, master_N)
    f_rp = _take(F, rp, inputs)
    f_mir = _take(F, torch.remainder(master_N - rp, master_N), inputs)
    a, b = alpha[:, None], beta[:, None]
    vals = a * f_rp + b * f_mir.conj()
    special = (rp == 0) | (rp == master_N // 2)
    sval = a * f_rp.real + b * f_rp.imag
    fd = torch.where(valid, torch.where(special, sval, vals), 0.0) * responses
    return torch.fft.ifft(fd, dim=-1)[:, nb - olen:]


def fine_tune(bb: torch.Tensor, acc_q32: torch.Tensor, inc_q32: torch.Tensor,
              adj_q32: torch.Tensor):
    """Apply per-channel fine-tuning NCO + block phase adjustment.

    bb: [C, olen] complex64; acc/inc/adj: [C] int32 Q32 revolutions. adj is
    the per-block Renfors eq.(12) phase rotation for bin shifts not
    divisible by the overlap factor (radio.c:1524-1541), pre-added to the
    accumulator each block. Returns (bb_tuned, new_acc).
    """
    acc = wrap_i32(acc_q32.to(torch.int64) + adj_q32.to(torch.int64))
    ramp, new_acc = phase_ramp_q32(acc, inc_q32, bb.shape[-1])
    return bb * ramp, new_acc


# ---------------------------------------------------------------------------
# Host-side tuning arithmetic (exact, Python ints / float64)
# ---------------------------------------------------------------------------


def compute_tuning(N: int, samprate: float, freq: float):
    """freq (Hz) -> (bin shift, remainder Hz, in_range) (radio.c:1216-1241).

    shift = lrint(freq/binwidth); remainder = freq - shift*binwidth.
    in_range is False when |shift| >= N/2 (outside front-end coverage).
    """
    hzperbin = samprate / N
    shift = int(round(freq / hzperbin))
    remainder = freq - shift * hzperbin
    return shift, remainder, abs(shift) < N // 2


def block_phase_adjust_q32(shift: int, L: int, N: int) -> np.int32:
    """Per-block phase rotation cancelling the slice phase advance.

    A carrier on master bin `shift` advances by shift*L/N revolutions per
    block hop; the canceling rotation is -(shift*L/N) mod 1, computed exactly
    with integer arithmetic (equivalent to radio.c:1529 cispi(2(shift%V)/V)
    when V | N).
    """
    q = ((-shift * L) % N) * (1 << 32) // N
    q &= 0xFFFFFFFF
    return np.int32(q - (1 << 32) if q >= (1 << 31) else q)
