"""The plain reference of the benchmark: what radiod's RTP audio should be.

Plain PyTorch and NumPy, written from the receiver's published semantics
(ka9q-radio's filter.c overlap-save filter bank, radio.c's N0 estimate,
audio.c's s16 packets). It imports nothing of the program under test: it
works out again, from the same input blocks the program was handed, every
channel's coarse and fine tuning, its filter response, the master spectra
and the noise floors. What a channel does with its baseband (statistics,
squelch, gain, the detector's output and its rails) is its group's detector,
detectors/<demod>.py, found by the group's `demod` (named.py): linear.py
(linear.c's block AGC and squelch), fm.py (fm.c's discriminator).

A detector module gives:
    constants(spec, g) -> dict    what it reads from the group's entry (g.k)
    window_stats(g, bb, m) -> {name: [K] tensor}   per distinct window, from
                                  the [K, olen] baseband before fine tuning
    decide(g, stats, floors, blocks) -> {"send", "mute": [blocks, K] bool,
                                  "rails": int or [blocks, K] int, ...}
                                  floors yields (b, window s, [K] N0)
    output(g, d, bs, bb, before) -> (x [len(bs), K, P, olen], gain
                                  [len(bs), K, olen]) of fine-tuned bb;
                                  before() is the [K] last sample of bs[0]-1
    fault(spec) -> spec           the group entry with the gain fault the
                                  control plants

The default precision is float64. `Reference(..., dtype=torch.float32,
tf32=True)` is the control: the same arithmetic in float32 with the channel
IDFT as a matrix product whose operands are rounded to TF32 (10-bit
mantissa), the precision a faster channelizer kernel would be tempted to
drop to.

Input model: block b of the stream is ring[b % R] (the benchmark's ring of
R distinct blocks: [R, L] real, or [R, L] complex for a complex master, I
the real part); the master window of block b is the last M-1 samples of
block b-1 (zeros before block 0) followed by block b, so there are R + 1
distinct master spectra, and the per-block work is the recurrences.
"""
from __future__ import annotations

import dataclasses
import math
import re

import numpy as np
import torch

from named import module

__all__ = ["parse_freq", "Reference", "Master", "expand_channels", "round_tf32",
           "noise_correction", "design_response", "db_v", "db_p", "POWER_ALPHA"]

_MULT = {"k": 1e3, "m": 1e6, "g": 1e9}
_Q32 = 1 << 32
NQ, N_CUTOFF, POWER_ALPHA, MIN_NOISE_BINS, TILE = 0.10, 1.5, 0.10, 1000, 128


def parse_freq(s) -> float:
    """'14m095600' -> 14095600.0 (a ka9q frequency with its unit as the radix),
    or a plain number in Hz; the same float arithmetic radiod's parser uses."""
    if isinstance(s, (int, float)):
        return float(s)
    m = re.fullmatch(r"(\d*)([kmg])(\d*)", s.strip().lower())
    if m is None:
        return float(s)
    whole, mult, frac = m.groups()
    return float(f"{whole or '0'}.{frac}" if frac else whole or "0") * _MULT[mult]


def expand_channels(group: dict) -> list[float]:
    """A group's channel frequencies, in order: `freq` (a list) or `raster`
    [start, stop, step] with the stop excluded."""
    if "raster" in group:
        start, stop, step = (parse_freq(t) for t in group["raster"])
        out, f = [], start
        while f < stop:
            out.append(f)
            f += step
        return out
    return [parse_freq(f) for f in group["freq"]]


def kaiser(M: int, beta: float) -> np.ndarray:
    n = np.arange(M, dtype=np.float64)
    x = 2.0 * n / (M - 1) - 1.0
    return np.i0(beta * np.sqrt(np.maximum(0.0, 1.0 - x * x))) / np.i0(beta)


def design_response(n: int, olen: int, low: float, high: float, beta: float, real_master: bool,
                    master_points: int) -> np.ndarray:
    """A channel's frequency response (filter.c set_filter): a Kaiser-windowed
    sinc of the passband [low, high] (fractions of the output rate) in the
    first M = n - olen + 1 taps, its n-point FFT, with the gains that make the
    channel IDFT's output the input's baseband (1/window gain, 1/master
    points, +3 dB on a real master, x n for the normalized IDFT) and the
    channel's Nyquist bin zeroed."""
    M = n - olen + 1
    low, high = min(low, high), max(low, high)
    low, high = min(max(low, -0.5), 0.5), min(max(high, -0.5), 0.5)
    bw2 = 1e-4 if high == low else (high - low) / 2.0
    center = (high + low) / 2.0
    t = np.arange(M, dtype=np.float64) - (M - 1) / 2.0
    r = kaiser(M, beta) * 2.0 * bw2 * np.sinc(2.0 * bw2 * t)
    gain = (math.sqrt(2.0) if real_master else 1.0) / (float(np.sum(r)) * master_points) * n
    impulse = np.zeros(n, np.complex128)
    impulse[:M] = r * gain * np.exp(2j * np.pi * center * t)
    resp = np.fft.fft(impulse)
    resp[(n + 1) // 2] = 0.0
    return resp


def noise_correction(q: float = NQ, cutoff: float = N_CUTOFF) -> float:
    """Unbiasing factor of the mean of exponential energies below cutoff x
    their q-quantile (radio.c)."""
    z = cutoff * (-math.log(1.0 - q))
    return 1.0 / (1.0 - z * math.exp(-z) / (1.0 - math.exp(-z)))


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (10 mantissa bits, to nearest, ties away)."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


@dataclasses.dataclass(frozen=True)
class Master:
    fs: int
    L: int
    M: int
    real: bool

    @classmethod
    def of(cls, fs: float, blocktime: float = 0.02, overlap: int = 5, real: bool = True):
        """A real master of N points has N/2 + 1 bins; a complex one N."""
        L = int(round(fs * blocktime))
        return cls(int(round(fs)), L, L // (overlap - 1) + 1, real)

    @classmethod
    def of_entry(cls, ref: dict):
        """The master of a configuration's reference entry."""
        return cls.of(parse_freq(ref["samprate"]), ref.get("blocktime", 0.02),
                      ref.get("overlap", 5), ref.get("real", True))

    @property
    def N(self) -> int:
        return self.L + self.M - 1

    @property
    def bins(self) -> int:
        return self.N // 2 + 1 if self.real else self.N


def db_v(db: float) -> float:
    return 10.0 ** (db / 20.0)


def db_p(db: float) -> float:
    return 10.0 ** (db / 10.0)


class _Group:
    """One rate class: its channels' tuning, responses and noise windows,
    its detector and the detector's constants (`k`), from the config's
    reference description. On a complex master each channel's shift is
    signed, from its frequency less the tuner's centre."""

    def __init__(self, spec: dict, m: Master, center: float = 0.0):
        self.name = spec["name"]
        self.demod = spec["demod"]
        self.det = module("detectors", self.demod)
        self.rate = int(spec["samprate"])
        self.freqs = expand_channels(spec)
        self.C = len(self.freqs)
        if (m.N * self.rate) % m.fs or (m.L * self.rate) % m.fs:
            raise ValueError(f"{self.name}: output rate not commensurate with the master")
        self.n = m.N * self.rate // m.fs
        self.olen = m.L * self.rate // m.fs
        self.low, self.high = float(spec["low"]), float(spec["high"])
        self.bandwidth = abs(self.high - self.low)
        hz = m.fs / m.N
        self.shift = np.zeros(self.C, np.int64)
        self.inc = np.zeros(self.C, np.int64)
        self.adj = np.zeros(self.C, np.int64)
        for i, f in enumerate(self.freqs):
            f = f - center
            sh = int(round(f / hz))
            rem = f - sh * hz
            if not (0 <= sh < m.N // 2 if m.real else abs(sh) < m.N // 2):
                raise ValueError(f"{self.name}: {f + center} Hz outside the master's band")
            self.shift[i] = sh
            self.inc[i] = int(round(((-rem / self.rate) % 1.0) * _Q32)) & (_Q32 - 1)
            self.adj[i] = ((-sh * m.L) % m.N) * _Q32 // m.N
        self.resp = design_response(self.n, self.olen, self.low / self.rate, self.high / self.rate,
                                    float(spec.get("kaiser_beta", 11.0)), m.real, m.N)
        # the N0 window: the channel's bins widened to MIN_NOISE_BINS, on the
        # 128-bin grid where whole tiles fit the master; a complex master's
        # around the signed shift inside the signed band (noise_cols wraps
        # its bins through DC)
        nb = min(m.bins, max(self.n, MIN_NOISE_BINS))
        tiled = m.bins >= -(-nb // TILE) * TILE and (m.real or m.bins % TILE == 0)
        self.W = -(-nb // TILE) * TILE if tiled else nb
        if m.real:
            lo = np.clip(np.abs(self.shift) - self.W // 2, 0, max(m.bins - self.W, 0))
        else:
            lo = np.clip(self.shift - self.W // 2, -(m.bins // 2), (m.bins - 1) // 2 - (self.W - 1))
        self.noise_lo = lo // TILE * TILE if tiled else lo
        self.k = self.det.constants(spec, self)


class Reference:
    """The reference receiver for one configuration (its `reference` entry:
    master rate and groups) over one ring of input blocks.

    ring: [R, L] blocks, real or (a complex master) complex, the exact
    values handed to the program. The methods run the stream's blocks
    0..B-1 (block b = ring[b % R])."""

    def __init__(self, ref: dict, ring: torch.Tensor, device=None, dtype=torch.float64,
                 tf32: bool = False):
        self.m = Master.of_entry(ref)
        self.noise_every = int(ref.get("noise_every", 4))
        self.device = torch.device(device) if device is not None else ring.device
        self.rdt = dtype
        self.cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
        self.tf32 = tf32
        center = parse_freq(ref.get("frequency", 0.0))
        self.groups = [_Group(g, self.m, center) for g in ref["groups"]]
        self.ring = ring
        self.R = ring.shape[0]
        if ring.shape[-1] != self.m.L:
            raise ValueError(f"ring blocks of {ring.shape[-1]} samples, the master takes {self.m.L}")
        self._spec_cache: dict = {}

    # ---------------------------------------------------------------- tuning
    def ssrcs(self) -> dict[str, np.ndarray]:
        """Each group's channel SSRCs: the frequency in kHz, rounded, bumped
        past a taken one, in config order."""
        taken, out = set(), {}
        for g in self.groups:
            s = np.zeros(g.C, np.int64)
            for i, f in enumerate(g.freqs):
                v = int(round(f / 1000.0))
                while v in taken:
                    v += 1
                taken.add(v)
                s[i] = v
            out[g.name] = s
        return out

    # --------------------------------------------------------------- spectra
    def spectrum_index(self, b: int) -> int:
        """Which distinct master window block b has: R for block 0 (a zero
        tail), else b % R."""
        return self.R if b == 0 else b % self.R

    def spectrum(self, s: int) -> torch.Tensor:
        """The master spectrum of distinct window s (spectrum_index)."""
        F = self._spec_cache.get(s)
        if F is not None:
            return F
        m = self.m
        dt = self.rdt if m.real else self.cdt
        cur = self.ring[0 if s == self.R else s].to(self.device, dt)
        if s == self.R:
            tail = torch.zeros(m.M - 1, dtype=dt, device=self.device)
        else:
            tail = self.ring[(s - 1) % self.R, m.L - (m.M - 1):].to(self.device, dt)
        x = torch.cat([tail, cur])
        F = self._spec_cache[s] = torch.fft.rfft(x) if m.real else torch.fft.fft(x)
        return F

    def _gather(self, g: _Group, idx: np.ndarray) -> tuple:
        """(bins [K, n], valid [K, n], response [n]) of channels idx: each
        channel's master bins in FFT order around its shift (a complex
        master's wrap through DC and stop at its Nyquist)."""
        k = np.arange(g.n)
        signed = np.where(k < (g.n + 1) // 2, k, k - g.n)
        b = g.shift[idx][:, None] + signed[None, :]
        N = self.m.N
        if not self.m.real:
            valid = (b >= -(N // 2)) & (b <= (N - 1) // 2)
            return (torch.as_tensor(b % N, device=self.device),
                    torch.as_tensor(valid, device=self.device),
                    torch.as_tensor(g.resp, dtype=self.cdt, device=self.device))
        valid = (b >= 0) & (b < self.m.bins)
        return (torch.as_tensor(np.clip(b, 0, self.m.bins - 1), device=self.device),
                torch.as_tensor(valid, device=self.device),
                torch.as_tensor(g.resp, dtype=self.cdt, device=self.device))

    def _slice(self, F: torch.Tensor, gather: tuple) -> torch.Tensor:
        """[K, n] master bins of a gather times the response."""
        bt, valid, resp = gather
        return F[bt] * valid * resp

    def _idft(self, x: torch.Tensor, g: _Group) -> torch.Tensor:
        """The last olen samples of the n-point inverse DFT of [K, n] x."""
        if not self.tf32:
            return torch.fft.ifft(x, dim=-1)[:, g.n - g.olen:]
        k = torch.arange(g.n, dtype=torch.float64, device=self.device)[:, None]
        t = torch.arange(g.n - g.olen, g.n, dtype=torch.float64, device=self.device)[None, :]
        ang = 2.0 * math.pi * torch.remainder(k * t, g.n) / g.n
        Er, Ei = round_tf32(torch.cos(ang) / g.n), round_tf32(torch.sin(ang) / g.n)
        xr, xi = round_tf32(x.real), round_tf32(x.imag)
        return torch.complex(xr @ Er - xi @ Ei, xr @ Ei + xi @ Er).to(self.cdt)

    def baseband(self, s: int, g: _Group, gather: tuple) -> torch.Tensor:
        """[K, olen] baseband before fine tuning of window s, for the
        channels of `gather` (_gather)."""
        return self._idft(self._slice(self.spectrum(s), gather), g)

    def noise_cols(self, g: _Group, idx: np.ndarray) -> torch.Tensor:
        """[K, W] master bins of the N0 windows of channels idx."""
        cols = g.noise_lo[idx][:, None] + np.arange(g.W)
        cols = np.clip(cols, 0, self.m.bins - 1) if self.m.real else cols % self.m.bins
        return torch.as_tensor(cols, device=self.device)

    def noise_estimate(self, s: int, g: _Group, cols: torch.Tensor) -> torch.Tensor:
        """[K] N0 (power/Hz) of window s over the windows `cols`: the mean of
        the bin energies below 1.5 x their 10% quantile, unbiased, over the
        master's bins x its rate."""
        F = self.spectrum(s)
        e = F.real[cols] ** 2 + F.imag[cols] ** 2
        srt = torch.sort(e, dim=-1).values
        pos = NQ * (g.W - 1)
        i = int(math.floor(pos))
        frac = pos - i
        q = srt[:, i] * (1.0 - frac) + srt[:, min(i + 1, g.W - 1)] * frac
        mask = e <= (N_CUTOFF * q)[:, None]
        mean = torch.where(mask, e, 0.0).sum(-1) / torch.clamp(mask.sum(-1), min=1)
        return mean * noise_correction() / (float(self.m.bins) * float(self.m.fs))

    # ---------------------------------------------------------------- state
    def _due(self, b: int) -> bool:
        return b < 2 or self.noise_every == 1 or b % self.noise_every == 0

    def _stats(self, g: _Group, idx: np.ndarray, blocks: int) -> dict:
        """What the block decisions read, per distinct window s (the
        fine-tuning phasors leave every magnitude as it is): the detector's
        statistics of the channels' baseband (window_stats), and N0
        estimates on the windows of due blocks. {name: {s: [K] float64
        numpy}}."""
        used = sorted({self.spectrum_index(b) for b in range(blocks)})
        due = {self.spectrum_index(b) for b in range(blocks) if self._due(b)}
        out: dict = {"n0": {}}
        for lo in range(0, len(idx), 4096):
            part = idx[lo:lo + 4096]
            gather, cols = self._gather(g, part), self.noise_cols(g, part)
            for s in used:
                vals = g.det.window_stats(g, self.baseband(s, g, gather), self.m)
                if s in due:
                    vals["n0"] = self.noise_estimate(s, g, cols)
                for k, v in vals.items():
                    out.setdefault(k, {}).setdefault(s, []).append(v.double().cpu().numpy())
        return {k: {s: np.concatenate(v) for s, v in d.items()} for k, d in out.items()}

    def _floors(self, stats: dict, blocks: int):
        """(b, window s, [K] N0) for blocks 0..blocks-1, in float64 on the
        host: N0 re-seeded while the master warms up, then an EMA on the
        cadence."""
        a = 1.0 - (1.0 - POWER_ALPHA) ** self.noise_every
        n0 = None
        for b in range(blocks):
            s = self.spectrum_index(b)
            if self._due(b):
                est = stats["n0"][s]
                n0 = est if b < 2 else np.where(n0 <= 0, est, n0 + a * (est - n0))
            yield b, s, n0

    def _decide(self, g: _Group, idx: np.ndarray, blocks: int) -> dict:
        """The detector's per-block decisions of channels idx for blocks
        0..blocks-1: [blocks, K] "send", "mute" and "rails", and what else
        its output reads."""
        stats = self._stats(g, idx, blocks)
        d = g.det.decide(g, stats, self._floors(stats, blocks), blocks)
        d["rails"] = np.broadcast_to(np.asarray(d["rails"], np.int64), d["send"].shape)
        return d

    # ------------------------------------------------------------- sends
    def decisions(self, blocks: int, first: int = 0) -> dict[str, dict]:
        """Every channel's squelch `send` flag (a packet due) and payload
        rails for blocks first..blocks-1: {group: {"send": [blocks - first,
        C] bool, "rails": [blocks - first, C] int}}."""
        out = {}
        for g in self.groups:
            d = self._decide(g, np.arange(g.C), blocks)
            out[g.name] = {"send": d["send"][first:], "rails": d["rails"][first:]}
        return out

    def sends(self, blocks: int, first: int = 0) -> dict[str, np.ndarray]:
        """{group: [blocks - first, C] bool} of decisions()."""
        return {g: d["send"] for g, d in self.decisions(blocks, first).items()}

    # ------------------------------------------------------------- audio
    def audio(self, group: str, idx, blocks: int, first: int = 0) -> dict:
        """Channels idx of `group` for blocks first..blocks-1, as numpy:
        "x" [B', K, P, olen] the detector's output before the gain on each
        of its P rails (USB: the I rail; I/Q: I and Q; NBFM: the phase step
        in half revolutions), "gain" [B', K, olen] the gain applied to it,
        "audio" their product with muted blocks zero, "rails" [B', K] the
        rails of each block's payload (the first of the P), and "mute",
        "send" [B', K]."""
        g = next(gr for gr in self.groups if gr.name == group)
        idx = np.asarray(idx, np.int64)
        d = self._decide(g, idx, blocks)
        gather = self._gather(g, idx)
        spectra = sorted({self.spectrum_index(b) for b in range(blocks)})
        pre = torch.stack([self.baseband(s, g, gather) for s in spectra])
        slot = {s: i for i, s in enumerate(spectra)}
        xs, gs = [], []
        for b0 in range(first, blocks, 256):
            bs = list(range(b0, min(b0 + 256, blocks)))
            bb = pre[[slot[self.spectrum_index(b)] for b in bs]] * self._ramps(g, idx, bs)

            def before(b0=b0):
                if b0 == 0:
                    return torch.zeros(len(idx), dtype=self.cdt, device=self.device)
                return self._last(g, idx, b0 - 1, pre[slot[self.spectrum_index(b0 - 1)]])

            x, gain = g.det.output(g, d, bs, bb, before)
            xs.append(x.double().cpu().numpy())
            gs.append(gain.double().cpu().numpy())
        x, gain = np.concatenate(xs), np.concatenate(gs)
        mute = d["mute"][first:blocks]
        return {"x": x, "gain": gain,
                "audio": np.where(mute[..., None, None], 0.0, gain[:, :, None] * x),
                "rails": d["rails"][first:blocks], "mute": mute, "send": d["send"][first:blocks]}

    def _phase_q32(self, g: _Group, idx: np.ndarray, bs, t) -> torch.Tensor:
        """Q32 NCO phase words of blocks bs at samples t: (b + 1) adj +
        (b olen + t) inc, exact mod 2^32. [len(bs), K, len(t)]."""
        adj = torch.as_tensor(g.adj[idx], device=self.device)[None, :, None]
        inc = torch.as_tensor(g.inc[idx], device=self.device)[None, :, None]
        b = torch.as_tensor(list(bs), dtype=torch.int64, device=self.device)[:, None, None]
        t = torch.as_tensor(t, dtype=torch.int64, device=self.device)[None, None, :]
        return torch.remainder((b + 1) * adj + (b * g.olen + t) * inc, _Q32)

    def _ramps(self, g: _Group, idx: np.ndarray, bs) -> torch.Tensor:
        """[len(bs), K, olen] fine-tuning phasors of blocks bs."""
        ang = self._phase_q32(g, idx, bs, np.arange(g.olen)).to(torch.float64) * (2 * math.pi / _Q32)
        return torch.polar(torch.ones_like(ang), ang).to(self.cdt)

    def _last(self, g: _Group, idx: np.ndarray, b: int, pre_b: torch.Tensor) -> torch.Tensor:
        """[K] the last fine-tuned sample of block b."""
        ang = self._phase_q32(g, idx, [b], [g.olen - 1]).to(torch.float64) * (2 * math.pi / _Q32)
        return (pre_b[:, -1] * torch.polar(torch.ones_like(ang), ang).to(self.cdt)[0, :, 0])
