"""Synthetic signal-generator front end, on the engine's device.

The reference's sig_gen driver (sig_gen.c): a carrier of settable frequency
and amplitude plus calibrated Gaussian noise of settable spectral density
N0, real or complex, optionally FM- or AM-modulated by a tone. The carrier
phase is a Q32 word (ops/osc.py), so it never drifts. The noise comes from
an explicit torch.Generator on the device, seeded like the JAX package's
PRNG key (`seed`, default 0); the two noise streams are different draws
of the same distribution, not the same numbers.

Noise calibration (sig_gen.c:150-156): N0 is power per Hz relative to full
scale. A real stream of rate fs carries fs/2 Hz of (one-sided) bandwidth,
so the sample variance is N0*fs/2; a complex stream carries fs Hz, variance
N0*fs split evenly between I and Q.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.osc import phase_ramp_q32, rev_to_q32, wrap_i32
from ..utils.device import resolve_device

__all__ = ["SigGenConfig", "siggen_init", "siggen_block", "multi_tone_block"]


@dataclasses.dataclass(frozen=True)
class SigGenConfig:
    """Static generator parameters (config keys: sig_gen.c:36-49)."""

    samprate: float
    real: bool = True
    carrier_hz: float = 10_000_000.0
    amplitude: float = 0.1  # full-scale fraction (config is dBFS)
    noise_n0: float = 0.0  # power/Hz (config is dBFS/Hz); 0 = off
    # optional tone modulation
    fm_deviation_hz: float = 0.0  # peak deviation; 0 = no FM
    am_depth: float = 0.0  # 0..1; 0 = no AM
    tone_hz: float = 1000.0

    @property
    def noise_std(self) -> float:
        if self.noise_n0 <= 0:
            return 0.0
        bw = self.samprate / 2.0 if self.real else self.samprate
        return float(np.sqrt(self.noise_n0 * bw))


def siggen_init(cfg: SigGenConfig, seed: int = 0, device=None):
    """Carried generator state: carrier and tone phases (Q32 words) and the
    noise generator. device None means CUDA."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return {
        "phase": torch.zeros((1,), dtype=torch.int32, device=dev),
        "tone_phase": torch.zeros((1,), dtype=torch.int32, device=dev),
        "gen": gen,
    }


def siggen_block(cfg: SigGenConfig, state, L: int):
    """Generate one block of L samples.

    Returns (new_state, samples): float32 [L] (real) or complex64 [L].
    """
    dev = state["phase"].device
    st = {"gen": state["gen"]}
    tone_inc = torch.full((1,), int(rev_to_q32(cfg.tone_hz / cfg.samprate)), dtype=torch.int32,
                          device=dev)
    carrier_inc = torch.full((1,), int(rev_to_q32(cfg.carrier_hz / cfg.samprate)),
                             dtype=torch.int32, device=dev)

    if cfg.fm_deviation_hz > 0.0:
        # FM: integrate deviation*tone into the carrier phase exactly in Q32
        tone_ramp, st["tone_phase"] = phase_ramp_q32(state["tone_phase"], tone_inc, L)
        dev_rev = float(np.float32(cfg.fm_deviation_hz / cfg.samprate))  # peak revs/sample
        dphi = dev_rev * tone_ramp.real[0]
        # deviation << fs, so |dphi| << 0.5 rev and the Q32 step fits int32
        dphi_q32 = torch.round(dphi * float(2.0 ** 32)).to(torch.int64)
        steps = torch.arange(1, L + 1, dtype=torch.int64, device=dev)
        phase_q32 = wrap_i32(state["phase"][0].to(torch.int64)
                             + carrier_inc[0].to(torch.int64) * steps + torch.cumsum(dphi_q32, 0))
        st["phase"] = phase_q32[-1:]
        ph = torch.cat([state["phase"], phase_q32[:-1]])
        rev = ph.to(torch.float32) * float(np.float32(2.0 ** -32))
        w = rev * float(np.float32(2 * np.pi))
        carrier = torch.complex(torch.cos(w), torch.sin(w))[None, :]
    else:
        carrier, st["phase"] = phase_ramp_q32(state["phase"], carrier_inc, L)
        if cfg.am_depth > 0.0:
            tone_ramp, st["tone_phase"] = phase_ramp_q32(state["tone_phase"], tone_inc, L)
            carrier = carrier * (1.0 + cfg.am_depth * tone_ramp.real)
        else:
            st["tone_phase"] = state["tone_phase"]
    sig = cfg.amplitude * carrier[0]

    if cfg.real:
        out = sig.real
        if cfg.noise_std > 0.0:
            out = out + cfg.noise_std * torch.randn(L, generator=state["gen"], device=dev)
        return st, out.to(torch.float32)
    if cfg.noise_std > 0.0:
        n = torch.randn((L, 2), generator=state["gen"], device=dev) * float(
            np.float32(cfg.noise_std / np.sqrt(2.0)))
        sig = sig + torch.complex(n[:, 0], n[:, 1])
    return st, sig.to(torch.complex64)


def multi_tone_block(state, freqs_hz, amps, samprate: float, L: int, real: bool = True):
    """Many simultaneous carriers in one block: a fixture for multichannel
    tests and benchmarks (K carriers, one per receiver channel).

    state: {"phase": [K] int32 Q32, ...}; freqs/amps: [K] host arrays.
    Returns (new_state, samples [L]); other state entries pass through.
    """
    dev = state["phase"].device
    incs = torch.tensor([int(rev_to_q32(f / samprate)) for f in np.asarray(freqs_hz)],
                        dtype=torch.int32, device=dev)
    ramp, new_phase = phase_ramp_q32(state["phase"], incs, L)  # [K, L] complex64
    a = torch.as_tensor(np.asarray(amps, np.float32), device=dev)[:, None]
    sig = (a * (ramp.real if real else ramp)).sum(0)
    return dict(state, phase=new_phase), sig.to(torch.float32 if real else torch.complex64)
