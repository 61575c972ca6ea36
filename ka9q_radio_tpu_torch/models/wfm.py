"""WFM broadcast stereo demodulator (wfm.c).

A per-block function over a [stations, Lc] composite-rate baseband block:

  1. power-SNR squelch with tail (wfm.c:145-165)
  2. FM discriminator: wrapped difference of arg()/pi (wfm.c:166-175)
  3. a second overlap-save stage on the real composite signal: composite_L
     = 384 kHz * blocktime, 50% overlap (M = L+1), real forward FFT
     (wfm.c:75-77) with frequency-domain slaves decimating to 48 kHz:
       mono   L+R   50 Hz-15 kHz, real output        (wfm.c:83-85)
       pilot  19 kHz +/- 100 Hz, complex, spun to DC (wfm.c:88-91)
       L-R    38 kHz +/- 15 kHz, complex, spun to DC (wfm.c:93-97)
       RDS    57 kHz +/- 2.4 kHz, complex, spun to DC
     The spins are exact integer bin shifts (wfm.c:101-109).
  4. pilot detection by energy (wfm.c:215-227); the squared pilot
     regenerates the 38 kHz subcarrier; L+/-R matrixing; stereo
     de-emphasis (wfm.c:237-258); automatic mono fallback (wfm.c:265-276).

Composite and audio rates are forced as in the reference (384 k / 48 k,
wfm.c:22-23). The output is always [C, audio_L, 2]; in mono fallback both
columns carry L+R, and the daemon switches the payload type on the `stereo`
info flag. The transforms are torch.fft (cuFFT on the card).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops.filter_design import design_bandpass_response
from ..ops.filterbank import compute_tuning
from ..ops.iir import first_order_scan

__all__ = ["WfmGeometry", "wfm_geometry", "wfm_design", "wfm_constants", "wfm_init",
           "wfm_demod", "AUDIO_SAMPRATE", "COMPOSITE_SAMPRATE"]

AUDIO_SAMPRATE = 48_000  # FULL_SAMPRATE (wfm.c:22)
COMPOSITE_SAMPRATE = 8 * AUDIO_SAMPRATE  # 384 kHz (wfm.c:23)


@dataclasses.dataclass(frozen=True)
class WfmGeometry:
    Lc: int  # composite block
    Mc: int  # composite_L + 1 (50% overlap)
    audio_L: int
    pilot_shift: int
    subc_shift: int
    rds_shift: int = 0

    @property
    def Nc(self) -> int:
        return self.Lc + self.Mc - 1

    @property
    def nb(self) -> int:
        """Slave IFFT size (audio-rate bins)."""
        return self.Nc * AUDIO_SAMPRATE // COMPOSITE_SAMPRATE


def wfm_geometry(blocktime: float = 0.02) -> WfmGeometry:
    Lc = int(round(COMPOSITE_SAMPRATE * blocktime))
    Mc = Lc + 1
    Nc = Lc + Mc - 1
    audio_L = int(round(AUDIO_SAMPRATE * blocktime))
    ps, prem, _ = compute_tuning(Nc, COMPOSITE_SAMPRATE, 19_000.0)
    ss, srem, _ = compute_tuning(Nc, COMPOSITE_SAMPRATE, 38_000.0)
    rs, rrem, _ = compute_tuning(Nc, COMPOSITE_SAMPRATE, 57_000.0)
    # as the reference asserts (wfm.c:101-109): clean rates only
    if prem != 0.0 or srem != 0.0 or rrem != 0.0 or (ps * Lc) % Nc or (ss * Lc) % Nc \
            or (rs * Lc) % Nc:
        raise ValueError("blocktime gives non-integer pilot/subcarrier bins")
    return WfmGeometry(Lc=Lc, Mc=Mc, audio_L=audio_L, pilot_shift=ps, subc_shift=ss,
                       rds_shift=rs)


def wfm_design(geo: WfmGeometry, kaiser_beta: float = 11.0) -> dict:
    """The composite slave responses (shared by all stations), numpy
    complex64: mono [nb//2+1] (half spectrum for the real IFFT), pilot,
    lminusr and rds [nb]."""
    nb, L = geo.nb, geo.audio_L
    fs = float(AUDIO_SAMPRATE)

    def design(lo, hi, **kw):
        return design_bandpass_response(nb, L, lo / fs, hi / fs, kaiser_beta, real_master=True,
                                        master_points=geo.Nc, **kw)

    return {
        "mono": design(50.0, 15_000.0, real_output=True)[: nb // 2 + 1].astype(np.complex64),
        "pilot": design(-100.0, 100.0).astype(np.complex64),
        "lminusr": design(-15_000.0, 15_000.0).astype(np.complex64),
        "rds": design(-2400.0, 2400.0).astype(np.complex64),
    }


def _slave_index(shift: int, nb: int, Nc: int):
    """Composite half-spectrum bins of a complex slave nb bins wide at
    +shift (upright positive-frequency slice, filter.c:777-859): gather
    indices and their validity."""
    m_bins = Nc // 2 + 1
    k = np.arange(nb)
    idx = shift + np.where(k < (nb + 1) // 2, k, k - nb)
    valid = (idx >= 0) & (idx < m_bins)
    return np.clip(idx, 0, m_bins - 1), valid


def wfm_constants(geo: WfmGeometry, responses: dict, device=None) -> dict:
    """Device constants of the demodulator, made once per group: the slave
    responses, and the three complex slaves' gather indices with their
    responses zeroed where a bin falls outside the composite spectrum."""
    idx, resp = [], []
    for key, shift in (("pilot", geo.pilot_shift), ("lminusr", geo.subc_shift),
                       ("rds", geo.rds_shift)):
        i, valid = _slave_index(shift, geo.nb, geo.Nc)
        idx.append(i)
        resp.append(np.where(valid, responses[key], 0).astype(np.complex64))
    return {"mono": torch.as_tensor(responses["mono"], device=device),
            "slave_idx": torch.as_tensor(np.stack(idx).astype(np.int64), device=device),
            "slave_resp": torch.as_tensor(np.stack(resp), device=device)}


def wfm_init(C: int, geo: WfmGeometry, device=None) -> dict:
    return {
        "tail": torch.zeros((C, geo.Mc - 1), dtype=torch.float32, device=device),
        "phase_memory": torch.zeros((C,), dtype=torch.float32, device=device),
        "squelch_state": torch.zeros((C,), dtype=torch.int32, device=device),
        "foffset": torch.zeros((C,), dtype=torch.float32, device=device),
        "stereo_deemph": torch.zeros((C,), dtype=torch.complex64, device=device),
        "mono_deemph": torch.zeros((C,), dtype=torch.float32, device=device),
    }


def wfm_demod(state, bb, bb_power, n0, params, geo: WfmGeometry, consts: dict):
    """One block for a WFM station group.

    state: from wfm_init. bb: [C, Lc] complex64 composite-rate baseband.
    bb_power, n0: [C] float32. params: per-station tensors bandwidth (Hz),
    headroom, squelch_open, squelch_close (power ratios), squelch_tail,
    deemph_rate (audio-rate one-pole, 0 = off), deemph_gain, stereo_enable.
    consts: wfm_constants on bb's device.
    Returns (new_state, audio [C, audio_L, 2] float32, info).
    """
    C, Lc = bb.shape
    st = dict(state)
    info = {}

    # simple power squelch (wfm.c:145-165)
    snr = torch.clamp(bb_power / torch.clamp(n0 * params["bandwidth"], min=1e-30) - 1.0, min=0.0)
    sq_max = params["squelch_tail"] + 1
    sq = state["squelch_state"]
    sq = torch.where(snr >= params["squelch_open"], sq_max,
                     torch.where((sq > 0) & (snr >= params["squelch_close"]), sq_max,
                                 torch.clamp(sq - 1, min=0)))
    st["squelch_state"] = sq
    open_ = sq > 0
    fully_open = sq == sq_max
    info["fm_snr"] = snr

    # discriminator: wrapped first difference of arg/pi (wfm.c:166-175)
    ph = torch.atan2(bb.imag, bb.real) * float(np.float32(1.0 / np.pi))
    prev = torch.cat([state["phase_memory"][:, None], ph[:, :-1]], dim=1)
    x = ph - prev
    x = torch.where(x > 1.0, x - 2.0, torch.where(x < -1.0, x + 2.0, x))
    st["phase_memory"] = torch.where(open_, ph[:, -1], 0.0)

    # deviation peaks & frequency offset while fully open (wfm.c:176-201)
    half_rate = float(np.float32(COMPOSITE_SAMPRATE * 0.5))
    fo_block = x.mean(-1) * half_rate
    alpha = float(np.float32(1.0 * (geo.Lc / COMPOSITE_SAMPRATE)))
    fo = state["foffset"] + alpha * (fo_block - state["foffset"])
    st["foffset"] = torch.where(fully_open, fo, state["foffset"])
    pk_pos = x.amax(-1) * (COMPOSITE_SAMPRATE * 0.5) - st["foffset"]
    pk_neg = x.amin(-1) * (COMPOSITE_SAMPRATE * 0.5) - st["foffset"]
    info["pdeviation"] = torch.where(fully_open, torch.maximum(pk_pos, -pk_neg), 0.0)
    info["foffset"] = st["foffset"]

    # second overlap-save stage: real composite forward FFT (wfm.c:75-77,203)
    comp = torch.cat([state["tail"], x], dim=1)  # [C, Nc]
    st["tail"] = comp[:, geo.Lc:]
    Fc = torch.fft.rfft(comp)

    nb, aL = geo.nb, geo.audio_L
    # mono (L+R): real-output slave at shift 0 (filter.c:770-776)
    mono = torch.fft.irfft(Fc[:, : nb // 2 + 1] * consts["mono"], n=nb)[:, nb - aL:]
    # the three complex slaves share one batched inverse transform
    fds = Fc[:, consts["slave_idx"]] * consts["slave_resp"]  # [C, 3, nb]
    pilot, lmr, rds = torch.fft.ifft(fds)[..., nb - aL:].unbind(1)

    # constant FM gain (wfm.c:209)
    gain = 2.0 * params["headroom"] * COMPOSITE_SAMPRATE / torch.clamp(params["bandwidth"],
                                                                       min=1.0)

    # pilot detection (wfm.c:215-227)
    pp = pilot.real ** 2 + pilot.imag ** 2
    subc_amp = pp.mean(-1)
    pilot_present = params["stereo_enable"] & (subc_amp > 1e-6)
    info["pilot_power"] = subc_amp

    # stereo multiplex: square the pilot to 38 kHz, quadrature-demodulate L-R
    pnorm = torch.clamp(pp, min=1e-30)
    subc_phasor = (pilot * pilot) / pnorm
    subc_info = 2.0 * (subc_phasor.conj() * lmr).imag

    # RDS (57 kHz = 3x pilot): derotate by the cubed pilot so the BPSK data
    # lands on the real axis for the host-side symbol decoder
    p_unit = pilot / torch.sqrt(pnorm)
    rds_bb = (p_unit * p_unit * p_unit).conj() * rds
    info["rds_baseband"] = rds_bb.real.to(torch.float32)
    info["rds_power"] = (rds.real ** 2 + rds.imag ** 2).mean(-1)
    s = torch.complex(mono + subc_info, mono - subc_info)  # L + iR (wfm.c:243-246)

    rate = params["deemph_rate"][:, None]
    dg = params["deemph_gain"][:, None]
    c = 1.0 - rate * torch.ones((C, aL), dtype=torch.float32, device=bb.device)
    # c is real but carried as complex64, as the JAX package does
    s_de = first_order_scan(c.to(torch.complex64), (rate * dg * s).to(torch.complex64),
                            state["stereo_deemph"])
    m_de = first_order_scan(c, rate * dg * mono, state["mono_deemph"])
    use_de = rate > 0
    s_out = torch.where(use_de, s_de, s)
    m_out = torch.where(use_de, m_de, mono)
    st["stereo_deemph"] = torch.where(pilot_present, s_de[:, -1], state["stereo_deemph"])
    st["mono_deemph"] = torch.where(~pilot_present, m_de[:, -1], state["mono_deemph"])

    stereo_audio = torch.stack([s_out.real, s_out.imag], -1)
    mono_audio = torch.stack([m_out, m_out], -1)
    audio = torch.where(pilot_present[:, None, None], stereo_audio, mono_audio)
    audio = audio * gain[:, None, None]
    audio = torch.where(open_[:, None, None], audio, 0.0).to(torch.float32)

    info["stereo"] = pilot_present
    info["squelch_state"] = sq
    info["send"] = open_
    po = (audio * audio).sum(-1).mean(-1) / 2.0
    info["output_power"] = torch.where(open_, po, 0.0)
    return st, audio, info
