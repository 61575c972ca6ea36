"""NBFM demodulator with CTCSS tone squelch and de-emphasis (fm.c).

A per-block function over a channel group's [C, N] complex baseband:
  1. dual SNR estimators: fast N0-based and constant-envelope amplitude
     variance with the fm_snr() Ricean bias correction (fm.c:108-145,
     misc.c:886-914)
  2. hysteresis squelch with multi-frame closing sequencer (fm.c:146-187)
  3. phase-difference discriminator carg(s * conj(prev))/pi with optional
     threshold extension (deviation clamp + amplitude weighting,
     fm.c:219-243), the previous sample carried as state
  4. peak deviation / frequency-offset tracking, DC removal (fm.c:245-278)
  5. CTCSS/PL tone squelch: a Goertzel integrated over 240 ms across blocks
     (the goertzel CUDA kernel on the card, ops/cuda_recur.py), tone
     deviation + inter-interval phase jump test (fm.c:279-325)
  6. one-pole de-emphasis as a log-depth scan (fm.c:327-335)
  7. fixed gain from bandwidth (fm.c:340-348)
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.cuda_recur import cuda_goertzel_block
from ..ops.iir import first_order_scan, goertzel_coeff, goertzel_init, goertzel_output

__all__ = ["fm_init", "fm_demod", "fm_snr_correct", "FM_DEFAULTS"]

FM_DEFAULTS = dict(
    devmax=5000.0,  # nominal peak deviation Hz (fm.c:56)
    beta=0.5,  # threshold extension factor (fm.c:118)
    pl_integrate_s=0.24,  # CTCSS integration window (fm.c:69)
)


def fm_snr_correct(r: torch.Tensor) -> torch.Tensor:
    """Ricean bias correction for the amplitude-variance SNR estimator: the
    reference's fixed-point iteration theta^2 = xi(theta^2)(1+r) - 2, 10
    steps (misc.c:886-914), i0/i1 through the exponentially scaled Bessels.
    0 below pi/(4-pi); r itself above 100 (20 dB)."""
    r = r.to(torch.float32)
    tsq = torch.clamp(r, 0.0, 100.0)
    for _ in range(10):
        # each factor carries e^{-tsq/4} = e^{-x}, what i0e(x), i1e(x) give
        x = 0.25 * tsq
        t = (2.0 + tsq) * torch.special.i0e(x) + tsq * torch.special.i1e(x)
        tsq = (2.0 + tsq - (0.125 * math.pi) * t * t) * (1.0 + r) - 2.0
    low = r <= math.pi / (4.0 - math.pi)
    return torch.where(low, 0.0, torch.where(r > 100.0, r, torch.clamp(tsq, min=0.0)))


def fm_init(n: int, device=None) -> dict:
    """Per-channel carried state for an NBFM group of n channels."""
    z = lambda dt: torch.zeros((n,), dtype=dt, device=device)  # noqa: E731
    return {
        "phase_memory": z(torch.complex64),
        "squelch_state": z(torch.int32),
        "foffset": z(torch.float32),  # smoothed freq offset, Hz
        "deemph": z(torch.float32),
        "goertzel": goertzel_init((n,), device=device),
        "pl_count": z(torch.int32),  # samples integrated so far
        "old_pl_phase": z(torch.float32),
        "tone_mute": torch.ones((n,), dtype=torch.bool, device=device),
        "tone_deviation": z(torch.float32),
    }


def fm_demod(state, bb, bb_power, n0, params, *, samprate: int, blocktime: float,
             ctcss: bool = False):
    """Demodulate one block for an NBFM channel group.

    state: from fm_init (carried). bb: [C, N] complex64 fine-tuned baseband.
    bb_power, n0: [C] float32. params: per-channel tensors bandwidth (Hz),
    headroom, squelch_open, squelch_close (power ratios), squelch_tail,
    snr_squelch_enable, threshold_ext, deemph_rate (per sample, 0 = off),
    deemph_gain, tone_freq (Hz, 0 = no CTCSS). ctcss: run the tone squelch.
    Returns (new_state, audio [C, N] float32, info).
    """
    C, N = bb.shape
    st = dict(state)
    info = {}

    noise = torch.clamp(n0, min=0.0) * params["bandwidth"]
    snr_simple = torch.where(noise > 0, bb_power / torch.clamp(noise, min=1e-30) - 1.0,
                             float("inf"))

    # constant-envelope variance SNR (fm.c:126-145)
    amp = bb.abs()
    avg_amp = amp.mean(-1)
    var = ((amp - avg_amp[:, None]) ** 2).sum(-1)
    snr_var = fm_snr_correct(avg_amp * avg_amp * (N - 1) / torch.clamp(var, min=1e-30))

    use_simple = params["snr_squelch_enable"] | (
        (state["squelch_state"] <= 0) & (snr_simple < params["squelch_close"]))
    snr = torch.where(use_simple, snr_simple, snr_var)
    info["fm_snr"] = snr

    # hysteresis squelch sequencer (fm.c:146-187)
    sq_max = params["squelch_tail"] + 5
    sq = state["squelch_state"]
    sq = torch.where(snr >= params["squelch_open"], sq_max,
                     torch.where((sq > 0) & ((snr < params["squelch_close"]) | (sq < sq_max)),
                                 sq - 1, sq))
    st["squelch_state"] = sq
    fully_open = sq == sq_max
    # states >= 5 demodulate real audio (the tail after the SNR drops
    # included); 4..1 send silent frames; 0 is closed
    emitting = sq >= 5
    closing = (sq >= 1) & (sq <= 4)

    # discriminator: phase difference in half-revolutions (fm.c:219-243)
    prev = torch.cat([state["phase_memory"][:, None], bb[:, :-1]], dim=1)
    s = bb * prev.conj()
    phase = torch.atan2(s.imag, s.real) * float(np.float32(1.0 / np.pi))
    devmax_frac = FM_DEFAULTS["devmax"] / samprate
    clamped = torch.clamp(phase, -devmax_frac, devmax_frac)
    p = bb.real * bb.real + bb.imag * bb.imag
    beta_noise = FM_DEFAULTS["beta"] * noise
    w = torch.where(p > 0, p / (p + beta_noise[:, None]), 0.0)
    # the first sample pairs with the previous block's last one, whose
    # weight derives from the carried phase_memory (fm.c:220-226)
    pm = state["phase_memory"]
    p_prev0 = pm.real * pm.real + pm.imag * pm.imag
    w_prev0 = torch.where(p_prev0 > 0, p_prev0 / (p_prev0 + beta_noise), 0.0)
    w_prev = torch.cat([w_prev0[:, None], w[:, :-1]], dim=1)
    ext = clamped * w * w_prev
    baseband = torch.where(params["threshold_ext"][:, None], ext, phase)
    st["phase_memory"] = torch.where(closing, torch.zeros((), dtype=bb.dtype, device=bb.device),
                                     bb[:, -1])

    # deviation peaks & frequency offset (fm.c:245-270), only while fully open
    fo_block = baseband.mean(-1) * (samprate * 0.5)
    alpha = float(np.float32(min(1.0 * blocktime, 1.0)))
    foffset = state["foffset"] + alpha * (fo_block - state["foffset"])
    st["foffset"] = torch.where(fully_open, foffset, state["foffset"])
    pk_pos = baseband.amax(-1) * (samprate * 0.5) - st["foffset"]
    pk_neg = baseband.amin(-1) * (samprate * 0.5) - st["foffset"]
    info["pdeviation"] = torch.where(fully_open, torch.maximum(pk_pos, -pk_neg), 0.0)
    info["foffset"] = st["foffset"]

    # DC removal before tone detection / de-emphasis (fm.c:272-278)
    dc = 2.0 * st["foffset"] / samprate
    baseband = torch.where((params["deemph_rate"] > 0)[:, None] & fully_open[:, None],
                           baseband - dc[:, None], baseband)

    if ctcss:
        # CTCSS Goertzel integrated across blocks; evaluated every 240 ms
        tone = params["tone_freq"]
        coeff, cf = goertzel_coeff(tone / samprate)
        g = cuda_goertzel_block(state["goertzel"],
                                torch.where(fully_open[:, None], baseband, 0.0), coeff)
        count = torch.where(fully_open, state["pl_count"] + N, 0)
        done = count >= int(round(FM_DEFAULTS["pl_integrate_s"] * samprate))
        out = goertzel_output(g, coeff, cf)
        tone_dev = samprate * (out.abs() / torch.clamp(count, min=1))
        ph = torch.atan2(out.imag, out.real) * float(np.float32(1.0 / (2 * np.pi)))
        old = state["old_pl_phase"] + tone * count / samprate
        npj = 2.0 * torch.remainder(ph - old, 1.0)
        npj = torch.where(npj > 1.0, npj - 2.0, npj)
        new_mute = (tone_dev < 250.0) | (npj.abs() > 0.10)
        tone_mute = torch.where(done & (tone != 0), new_mute, state["tone_mute"])
        st["tone_deviation"] = torch.where(done, tone_dev, state["tone_deviation"])
        st["old_pl_phase"] = torch.where(done, ph, state["old_pl_phase"])
        reset = done | ~fully_open
        st["goertzel"] = {k: torch.where(reset, 0.0, v) for k, v in g.items()}
        st["pl_count"] = torch.where(done, 0, count)
        st["tone_mute"] = torch.where(tone != 0, tone_mute, False)
        info["tone_deviation"] = st["tone_deviation"]
    else:
        st["tone_mute"] = torch.zeros((C,), dtype=torch.bool, device=bb.device)

    # one-pole de-emphasis (fm.c:327-335): d += rate (gain x - d)
    rate = params["deemph_rate"][:, None]
    de = first_order_scan(1.0 - rate * torch.ones_like(baseband),
                          rate * params["deemph_gain"][:, None] * baseband, state["deemph"])
    st["deemph"] = de[:, -1]
    baseband = torch.where(rate > 0, de, baseband)

    # fixed gain from bandwidth (fm.c:340-348)
    gain = 2.0 * params["headroom"] * samprate / torch.clamp(params["bandwidth"], min=1.0)
    audio = gain[:, None] * baseband
    mute = ~emitting | st["tone_mute"]
    audio = torch.where(mute[:, None], 0.0, audio)
    info["output_power"] = torch.where(mute, 0.0, (audio * audio).mean(-1))
    info["send"] = emitting | closing
    info["squelch_state"] = sq
    return st, audio.to(torch.float32), info
