"""Linear demodulator (linear.c): SSB/CW/AM/SAM/DSB/IQ/envelope.

A per-block function over a channel group's [C, N] complex baseband:
  1. optional PLL carrier tracking, with squaring for DSB and small-angle
     forms when locked (linear.c:114-185): the one sequential part, run by
     the pll_scan CUDA kernel (ops/cuda_recur.py) on the card;
     `pll_scan_plain` here, a loop over samples, is its plain version
  2. post-detection frequency shift (CW offset) via Q32 NCO ramp
  3. block AGC (ops/agc.py)
  4. detection: mono I / envelope with DC removal / stereo I-Q or I-env
  5. SNR + multi-frame squelch sequencer (linear.c:344-388)

Group-static flags: enable_pll, envelope, stereo. Per-channel runtime params
are tensors; the state is a dict carried by the engine's step.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from ..ops.agc import agc_block, agc_init
from ..ops.cuda_recur import cuda_pll_scan
from ..ops.iir import first_order_scan
from ..ops.osc import phase_ramp_q32, pll_init, pll_params, pll_step, q32_to_rev

__all__ = ["linear_init", "linear_demod", "pll_scan_plain", "LINEAR_DEFAULTS"]

LINEAR_DEFAULTS = dict(
    pll_damping=float(1.0 / np.sqrt(2.0)),
    pll_locktime=0.5,  # seconds (linear.c:13)
)

_TWO_PI = float(np.float32(2 * math.pi))
_Q32_TO_REV = float(np.float32(2.0**-32))


def linear_init(n: int, gain_db: float = 0.0, device=None) -> dict[str, Any]:
    """Per-channel carried state for a linear group of n channels."""
    return {
        "agc": agc_init(n, gain_db, device=device),
        "pll": pll_init((n,), device=device),
        "pll_lock": torch.zeros((n,), dtype=torch.bool, device=device),
        "pll_lock_count": torch.zeros((n,), dtype=torch.int32, device=device),
        "shift_acc": torch.zeros((n,), dtype=torch.int32, device=device),
        "am_dc": torch.zeros((n,), dtype=torch.float32, device=device),
        "squelch_state": torch.zeros((n,), dtype=torch.int32, device=device),
        "squelch_open": torch.ones((n,), dtype=torch.bool, device=device),
    }


def pll_scan_plain(bb: torch.Tensor, pll: dict, k1: torch.Tensor, k2: torch.Tensor,
                   locked: torch.Tensor, square: torch.Tensor):
    """The PLL over one block, sample by sample (the plain version of the
    pll_scan kernel; linear.c:114-160). Each sample: mix by the conjugate
    VCO, the phase error (atan2 while unlocked, the small-angle form while
    locked, of the squared sample for DSB), one pll_step, and the in-phase
    and quadrature energies summed.

    bb [C, T] complex64; pll: the PLL state; k1, k2 [C] loop constants;
    locked, square [C] bool. Returns (mixed [C, T] complex64, new PLL state,
    sig [C], noi [C])."""
    C, T = bb.shape
    a_all, b_all = bb.real, bb.imag
    sig = torch.zeros(C, dtype=torch.float32, device=bb.device)
    noi = torch.zeros(C, dtype=torch.float32, device=bb.device)
    re_out, im_out = [], []
    # a divisor on the device: PyTorch's CUDA division by a host scalar
    # multiplies by its reciprocal, which rounds differently from the kernel
    two_pi = torch.full((), _TWO_PI, dtype=torch.float32, device=bb.device)
    for t in range(T):
        ang = pll["vco_phase"].to(torch.float32) * _Q32_TO_REV * _TWO_PI
        vc, vs = torch.cos(ang), torch.sin(ang)
        a, b = a_all[:, t], b_all[:, t]
        re = a * vc + b * vs
        im = b * vc - a * vs
        rr, ii, ri = re * re, im * im, re * im
        d = rr - ii
        mag = torch.hypot(re, im)
        ph_lock = torch.where(
            square, ri / torch.where(d.abs() > 1e-30, d, 1e-30),
            torch.where(mag > 0, im / torch.clamp(mag, min=1e-30), 0.0))
        ph_unlock = torch.where(square, 0.5 * torch.atan2(ri + im * re, d), torch.atan2(im, re))
        phase = torch.where(locked, ph_lock, ph_unlock) / two_pi
        pll, _ = pll_step(pll, phase, k1, k2)
        sig, noi = sig + rr, noi + ii
        re_out.append(re)
        im_out.append(im)
    mixed = torch.complex(torch.stack(re_out, -1), torch.stack(im_out, -1))
    return mixed, pll, sig, noi


def _run_pll(bb, state, params, samprate: int):
    """The PLL over the block and its lock detector (linear.c:114-185).
    Returns (bb_mixed, new PLL state, lock, lock count, snr, cphase)."""
    N = bb.shape[1]
    loop_bw = params["pll_loop_bw"] / samprate  # cycles/sample
    bw = torch.where(state["pll_lock"], loop_bw * 0.1, loop_bw)
    k1, k2 = pll_params(bw, LINEAR_DEFAULTS["pll_damping"])
    # the kernel takes whole rows: after filter2 the block is a column
    # slice of the second stage's output
    mixed, pll_st, signal, noise = cuda_pll_scan(bb.contiguous(), state["pll"], k1, k2,
                                                 state["pll_lock"], params["pll_square"])
    snr = torch.where(noise > 0, torch.clamp(signal / torch.clamp(noise, min=1e-30) - 1.0, min=0.0),
                      float("inf"))
    # lock detector with hysteresis (linear.c:162-180)
    limit = int(LINEAR_DEFAULTS["pll_locktime"] * samprate)
    lc = state["pll_lock_count"]
    lc = torch.where(snr < params["squelch_close"], lc - N,
                     torch.where(snr > params["squelch_open"], lc + N, lc))
    lc = torch.clamp(lc, -limit, limit)
    newly_locked = ~state["pll_lock"] & (lc >= limit)
    lock = torch.where(lc >= limit, True, torch.where(lc <= -limit, False, state["pll_lock"]))
    pll_st = dict(pll_st, wraps=torch.where(newly_locked, 0, pll_st["wraps"]))
    cphase = q32_to_rev(pll_st["vco_phase"]) * _TWO_PI
    return mixed, pll_st, lock, lc, snr, cphase


def linear_demod(state, bb, bb_power, n0, params, *, samprate: int, blocktime: float,
                 enable_pll: bool = False, envelope: bool = False, stereo: bool = False):
    """Demodulate one block for a linear channel group.

    state: from linear_init (carried). bb: [C, N] complex64 fine-tuned
    baseband. bb_power: [C] mean |bb|^2. n0: [C] smoothed noise density.
    params: per-channel tensors (agc_enable, headroom, hangtime_samples,
    recovery_per_sample, threshold, bandwidth, manual_gain, shift_inc_q32,
    pll_square, pll_loop_bw, dc_tau, squelch_open, squelch_close,
    squelch_tail, snr_squelch_enable). enable_pll / envelope / stereo pick
    the path. Returns (new_state, audio, info): audio [C, N] float32 (mono)
    or [C, N, 2] (stereo), squelch-muted.
    """
    C, N = bb.shape
    st = dict(state)
    info = {}
    if enable_pll:
        bb, pll_st, lock, lc, pll_snr, cphase = _run_pll(bb, state, params, samprate)
        st["pll"], st["pll_lock"], st["pll_lock_count"] = pll_st, lock, lc
        info["pll_snr"] = pll_snr
        info["pll_lock"] = lock
        info["cphase"] = cphase
        info["foffset"] = pll_st["u"] * samprate
        info["pll_wraps"] = pll_st["wraps"]  # lock-to-lock phase wraps (osc.c:175-206)
    else:
        pll_snr = None
        info["pll_lock"] = torch.zeros((C,), dtype=torch.bool, device=bb.device)

    # post-detection frequency shift (CW offset), Q32 NCO
    ramp, st["shift_acc"] = phase_ramp_q32(state["shift_acc"], params["shift_inc_q32"], N)
    bb = torch.where((params["shift_inc_q32"] != 0)[:, None], bb * ramp, bb)

    agc_state, gain_ramp = agc_block(
        state["agc"], bb, bb_power, n0,
        enable=params["agc_enable"],
        headroom=params["headroom"],
        hangtime_samples=params["hangtime_samples"],
        recovery_per_sample=params["recovery_per_sample"],
        threshold=params["threshold"],
        bandwidth=params["bandwidth"],
        samprate=samprate,
        blocktime=blocktime,
    )
    st["agc"] = agc_state
    gain_ramp = torch.where(params["agc_enable"][:, None], gain_ramp, params["manual_gain"][:, None])

    # detection
    sqrt1_2 = float(np.float32(1.0 / np.sqrt(2.0)))
    if envelope:
        env = gain_ramp * sqrt1_2 * bb.abs()
        # DC (carrier) removal: am_dc[n] = am_dc[n-1] + tau (s - am_dc[n-1])
        tau = params["dc_tau"][:, None]
        dc = first_order_scan(1.0 - tau * torch.ones_like(env), tau * env, state["am_dc"])
        st["am_dc"] = dc[:, -1]
        mono = torch.where((params["dc_tau"] > 0)[:, None], env - dc, env)
        if stereo:
            i_chan = gain_ramp * sqrt1_2 * bb.real
            audio = torch.stack([i_chan, mono], -1)
            power_samples = torch.stack([i_chan, env], -1)
        else:
            audio, power_samples = mono, env
    elif stereo:
        audio = power_samples = torch.stack([gain_ramp * bb.real, gain_ramp * bb.imag], -1)
    else:
        audio = power_samples = gain_ramp * bb.real

    if stereo:
        output_power = (power_samples * power_samples).sum(-1).mean(-1)
    else:
        output_power = 2.0 * (power_samples * power_samples).mean(-1)  # +3dB mono

    # squelch (linear.c:344-388): SNR squelch takes precedence, else the PLL's
    sq_en = params["snr_squelch_enable"]
    snr_simple = bb_power / torch.clamp(n0 * params["bandwidth"], min=1e-30) - 1.0
    snr = torch.where(sq_en, snr_simple, pll_snr if enable_pll else float("inf"))
    any_squelch = sq_en | enable_pll
    sq_max = params["squelch_tail"] + 4
    sq = state["squelch_state"]
    sq = torch.where(~any_squelch | (snr >= params["squelch_open"]), sq_max,
                     torch.where((sq > 0) & (snr < params["squelch_close"]), sq - 1, sq))
    st["squelch_state"] = sq

    sq_open = state["squelch_open"]
    sq_open = torch.where(any_squelch & (snr < params["squelch_close"]), False,
                          torch.where(any_squelch & ~sq_open & (snr > params["squelch_open"]), True,
                                      sq_open | ~any_squelch))
    st["squelch_open"] = sq_open
    st["am_dc"] = torch.where(any_squelch & sq_open & ~state["squelch_open"], 0.0, st["am_dc"])

    emit = sq >= 4  # 3..1 emit zeros, 0 fully closed (mute flag), >=4 open
    mute = ~emit | ~sq_open
    audio = torch.where(mute[:, None, None] if stereo else mute[:, None], 0.0, audio)
    output_power = torch.where(mute, 0.0, output_power)

    info["output_power"] = output_power
    info["snr"] = snr
    info["squelch_state"] = sq
    info["send"] = sq > 0  # RTP frames still flow during the closing tail
    info["gain"] = st["agc"]["gain"]
    return st, audio, info
