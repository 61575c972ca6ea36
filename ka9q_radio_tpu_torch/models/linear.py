"""Linear demodulator (linear.c), the SSB path: no PLL, no envelope, mono.

A per-block function over a channel group's [C, N] complex baseband:
  1. post-detection frequency shift (CW offset) via Q32 NCO ramp
  2. block AGC (ops/agc.py)
  3. detection: mono I
  4. SNR + multi-frame squelch sequencer (linear.c:344-388)

The PLL (SAM/DSB), envelope (AM) and stereo (I/Q) paths are a later slice
of the port; asking for them raises NotImplementedError. The carried state
is the full JAX state (PLL and DC-remover entries included) so the two
packages' state trees compare key by key.
"""
from __future__ import annotations

from typing import Any

import torch

from ..ops.agc import agc_block, agc_init
from ..ops.osc import phase_ramp_q32, pll_init

__all__ = ["linear_init", "linear_demod"]


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


def check_linear_flags(enable_pll: bool, envelope: bool, stereo: bool) -> None:
    for flag, what in ((enable_pll, "PLL (sam/dsb)"), (envelope, "envelope (am)"),
                       (stereo, "stereo (iq)")):
        if flag:
            raise NotImplementedError(
                f"linear {what} demodulation is a later slice of the port "
                "(PLL/envelope/stereo linear)")


def linear_demod(state, bb, bb_power, n0, params, *, samprate: int, blocktime: float,
                 enable_pll: bool = False, envelope: bool = False, stereo: bool = False):
    """Demodulate one block for a linear channel group.

    state: from linear_init (carried). bb: [C, N] complex64 fine-tuned
    baseband. bb_power: [C] mean |bb|^2. n0: [C] smoothed noise density.
    params: per-channel tensors (agc_enable, headroom, hangtime_samples,
    recovery_per_sample, threshold, bandwidth, manual_gain, shift_inc_q32,
    squelch_open, squelch_close, squelch_tail, snr_squelch_enable).
    Returns (new_state, audio [C, N] float32 squelch-muted, info).
    """
    check_linear_flags(enable_pll, envelope, stereo)
    C, N = bb.shape
    st = dict(state)
    info = {"pll_lock": torch.zeros((C,), dtype=torch.bool, device=bb.device)}

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

    audio = gain_ramp * bb.real
    output_power = 2.0 * (audio * audio).mean(-1)  # +3dB mono

    # SNR squelch (linear.c:344-388); with no PLL the squelch is SNR only
    sq_en = params["snr_squelch_enable"]
    snr = torch.where(sq_en,
                      bb_power / torch.clamp(n0 * params["bandwidth"], min=1e-30) - 1.0,
                      float("inf"))
    sq_max = params["squelch_tail"] + 4
    sq = state["squelch_state"]
    sq = torch.where(~sq_en | (snr >= params["squelch_open"]), sq_max,
                     torch.where((sq > 0) & (snr < params["squelch_close"]), sq - 1, sq))
    st["squelch_state"] = sq

    sq_open = state["squelch_open"]
    sq_open = torch.where(sq_en & (snr < params["squelch_close"]), False,
                          torch.where(sq_en & ~sq_open & (snr > params["squelch_open"]), True,
                                      sq_open | ~sq_en))
    st["squelch_open"] = sq_open
    st["am_dc"] = torch.where(sq_en & sq_open & ~state["squelch_open"], 0.0, state["am_dc"])

    emit = sq >= 4  # 3..1 emit zeros, 0 fully closed (mute flag), >=4 open
    mute = ~emit | ~sq_open
    audio = torch.where(mute[:, None], 0.0, audio)
    output_power = torch.where(mute, 0.0, output_power)

    info["output_power"] = output_power
    info["snr"] = snr
    info["squelch_state"] = sq
    info["send"] = sq > 0  # RTP frames still flow during the closing tail
    info["gain"] = st["agc"]["gain"]
    return st, audio, info
