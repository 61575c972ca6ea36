"""Block AGC for linear modes (linear.c:199-266, docs/KA9Q-AGC.md).

The reference's AGC makes ONE decision per 20 ms block, then applies a
closed-form per-sample exponential gain ramp: a branchless decision vector
and a `gain * ratio**(n/N)` ramp, batched over channels.

Decision order (highest priority first):
  1. 2 ms sub-block peak > +3 dB over headroom  -> clamp gain instantly,
     hang 80 ms
  2. block RMS over headroom                    -> ramp down to target over
     the block, hang `hangtime`
  3. noise amplitude over threshold*headroom    -> ramp down (no hang change)
  4. hang timer active                          -> hold gain
  5. otherwise                                  -> recover at recovery_rate
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["agc_init", "agc_block"]


def agc_init(n: int, gain_db: float = 0.0, device=None):
    return {
        "gain": torch.full((n,), float(10.0 ** (gain_db / 20.0)), dtype=torch.float32, device=device),
        "hangcount": torch.zeros((n,), dtype=torch.int32, device=device),
    }


def agc_block(state, bb, bb_power, n0, *, enable, headroom, hangtime_samples,
              recovery_per_sample, threshold, bandwidth, samprate: int, blocktime: float):
    """One AGC block decision + the per-sample gain ramp.

    state: {gain[C], hangcount[C]}; bb [C, N] complex64 baseband; bb_power
    [C] mean |bb|^2; n0 [C] smoothed noise density; per-channel enable
    (bool), headroom (linear target amplitude), hangtime_samples (int32),
    recovery_per_sample, threshold (linear), bandwidth (Hz).
    Returns (new_state, gain_ramp [C, N] float32).
    """
    N = bb.shape[-1]
    gain = state["gain"]
    hang = state["hangcount"]

    power = bb.real * bb.real + bb.imag * bb.imag
    # 2 ms sub-block peak RMS amplitude (linear.c:227-245)
    sps = min(max(int(round(N * 0.002 / blocktime)), 1), N)
    nslices = max(N // sps, 1)
    sub = power[:, : nslices * sps].reshape(power.shape[0], nslices, sps)
    peak = torch.sqrt(sub.mean(-1).amax(-1))

    ampl = torch.sqrt(bb_power)
    bn = torch.sqrt(bandwidth * torch.clamp(n0, min=0.0))  # noise amplitude

    sqrt2 = float(np.float32(1.4142135))
    eps = float(np.float32(1e-30))

    c_peak = peak * gain > sqrt2 * headroom
    c_strong = ampl * gain > headroom
    c_noise = bn * gain > threshold * headroom
    c_hang = hang > 0

    inv_n = float(np.float32(1.0 / N))
    gc_strong = torch.pow(torch.clamp(headroom / (ampl * gain + eps), min=eps), inv_n)
    gc_noise = torch.pow(torch.clamp(threshold * headroom / (bn * gain + eps), min=eps), inv_n)

    gain_change = torch.where(
        c_peak, 1.0,
        torch.where(c_strong, gc_strong,
                    torch.where(c_noise, gc_noise,
                                torch.where(c_hang, 1.0, recovery_per_sample))))
    new_hang = torch.where(
        c_peak, int(round(0.08 * samprate)),
        torch.where(c_strong, hangtime_samples,
                    torch.where(c_noise | ~c_hang, hang, torch.clamp(hang - N, min=0))))
    # instant clamp for case 1
    gain0 = torch.where(c_peak, sqrt2 * headroom / torch.clamp(peak, min=eps), gain)

    gain_change = torch.where(enable, gain_change, 1.0)
    gain0 = torch.where(enable, gain0, gain)
    new_hang = torch.where(enable, new_hang, hang).to(torch.int32)

    n_idx = torch.arange(N, dtype=torch.float32, device=bb.device)
    ramp = gain0[:, None] * torch.exp(n_idx[None, :] * torch.log(gain_change)[:, None])
    new_gain = gain0 * torch.pow(gain_change, float(N))
    return {"gain": new_gain, "hangcount": new_hang}, ramp
