"""Oscillators and NCOs — phase bookkeeping in Q32 revolutions.

Phase accumulators are 32-bit fixed-point *revolutions* (Q32): wrap-around
arithmetic mod 2^32 is exact mod-1 phase arithmetic, so phase stays
continuous over unbounded run time with zero drift (the reference's NCO
uses the same representation, osc.c:76-127).

The JAX package gets the wrap from int32 overflow. Here every Q32 sum and
product runs in int64 and is folded back to a wrapped int32 explicitly
(`wrap_i32`), so no result depends on signed-overflow behaviour.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["rev_to_q32", "wrap_i32", "q32_to_rev", "cis_q32",
           "phase_ramp_q32", "pll_params", "pll_init", "pll_step"]

_TWO_POW_32 = float(2**32)
_Q32_TO_REV = float(np.float32(2.0**-32))  # int32 -> revolutions in [-0.5, 0.5)
_TWO_PI = float(np.float32(2.0 * np.pi))


def rev_to_q32(rev) -> np.int32:
    """Host: revolutions (float, any magnitude) -> Q32 phase word.

    Exact rational arithmetic via Python ints so repeated block updates done
    on device stay phase-continuous indefinitely.
    """
    q = int(round((float(rev) % 1.0) * _TWO_POW_32)) & 0xFFFFFFFF
    return np.int32(q - 2**32 if q >= 2**31 else q)


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """Fold an int64 tensor to the int32 it equals mod 2^32 (two's complement)."""
    return (torch.bitwise_and(x + 2**31, 0xFFFFFFFF) - 2**31).to(torch.int32)


def q32_to_rev(q: torch.Tensor) -> torch.Tensor:
    """Q32 phase word(s) -> revolutions in [-0.5, 0.5), float32."""
    return q.to(torch.float32) * _Q32_TO_REV


def cis_q32(q: torch.Tensor) -> torch.Tensor:
    """exp(+j*2*pi*phase) for Q32 phase word(s). complex64."""
    ph = q32_to_rev(q) * _TWO_PI
    return torch.complex(torch.cos(ph), torch.sin(ph))


def phase_ramp_q32(acc_q32: torch.Tensor, inc_q32: torch.Tensor, n: int):
    """Per-sample NCO phase ramp for a block.

    acc_q32/inc_q32: [...] int32 start phase and per-sample increment.
    Returns (ramp, new_acc): ramp complex64 [..., n] with ramp[..., i] =
    exp(j*2*pi*(acc + i*inc)); new_acc int32 = acc + n*inc (mod 2^32).
    Sample i carries phase acc + i*inc, as the reference's step_osc()
    returns the phasor BEFORE advancing it (osc.c:62-71).
    """
    acc = acc_q32.to(torch.int64)
    inc = inc_q32.to(torch.int64)
    steps = torch.arange(n, dtype=torch.int64, device=acc.device)
    q = wrap_i32(acc[..., None] + inc[..., None] * steps)
    return cis_q32(q), wrap_i32(acc + inc * n)


def pll_params(bw: torch.Tensor, damping: float = float(1.0 / np.sqrt(2.0))):
    """Loop constants (K1, K2) of the type-2 PLL from its bandwidth
    (cycles/sample) and damping, in float32 (set_pll_params, osc.c:153-168)."""
    bw = bw.to(torch.float32).abs()
    damping = float(np.float32(damping))
    denom = float(np.float32(damping + np.float32(1.0) / (np.float32(4.0) * np.float32(damping))))
    theta = 4.0 * math.pi * bw / denom
    D = 1.0 + 2.0 * damping * theta + theta * theta
    return 4.0 * damping * theta / D, 4.0 * theta * theta / D


def pll_init(shape=(), device=None):
    """Fresh PLL state: VCO phase (Q32), integrator u (cycles/sample), phase
    phi and wrap counter."""
    return {
        "vco_phase": torch.zeros(shape, dtype=torch.int32, device=device),
        "u": torch.zeros(shape, dtype=torch.float32, device=device),
        "phi": torch.zeros(shape, dtype=torch.float32, device=device),
        "wraps": torch.zeros(shape, dtype=torch.int32, device=device),
    }


# the VCO step is clipped just inside +-0.5 rev so f32 -> int32 cannot overflow
_VCO_HALF = float(np.float32(0.49999997))


def pll_step(state: dict, phase_err: torch.Tensor, k1: torch.Tensor, k2: torch.Tensor,
             lower_limit: float = -0.5, upper_limit: float = 0.5):
    """One PLL sample update, phase_err in revolutions (osc.c:175-206).

    Returns (new_state, u): u is the integrated frequency in cycles/sample.
    The VCO step dphi truncates to a Q32 word (f32 -> int32 toward zero) and
    the phase word wraps mod 2^32.
    """
    u_new = state["u"] + k2 * phase_err
    dphi = u_new + k1 * phase_err
    over = dphi > upper_limit
    under = dphi < lower_limit
    # freeze the integrator when pushing past a clamped VCO limit
    u_new = torch.where(over & (phase_err > 0), state["u"], u_new)
    u_new = torch.where(under & (phase_err < 0), state["u"], u_new)
    dphi = torch.clamp(dphi, lower_limit, upper_limit)
    phi = state["phi"] + dphi
    wraps = state["wraps"] + (phi > 1.0).to(torch.int32) - (phi < -1.0).to(torch.int32)
    phi = torch.where(phi > 1.0, phi - 1.0, torch.where(phi < -1.0, phi + 1.0, phi))
    vco_step = (torch.clamp(dphi, -_VCO_HALF, _VCO_HALF) * _TWO_POW_32).to(torch.int32)
    vco = wrap_i32(state["vco_phase"].to(torch.int64) + vco_step.to(torch.int64))
    return {"vco_phase": vco, "u": u_new, "phi": phi, "wraps": wraps}, u_new
