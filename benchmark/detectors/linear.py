"""The linear detector (linear.c): a block AGC with hang, threshold and
recovery, or a fixed gain; the SNR squelch; the I rail, or with `stereo`
the I and Q rails (the `iq` mode). Plain NumPy and PyTorch in float64 (or
the reference's dtype), importing nothing of the program."""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import db_p, db_v


def constants(spec: dict, g) -> dict:
    return {"sq_open": db_p(spec.get("squelch_open_db", 8.0)),
            "sq_close": db_p(spec.get("squelch_close_db", 7.0)),
            "sq_tail": int(spec.get("squelch_tail", 1)),
            "snr_squelch": bool(spec.get("snr_squelch", False)),
            "headroom": db_v(spec.get("headroom_db", -15.0)),
            "agc": bool(spec.get("agc", True)),
            "manual_gain": db_v(spec.get("gain_db", 50.0)),
            "hang_samples": int(spec.get("hangtime_s", 1.1) * g.rate),
            "recovery": db_v(spec.get("recovery_rate_db", 20.0) / g.rate),
            "threshold": db_v(spec.get("threshold_db", -15.0)),
            "rails": 2 if spec.get("stereo", False) else 1}


def window_stats(g, bb: torch.Tensor, m) -> dict:
    """The channels' mean |bb|^2 and the AGC's 2 ms sub-block peak power."""
    N = g.olen
    sps = min(max(int(round(N * 0.002 / (m.L / m.fs))), 1), N)
    ns = max(N // sps, 1)
    p = bb.real ** 2 + bb.imag ** 2
    return {"power": p.mean(-1), "peak": p[:, :ns * sps].reshape(-1, ns, sps).mean(-1).amax(-1)}


def decide(g, stats: dict, floors, blocks: int) -> dict:
    """The squelch sequencer and, for the AGC, each block's start gain and
    per-sample gain change: [blocks, K] send, mute, g0, change."""
    k = g.k
    K = len(next(iter(stats["power"].values())))
    sq = np.zeros(K, np.int64)
    sq_open = np.ones(K, bool)
    gain, hang = np.ones(K), np.zeros(K, np.int64)
    out = {key: np.zeros((blocks, K), bool) for key in ("send", "mute")}
    out["g0"], out["change"] = np.ones((blocks, K)), np.ones((blocks, K))
    N = g.olen
    headroom, threshold = k["headroom"], k["threshold"]
    for b, s, n0 in floors:
        power = stats["power"][s]
        if k["agc"]:
            ampl, peak = np.sqrt(power), np.sqrt(stats["peak"][s])
            bn = np.sqrt(g.bandwidth * np.maximum(n0, 0.0))
            c_peak = peak * gain > math.sqrt(2.0) * headroom
            c_strong = ampl * gain > headroom
            c_noise = bn * gain > threshold * headroom
            c_hang = hang > 0
            with np.errstate(divide="ignore"):
                gc_strong = np.maximum(headroom / (ampl * gain + 1e-300), 1e-300) ** (1.0 / N)
                gc_noise = np.maximum(threshold * headroom / (bn * gain + 1e-300),
                                      1e-300) ** (1.0 / N)
            change = np.where(c_peak, 1.0, np.where(c_strong, gc_strong, np.where(
                c_noise, gc_noise, np.where(c_hang, 1.0, k["recovery"]))))
            hang = np.where(c_peak, int(round(0.08 * g.rate)), np.where(
                c_strong, k["hang_samples"], np.where(c_noise | ~c_hang, hang,
                                                      np.maximum(hang - N, 0))))
            g0 = np.where(c_peak, math.sqrt(2.0) * headroom / np.maximum(peak, 1e-300), gain)
            out["g0"][b], out["change"][b] = g0, change
            gain = g0 * change ** N
        else:
            out["g0"][b] = k["manual_gain"]
        if k["snr_squelch"]:
            snr = power / np.maximum(n0 * g.bandwidth, 1e-300) - 1.0
            sq = np.where(snr >= k["sq_open"], k["sq_tail"] + 4,
                          np.where((sq > 0) & (snr < k["sq_close"]), sq - 1, sq))
            sq_open = np.where(snr < k["sq_close"], False,
                               np.where(~sq_open & (snr > k["sq_open"]), True, sq_open))
        else:
            sq, sq_open = np.full(K, k["sq_tail"] + 4), np.ones(K, bool)
        out["send"][b] = sq > 0
        out["mute"][b] = (sq < 4) | ~sq_open
    out["rails"] = k["rails"]
    return out


def output(g, d: dict, bs: list, bb: torch.Tensor, before) -> tuple:
    """The I rail (with `stereo` the I and Q rails) and the AGC's ramp, or
    the fixed gain."""
    x = bb.real[:, :, None] if g.k["rails"] == 1 else torch.stack([bb.real, bb.imag], 2)
    n = torch.arange(g.olen, dtype=torch.float64, device=bb.device)
    g0 = torch.as_tensor(d["g0"][bs], device=bb.device)[..., None]
    ch = torch.as_tensor(d["change"][bs], device=bb.device)[..., None]
    return x, g0 * torch.exp(n * torch.log(ch))


def fault(spec: dict) -> dict:
    """Every headroom and fixed gain 3 dB off."""
    return dict(spec, headroom_db=spec.get("headroom_db", -15.0) + 3.0,
                gain_db=spec.get("gain_db", 50.0) - 3.0)
