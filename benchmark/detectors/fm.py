"""The FM detector (fm.c): the discriminator's phase step with its memory
dropped while the squelch closes, a fixed gain from the headroom and the
bandwidth, and the squelch on the amplitude-variance SNR with its Ricean
correction (misc.c fm_snr). Plain NumPy and PyTorch, importing nothing of
the program."""
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
            "headroom": db_v(spec.get("headroom_db", -15.0))}


def window_stats(g, bb: torch.Tensor, m) -> dict:
    """The channels' mean |bb|^2, and the mean and variance of |bb|."""
    p = bb.real ** 2 + bb.imag ** 2
    a = bb.abs()
    amp = a.mean(-1)
    return {"power": p.mean(-1), "amp": amp, "var": ((a - amp[:, None]) ** 2).sum(-1)}


def decide(g, stats: dict, floors, blocks: int) -> dict:
    """The squelch sequencer: [blocks, K] send, mute, closing (the phase
    memory is dropped)."""
    k = g.k
    K = len(next(iter(stats["power"].values())))
    sq = np.zeros(K, np.int64)
    out = {key: np.zeros((blocks, K), bool) for key in ("send", "mute", "closing")}
    N = g.olen
    for b, s, n0 in floors:
        power = stats["power"][s]
        noise = np.maximum(n0, 0.0) * g.bandwidth
        with np.errstate(divide="ignore", invalid="ignore"):
            simple = np.where(noise > 0, power / np.maximum(noise, 1e-300) - 1.0, np.inf)
        r = stats["amp"][s] ** 2 * (N - 1) / np.maximum(stats["var"][s], 1e-300)
        snr = np.where(k["snr_squelch"] | ((sq <= 0) & (simple < k["sq_close"])), simple,
                       fm_snr_correct(r))
        sq_max = k["sq_tail"] + 5
        sq = np.where(snr >= k["sq_open"], sq_max,
                      np.where((sq > 0) & ((snr < k["sq_close"]) | (sq < sq_max)), sq - 1, sq))
        out["send"][b] = sq >= 1
        out["mute"][b] = sq < 5
        out["closing"][b] = (sq >= 1) & (sq <= 4)
    out["rails"] = 1
    return out


def output(g, d: dict, bs: list, bb: torch.Tensor, before) -> tuple:
    """The phase step in half revolutions, one rail; a fixed gain."""
    # the phase memory: the previous block's last sample, dropped while the
    # squelch closes (and before the first block)
    keep = np.zeros((len(bs), bb.shape[1]), bool)
    for j, b in enumerate(bs):
        if b > 0:
            keep[j] = ~d["closing"][b - 1]
    keep = torch.as_tensor(keep, device=bb.device)
    pm = torch.cat([before()[None], bb[:-1, :, -1]])
    pm = torch.where(keep, pm, torch.zeros_like(pm))
    prev = torch.cat([pm[:, :, None], bb[:, :, :-1]], dim=-1)
    z = bb * prev.conj()
    x = torch.atan2(z.imag, z.real) / math.pi
    gain = torch.full_like(x, 2.0 * g.k["headroom"] * g.rate / max(g.bandwidth, 1.0))
    return x[:, :, None], gain


def fault(spec: dict) -> dict:
    """The headroom that sets the gain 3 dB off."""
    return dict(spec, headroom_db=spec.get("headroom_db", -15.0) + 3.0)


def fm_snr_correct(r: np.ndarray) -> np.ndarray:
    """Ricean bias correction of the amplitude-variance SNR (misc.c fm_snr):
    10 fixed-point steps of theta^2 = xi(theta^2) (1 + r) - 2; 0 below
    pi / (4 - pi), r itself above 100."""
    def i0e(x):
        return torch.special.i0e(torch.from_numpy(x)).numpy()

    def i1e(x):
        return torch.special.i1e(torch.from_numpy(x)).numpy()

    tsq = np.clip(r, 0.0, 100.0)
    for _ in range(10):
        x = 0.25 * tsq
        t = (2.0 + tsq) * i0e(x) + tsq * i1e(x)
        tsq = (2.0 + tsq - (0.125 * math.pi) * t * t) * (1.0 + r) - 2.0
    return np.where(r <= math.pi / (4.0 - math.pi), 0.0, np.where(r > 100.0, r, np.maximum(tsq, 0.0)))
