"""The general traffic generator: a workload's data file -> a ring of A/D blocks.

A workload names its configuration and describes the band the A/D sees:

    "ring_blocks": R            distinct 20 ms blocks, handed out cyclically
    "noise": {"dbfs_per_hz": x} or {"std": s}   real Gaussian noise
    "tones": [{"group": name, "select": ..., "dbfs": v | [lo, hi],
               "offset_hz": [lo, hi] }]          a cosine above each chosen
                                                channel's dial
    "fm":    [{"group": name, "select": ..., "dbfs": v, "tone_hz": f,
               "deviation_hz": d}]              an FM carrier on each dial

`select` is "all" or {"strata": n}: n channels, one drawn from each of n
equal runs of the group's channels. Levels and offsets
drawn from ranges are whole steps (STEP_DB, STEP_HZ: 1 dB, 50 Hz), and a
tone's frequency is rounded to the nearest multiple of 50 Hz. Every
frequency is then a whole number of cycles a 20 ms block, so
the signals are one [L] waveform added to every block; the noise differs
from block to block. The blocks are quantised to the s16 levels an s16 A/D
stream carries. Everything random is drawn from the seed: the host-side
choices from numpy's generator, the noise on the device from a
torch.Generator there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from reference import Master, expand_channels, parse_freq

__all__ = ["Scene", "make_scene"]

STEP_HZ, STEP_DB = 50.0, 1.0  # the steps of offsets and levels drawn from a range


class Scene:
    """A ring of blocks and the tones put in it: ring [R, L] float32 on the
    device, `tones`: {group: {channel index: (Hz above the dial, dBFS)}}."""

    def __init__(self, ring, tones):
        self.ring, self.tones = ring, tones


def _select(sel, C: int, rng) -> list[int]:
    if sel == "all":
        return list(range(C))
    n = int(sel["strata"])
    edges = np.linspace(0, C, n + 1).astype(np.int64)
    return [int(rng.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]


def _draw(v, rng, step: float) -> float:
    if isinstance(v, (int, float)):
        return float(v)
    lo, hi = float(v[0]), float(v[1])
    k = int(round((hi - lo) / step))
    return lo + step * int(rng.integers(0, k + 1))


def make_scene(ref: dict, wl: dict, seed: int, device) -> Scene:
    """The ring of workload `wl` on configuration `ref` (its reference
    entry), from `seed`."""
    m = Master.of(parse_freq(ref["samprate"]), ref.get("blocktime", 0.02),
                  ref.get("overlap", 5), ref.get("real", True))
    if not m.real:
        raise ValueError("the generator makes real A/D streams")
    rng = np.random.default_rng(np.random.SeedSequence(int(seed)))
    groups = {g["name"]: expand_channels(g) for g in ref["groups"]}
    grid = m.fs / m.L  # Hz of one cycle a block
    rows: list[tuple[float, float, float, float, float]] = []  # f, amp, fm tone, dev, phase
    tones: dict = {}
    for t in wl.get("tones", []):
        freqs = groups[t["group"]]
        chosen = tones.setdefault(t["group"], {})
        for k in _select(t.get("select", "all"), len(freqs), rng):
            off = _draw(t.get("offset_hz", 1500.0), rng, STEP_HZ)
            db = _draw(t.get("dbfs", -80.0), rng, STEP_DB)
            f = round((freqs[k] + off) / grid) * grid  # whole cycles a block
            chosen[k] = (f - freqs[k], db)
            rows.append((f, 10.0 ** (db / 20.0), 0.0, 0.0, rng.random()))
    for t in wl.get("fm", []):
        freqs = groups[t["group"]]
        for k in _select(t.get("select", "all"), len(freqs), rng):
            rows.append((freqs[k], 10.0 ** (float(t["dbfs"]) / 20.0), float(t["tone_hz"]),
                         float(t["deviation_hz"]), rng.random()))
    for f, _, ft, _, _ in rows:
        if abs(f * m.L / m.fs - round(f * m.L / m.fs)) > 1e-6 or ft * m.L % m.fs:
            raise ValueError(f"{f} Hz (tone {ft} Hz) is not whole cycles a block")
    signal = _signals(rows, m, device)
    nz = wl.get("noise", {})
    std = float(nz["std"]) if "std" in nz else math.sqrt(
        10.0 ** (float(nz.get("dbfs_per_hz", -138.0)) / 10.0) * m.fs / 2.0)
    R = int(wl.get("ring_blocks", 32))
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    ring = torch.randn((R, m.L), generator=gen, device=device, dtype=torch.float32)
    ring.mul_(std).add_(signal)
    ring = torch.round(torch.clamp(ring, -1.0, 1.0) * 32767.0).div_(32767.0)
    return Scene(ring, tones)


def _signals(rows, m: Master, device) -> torch.Tensor:
    """[L] float32 sum of the rows' cosines (and FM carriers), each phase
    taken exactly from whole Hz and samples (integer arithmetic mod fs)."""
    out = torch.zeros(m.L, dtype=torch.float64, device=device)
    n = torch.arange(m.L, dtype=torch.int64, device=device)
    for i in range(0, len(rows), 16):
        part = rows[i:i + 16]
        f = torch.tensor([int(round(r[0])) for r in part], dtype=torch.int64, device=device)
        a = torch.tensor([r[1] for r in part], dtype=torch.float64, device=device)
        ft = torch.tensor([int(round(r[2])) for r in part], dtype=torch.int64, device=device)
        beta = torch.tensor([r[3] / r[2] if r[2] else 0.0 for r in part], dtype=torch.float64,
                            device=device)
        ph0 = torch.tensor([r[4] for r in part], dtype=torch.float64, device=device)
        frac = torch.remainder(f[:, None] * n[None, :], m.fs).to(torch.float64) / m.fs
        mod = torch.remainder(ft[:, None] * n[None, :], m.fs).to(torch.float64) / m.fs
        ang = 2.0 * math.pi * (frac + ph0[:, None]) + beta[:, None] * torch.sin(2.0 * math.pi * mod)
        out += (a[:, None] * torch.cos(ang)).sum(0)
    return out.to(torch.float32)
