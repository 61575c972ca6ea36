"""The general traffic generator: a workload's data file -> a ring of A/D blocks.

A workload names its configuration and describes the band the A/D sees:

    "ring_blocks": R            distinct 20 ms blocks, handed out cyclically
    "noise": {"dbfs_per_hz": x} or {"std": s}   Gaussian noise (on each rail
                                                of a complex stream)
    "<kind>": [...]             signals of kind <kind>, made by
                                signals/<kind>.py (named.py), in the order the
                                workload gives its keys: "tones" (a carrier
                                above each chosen channel's dial), "fm" (an FM
                                carrier on each dial)

The harness hands the generator the workload less the keys it reads itself
(cell.traffic); here every key but `ring_blocks` and `noise` names a kind of
signal, and a kind with no file is a SetupError that names the path. A signal module gives add(entries, ctx): it
draws from ctx.rng, puts carriers in the shared oscillator bank
(ctx.carrier) or whole waveforms in the ring (ctx.waveform), and records
the tones it put on channels (ctx.tones), which the comparison samples.

`select` is "all" or {"strata": n}: n channels, one drawn from each of n
equal runs of the group's channels. Levels and offsets drawn from ranges are
whole steps (STEP_DB, STEP_HZ: 1 dB, 50 Hz), and a tone's frequency is
rounded to the nearest multiple of 50 Hz. Every carrier is then a whole
number of cycles a 20 ms block, so the carriers are one [L] waveform added
to every block; the noise differs from block to block. The blocks are
quantised to the s16 levels an s16 A/D stream carries.

A real master's ring is [R, L] float32, each carrier a cosine at its
frequency. A complex master's (the configuration's `real` false) is [R, L]
complex64, I the real part and Q the imaginary one (the RTP front end's
x[0::2] + 1j x[1::2], the block Radiod.step_block takes for `real = no`),
each carrier a complex exponential at its frequency less the tuner's centre
(`frequency`), so at a signed offset. Everything random is drawn from the
seed: the host-side choices from numpy's generator, the noise on the device
from a torch.Generator there.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from named import module
from reference import Master, expand_channels, parse_freq

__all__ = ["Scene", "make_scene", "SCENE_KEYS", "STEP_HZ", "STEP_DB"]

STEP_HZ, STEP_DB = 50.0, 1.0  # the steps of offsets and levels drawn from a range
SCENE_KEYS = ("ring_blocks", "noise")  # the generator's keys that name no kind of signal


class Scene:
    """A ring of blocks and the tones put in it: ring [R, L] on the device
    (float32, or complex64 for a complex master), `tones`: {group: {channel
    index: (Hz above the dial, dBFS)}}."""

    def __init__(self, ring, tones):
        self.ring, self.tones = ring, tones


class Ctx:
    """What a signal module draws from and adds to. rng: the seed's numpy
    generator; dials: {group: [Hz]}; m: the Master; center: the tuner's
    centre; grid: Hz of one cycle a block; tones: the record (Scene.tones);
    rows: the oscillator bank, (Hz, amplitude, modulating Hz, deviation Hz,
    phase in revolutions); waves: whole waveforms, [L] or [R, L] on the
    device, float64 (a real master) or complex128."""

    def __init__(self, ref: dict, m: Master, rng, device, R: int):
        self.rng, self.m, self.device, self.R = rng, m, device, R
        self.dials = {g["name"]: expand_channels(g) for g in ref["groups"]}
        self.center = parse_freq(ref.get("frequency", 0.0))
        self.grid = m.fs / m.L
        self.tones: dict = {}
        self.rows: list[tuple[float, float, float, float, float]] = []
        self.waves: list[torch.Tensor] = []

    def select(self, sel, C: int) -> list[int]:
        """Channel indices of a `select`: "all" or {"strata": n}."""
        if sel == "all":
            return list(range(C))
        n = int(sel["strata"])
        edges = np.linspace(0, C, n + 1).astype(np.int64)
        return [int(self.rng.integers(lo, hi)) for lo, hi in zip(edges[:-1], edges[1:])]

    def draw(self, v, step: float) -> float:
        """A number, or a whole step drawn from a range [lo, hi]."""
        if isinstance(v, (int, float)):
            return float(v)
        lo, hi = float(v[0]), float(v[1])
        k = int(round((hi - lo) / step))
        return lo + step * int(self.rng.integers(0, k + 1))

    def carrier(self, f: float, amp: float, tone_hz: float = 0.0, dev_hz: float = 0.0,
                phase: float = 0.0) -> None:
        """A carrier at f Hz (RF) in the oscillator bank, phase-modulated by
        a tone of tone_hz at dev_hz deviation."""
        self.rows.append((f, amp, tone_hz, dev_hz, phase))

    def waveform(self, w: torch.Tensor) -> None:
        """A waveform added to the ring: [L] to every block, [R, L] block by block."""
        self.waves.append(w)


def make_scene(ref: dict, wl: dict, seed: int, device) -> Scene:
    """The ring of traffic `wl` (a workload's generator keys, cell.traffic)
    on configuration `ref` (its reference entry), from `seed`."""
    m = Master.of_entry(ref)
    R = int(wl.get("ring_blocks", 32))
    ctx = Ctx(ref, m, np.random.default_rng(np.random.SeedSequence(int(seed))), device, R)
    for kind, entries in wl.items():
        if kind not in SCENE_KEYS:
            module("signals", kind).add(entries, ctx)
    for f, _, ft, _, _ in ctx.rows:
        f = f - ctx.center
        if abs(f * m.L / m.fs - round(f * m.L / m.fs)) > 1e-6 or ft * m.L % m.fs:
            raise ValueError(f"{f} Hz (tone {ft} Hz) is not whole cycles a block")
    signal = _signals(ctx.rows, m, ctx.center, device)
    for w in ctx.waves:
        signal = signal + w
    nz = wl.get("noise", {})
    std = float(nz["std"]) if "std" in nz else math.sqrt(
        10.0 ** (float(nz.get("dbfs_per_hz", -138.0)) / 10.0) * m.fs / 2.0)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    if m.real:
        ring = torch.randn((R, m.L), generator=gen, device=device, dtype=torch.float32)
        ring.mul_(std).add_(signal)
        ring = torch.round(torch.clamp(ring, -1.0, 1.0) * 32767.0).div_(32767.0)
        return Scene(ring, ctx.tones)
    ring = torch.randn((R, m.L, 2), generator=gen, device=device, dtype=torch.float32)
    ring.mul_(std).add_(torch.view_as_real(signal.to(torch.complex64)))
    ring = torch.round(torch.clamp(ring, -1.0, 1.0) * 32767.0).div_(32767.0)
    return Scene(torch.view_as_complex(ring), ctx.tones)


def _signals(rows, m: Master, center: float, device) -> torch.Tensor:
    """[L] sum of the rows' carriers, each phase taken exactly from whole Hz
    and samples (integer arithmetic mod fs): float32 cosines on a real
    master, complex128 exponentials at the offset from `center` on a
    complex one."""
    out = torch.zeros(m.L, dtype=torch.float64 if m.real else torch.complex128, device=device)
    n = torch.arange(m.L, dtype=torch.int64, device=device)
    for i in range(0, len(rows), 16):
        part = rows[i:i + 16]
        f = torch.tensor([int(round(r[0] - center)) for r in part], dtype=torch.int64,
                         device=device)
        a = torch.tensor([r[1] for r in part], dtype=torch.float64, device=device)
        ft = torch.tensor([int(round(r[2])) for r in part], dtype=torch.int64, device=device)
        beta = torch.tensor([r[3] / r[2] if r[2] else 0.0 for r in part], dtype=torch.float64,
                            device=device)
        ph0 = torch.tensor([r[4] for r in part], dtype=torch.float64, device=device)
        frac = torch.remainder(f[:, None] * n[None, :], m.fs).to(torch.float64) / m.fs
        mod = torch.remainder(ft[:, None] * n[None, :], m.fs).to(torch.float64) / m.fs
        ang = 2.0 * math.pi * (frac + ph0[:, None]) + beta[:, None] * torch.sin(2.0 * math.pi * mod)
        if m.real:
            out += (a[:, None] * torch.cos(ang)).sum(0)
        else:
            out += (a[:, None] * torch.polar(torch.ones_like(ang), ang)).sum(0)
    return out.to(torch.float32) if m.real else out
