"""The traffic generator: one seed, one ring; the sizes alike for every seed;
a real ring as it was before the kinds of signal were split into files of
their own (golden.py); a complex ring of s16 levels on both rails with its
tones at signed offsets from the tuner's centre."""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch
from conftest import BENCH, COMPLEX_CFG, COMPLEX_WL, HERE, SMALL_CFG, SMALL_WL

import golden
import named
from cell import traffic
from reference import expand_channels, parse_freq
from scene import make_scene


def test_the_same_seed_makes_the_same_ring():
    a = make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), 2**31 + 17, "cpu")
    b = make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), 2**31 + 17, "cpu")
    assert torch.equal(a.ring, b.ring)
    assert a.tones == b.tones


def test_another_seed_draws_other_values_of_the_same_sizes():
    a = make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), 5, "cpu")
    b = make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), 6, "cpu")
    assert a.ring.shape == b.ring.shape and not torch.equal(a.ring, b.ring)
    assert {g: len(t) for g, t in a.tones.items()} == {g: len(t) for g, t in b.tones.items()}
    assert a.tones != b.tones


def test_blocks_are_s16_levels_and_tones_whole_cycles_a_block():
    sc = make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), 9, "cpu")
    levels = torch.round(sc.ring.double() * 32767.0)
    assert torch.max(torch.abs(levels - sc.ring.double() * 32767.0)) < 1e-3
    assert torch.equal((levels / 32767.0).float(), sc.ring)
    dials = {g["name"]: expand_channels(g) for g in SMALL_CFG["reference"]["groups"]}
    for group, chosen in sc.tones.items():
        for k, (off, db) in chosen.items():
            assert abs((dials[group][k] + off) / 50.0 - round((dials[group][k] + off) / 50.0)) < 1e-9
            assert -90.0 <= db <= -70.0
    # without noise the ring is one waveform repeated: whole cycles a block
    wl = copy.deepcopy(SMALL_WL)
    wl["noise"] = {"std": 0.0}
    q = make_scene(SMALL_CFG["reference"], traffic(wl), 9, "cpu").ring
    assert torch.equal(q[0], q[3])
    spec = np.abs(np.fft.rfft(q[0].double().numpy()))
    assert spec.max() > 100 * np.median(spec)


def test_strata_draw_one_channel_in_each_run():
    wl = copy.deepcopy(SMALL_WL)
    sc = make_scene(SMALL_CFG["reference"], traffic(wl), 3, "cpu")
    ks = sorted(sc.tones["hf"])
    assert len(ks) == 8 and len(set(k * 8 // 166 for k in ks)) == 8


@pytest.mark.parametrize("cell", ("small",) + golden.CELLS)
def test_real_rings_are_those_recorded(cell):
    if cell == "small":
        ref, wl = SMALL_CFG["reference"], SMALL_WL
    else:
        wl = golden.small_workload(json.loads((BENCH / "workloads" / f"{cell}.json").read_text()))
        ref = json.loads((BENCH / "configs" / f"{wl['config']}.json").read_text())["reference"]
    ring = make_scene(ref, traffic(wl), golden.SEED, "cpu").ring
    assert ring.dtype == torch.float32
    recorded = json.loads((HERE / "data" / "golden.json").read_text())
    # to a level of an s16 A/D on any build, bit for bit on the recorded one
    assert golden.close(golden.summary(ring.numpy()), recorded[cell]["values"]["ring"], 1e-6,
                        steps=1.0 / 32767.0)
    if golden.build() == recorded["build"]:
        assert golden._digest(ring.numpy()) == recorded[cell]["ring"]


def test_complex_rings_are_s16_levels_on_both_rails():
    sc = make_scene(COMPLEX_CFG["reference"], traffic(COMPLEX_WL), 2**31 + 19, "cpu")
    assert sc.ring.dtype == torch.complex64 and sc.ring.shape == (8, 40960)
    for rail in (sc.ring.real, sc.ring.imag):
        levels = torch.round(rail.double() * 32767.0)
        assert torch.equal((levels / 32767.0).float(), rail)
        assert rail.std() > 0  # noise on each rail
    # the layout step_block takes for `real = no`: I, Q interleaved, I first
    x = torch.view_as_real(sc.ring[0]).reshape(-1)
    assert torch.equal(x[0::2] + 1j * x[1::2], sc.ring[0])


def test_complex_tones_land_at_their_signed_offsets_in_whole_cycles_a_block():
    wl = copy.deepcopy(COMPLEX_WL)
    wl["noise"] = {"std": 0.0}
    sc = make_scene(COMPLEX_CFG["reference"], traffic(wl), 2**31 + 23, "cpu")
    q = sc.ring
    assert torch.equal(q[0], q[5])  # one waveform repeated: whole cycles a block
    center = parse_freq(COMPLEX_CFG["reference"]["frequency"])
    dials = {g["name"]: expand_channels(g) for g in COMPLEX_CFG["reference"]["groups"]}
    L = q.shape[1]
    spec = np.abs(np.fft.fft(q[0].to(torch.complex128).numpy()))
    want = set()
    for group, chosen in sc.tones.items():
        for k, (off, db) in chosen.items():
            f = dials[group][k] + off - center  # signed, Hz from the centre
            assert f / 50.0 == round(f / 50.0)
            want.add(int(round(f / 50.0)) % L)
    assert any(dials["usb"][k] < center for k in sc.tones["usb"]) and \
        any(dials["usb"][k] > center for k in sc.tones["usb"])
    top = set(np.argsort(spec)[-len(want):].tolist())
    assert top == want  # each tone in its own bin, the negative offsets below DC
    assert spec[sorted(want)].min() > 1000 * np.median(spec)


def test_a_kind_of_signal_of_its_own_is_found_by_name(monkeypatch, tmp_path):
    """A signal module written to a directory of its own, named by a key of
    the workload: a carrier keyed on in every other block of the ring."""
    (tmp_path / "bursts.py").write_text('''
import math
import torch


def add(entries, ctx):
    for t in entries:
        f = ctx.dials[t["group"]][0] + t["offset_hz"] - ctx.center
        n = torch.arange(ctx.m.L, dtype=torch.float64, device=ctx.device)
        ang = 2 * math.pi * f * n / ctx.m.fs
        w = 10.0 ** (t["dbfs"] / 20.0) * torch.polar(torch.ones_like(n), ang)
        on = (torch.arange(ctx.R, device=ctx.device) % 2 == 0).to(torch.float64)[:, None]
        ctx.waveform(on * w)
''')
    monkeypatch.setitem(named.SEARCH, "signals", [tmp_path, *named.SEARCH["signals"]])
    wl = {"config": "complex", "ring_blocks": 4, "noise": {"std": 0.0},
          "bursts": [{"group": "usb", "offset_hz": 1500.0, "dbfs": -40.0}]}
    q = make_scene(COMPLEX_CFG["reference"], traffic(wl), 2**31 + 29, "cpu").ring
    on, off = q[0].abs().max(), q[1].abs().max()
    assert torch.equal(q[0], q[2]) and off == 0.0 and abs(float(on) - 0.01) < 1e-4
