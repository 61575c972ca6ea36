"""The traffic generator: one seed, one ring; the sizes alike for every seed."""
from __future__ import annotations

import copy

import numpy as np
import torch
from conftest import SMALL_CFG, SMALL_WL

from reference import expand_channels
from scene import make_scene


def test_the_same_seed_makes_the_same_ring():
    a = make_scene(SMALL_CFG["reference"], SMALL_WL, 2**31 + 17, "cpu")
    b = make_scene(SMALL_CFG["reference"], SMALL_WL, 2**31 + 17, "cpu")
    assert torch.equal(a.ring, b.ring)
    assert a.tones == b.tones


def test_another_seed_draws_other_values_of_the_same_sizes():
    a = make_scene(SMALL_CFG["reference"], SMALL_WL, 5, "cpu")
    b = make_scene(SMALL_CFG["reference"], SMALL_WL, 6, "cpu")
    assert a.ring.shape == b.ring.shape and not torch.equal(a.ring, b.ring)
    assert {g: len(t) for g, t in a.tones.items()} == {g: len(t) for g, t in b.tones.items()}
    assert a.tones != b.tones


def test_blocks_are_s16_levels_and_tones_whole_cycles_a_block():
    sc = make_scene(SMALL_CFG["reference"], SMALL_WL, 9, "cpu")
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
    q = make_scene(SMALL_CFG["reference"], wl, 9, "cpu").ring
    assert torch.equal(q[0], q[3])
    spec = np.abs(np.fft.rfft(q[0].double().numpy()))
    assert spec.max() > 100 * np.median(spec)


def test_strata_draw_one_channel_in_each_run():
    wl = copy.deepcopy(SMALL_WL)
    sc = make_scene(SMALL_CFG["reference"], wl, 3, "cpu")
    ks = sorted(sc.tones["hf"])
    assert len(ks) == 8 and len(set(k * 8 // 166 for k in ks)) == 8
