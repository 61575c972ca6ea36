"""The plain reference against itself: float32 reads as float64 does, and
the control (float32 with a TF32 channel IDFT) reads above the limit, at a
size the CPU holds; its float64 results at a small ring of each cell's
configuration are those recorded before its detectors were split into
files of their own (golden.py); it imports nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from conftest import BENCH, HERE, ROOT, SMALL_CFG, SMALL_WL

import golden
from cell import traffic
from judge import LIMITS, as_payloads, gain_reading, wave_errors
from reference import Reference, design_response
from scene import make_scene

BLOCKS, FIRST = 400, 4  # 8 s: the AGC's gain has come up from 0 dB to the tones' level


@pytest.fixture(scope="module")
def scene():
    return make_scene(SMALL_CFG["reference"], traffic(SMALL_WL), 2**31 + 101, "cpu")


def _readings(scene, cfg=None, **kw) -> tuple[float, float]:
    """(wave_lsb, gain_db) of a reference made with kw (and the reference
    entry cfg) put in the program's place."""
    ref = Reference(SMALL_CFG["reference"], scene.ring)
    other = Reference(cfg or SMALL_CFG["reference"], scene.ring, **kw)
    worst, worst_db = 0.0, 0.0
    for g in ref.groups:
        idx = np.arange(min(g.C, 12))
        want = ref.audio(g.name, idx, BLOCKS, FIRST)
        got = other.audio(g.name, idx, BLOCKS, FIRST)
        e, db = wave_errors(as_payloads(got, FIRST), want, FIRST)
        worst, worst_db = max(worst, float(np.nanmax(e))), max(worst_db, gain_reading(db))
    return worst, worst_db


def test_float32_reads_as_float64(scene):
    ref = Reference(SMALL_CFG["reference"], scene.ring)
    f32 = Reference(SMALL_CFG["reference"], scene.ring, dtype=torch.float32)
    for g, a in ref.sends(BLOCKS, FIRST).items():
        assert np.array_equal(a, f32.sends(BLOCKS, FIRST)[g])
    wave, db = _readings(scene, dtype=torch.float32)
    assert wave < LIMITS["wave_lsb"] / 2 and db < LIMITS["gain_db"] / 2


def test_the_tf32_control_fails_the_limit(scene):
    assert _readings(scene, dtype=torch.float32, tf32=True)[0] > 1.5 * LIMITS["wave_lsb"]


@pytest.mark.parametrize("key, step", [("headroom_db", 3.0), ("gain_db", -3.0)])
def test_a_gain_3_db_off_fails_the_gain_limit(scene, key, step):
    """Every AGC's headroom, or every fixed gain, 3 dB off."""
    bad = dict(SMALL_CFG["reference"], groups=[
        dict(g, **{key: g.get(key, -15.0 if key == "headroom_db" else 50.0) + step})
        for g in SMALL_CFG["reference"]["groups"]])
    assert _readings(scene, cfg=bad)[1] > 2.0 * LIMITS["gain_db"]


def test_response_passes_the_band_and_stops_the_rest():
    n, olen, fs = 300, 240, 12_000
    r = design_response(n, olen, 50 / fs, 3000 / fs, 11.0, real_master=False, master_points=n)
    f = np.fft.fftfreq(n, 1 / fs)
    band = (f > 700) & (f < 2300)
    assert np.allclose(np.abs(r[band]), 1.0, atol=2e-3)
    assert np.all(np.abs(r[(f < -1500) | (f > 4500)]) < 1e-3)


@pytest.fixture(scope="module")
def recorded():
    return json.loads((HERE / "data" / "golden.json").read_text())


@pytest.fixture(scope="module")
def computed():
    return golden.digests(BENCH)


@pytest.mark.parametrize("cell", golden.CELLS)
@pytest.mark.parametrize("what", ["sends", "x", "gain"])
def test_float64_results_are_those_recorded(recorded, computed, cell, what):
    """The squelch's sends are flags, equal on any build; x and gain are
    float64, equal bit for bit on the build they were recorded on (golden.py,
    `build`) and to rounding (1e-12 of their RMS) on any."""
    if what != "sends":
        for g, want in recorded[cell]["values"][what].items():
            assert golden.close(computed[cell]["values"][what][g], want, 1e-12), g
    if what == "sends" or computed["build"] == recorded["build"]:
        assert computed[cell][what] == recorded[cell][what]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [{!r}, {!r}]\n"
            "import reference, judge, scene, peaks, receiver, named\n"
            "for kind in ('detectors', 'signals'):\n"
            "    for f in sorted((named.HERE / kind).glob('*.py')):\n"
            "        named.module(kind, f.stem)\n"
            "tops = {{m.split('.')[0] for m in sys.modules}}\n"
            "print(sorted(tops & {{'ka9q_radio_tpu_torch', 'ka9q_radio_tpu', 'jax', 'jaxlib', "
            "'flax'}}))").format(str(BENCH), str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
