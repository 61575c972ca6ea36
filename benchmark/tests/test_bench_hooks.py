"""The harness takes a deployment that brings its own A/D format and
detector: whole runs on the CPU (the look for a card skipped) of a small
complex-master configuration, USB channels at signed offsets from the
tuner's centre and a group of I/Q channels whose payloads carry two rails.
A sound run is correct; I and Q swapped under the program fail the
waveform; a detector written to a directory of its own is found by its name
and used; an unknown one stops the set-up, naming the missing file; a rail
left out of a two-rail payload fails the exact count."""
from __future__ import annotations

import copy
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, COMPLEX_CFG, COMPLEX_WL, SMALL_BENCH

import cell
import named
from ka9q_radio_tpu_torch.native import edge as edge_mod
from ka9q_radio_tpu_torch.runtime import radiod as radiod_mod

SEED, SECONDS = 2**31 + 505, 3.0


def _run(cfg=COMPLEX_CFG, wl=COMPLEX_WL):
    return cell.run_cell(SMALL_BENCH, "complex", SEED, SECONDS, False, time.monotonic(),
                         device="cpu", wl=wl, cfg=cfg)


def test_a_complex_stream_with_two_rails_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    by = res["check_detail"]["by_group"]
    assert by["usb"]["due"] > 0 and by["iq"]["datagrams"] == by["iq"]["due"] > 0
    assert res["check_detail"]["wave_lsb_median"]["iq"] > 0.0


def test_i_and_q_swapped_fail_the_waveform(monkeypatch):
    step = radiod_mod.Radiod.step_block

    def swapped(self, block=None):
        return step(self, block=torch.complex(block.imag, block.real))

    monkeypatch.setattr(radiod_mod.Radiod, "step_block", swapped)
    res = _run()
    assert res["checks"]["wave_lsb"]["value"] > res["checks"]["wave_lsb"]["limit"]
    assert not res["correct"]


def test_a_detector_of_its_own_is_found_by_name_and_used(monkeypatch, tmp_path):
    text = (BENCH / "detectors" / "linear.py").read_text() + '''

_decide = decide


def decide(g, stats, floors, blocks):
    import pathlib

    (pathlib.Path(__file__).parent / "used").write_text(g.name)
    return _decide(g, stats, floors, blocks)
'''
    (tmp_path / "usb_own.py").write_text(text)
    monkeypatch.setitem(named.SEARCH, "detectors", [tmp_path, *named.SEARCH["detectors"]])
    cfg = copy.deepcopy(COMPLEX_CFG)
    cfg["reference"]["groups"][0]["demod"] = "usb_own"
    res = _run(cfg=cfg)
    assert res["correct"], res["checks"]
    assert (tmp_path / "used").read_text() == "usb"


def test_an_unknown_detector_is_a_setup_error_naming_the_file():
    cfg = copy.deepcopy(COMPLEX_CFG)
    cfg["reference"]["groups"][1]["demod"] = "no_such_detector"
    with pytest.raises(named.SetupError, match=r"detectors/no_such_detector\.py"):
        _run(cfg=cfg)


def test_an_unknown_signal_is_a_setup_error_naming_the_file():
    wl = dict(COMPLEX_WL, chirps=[{"group": "usb"}])
    with pytest.raises(named.SetupError, match=r"signals/chirps\.py"):
        _run(wl=wl)


def test_a_rail_left_out_of_a_two_rail_payload_fails_the_exact_count(monkeypatch):
    send = edge_mod.RtpEdge.send_block
    seen = {"n": 0}

    def one_rail(self, audio, sends, marker):
        if self.nch == 2:
            seen["n"] += 1
            if seen["n"] == 8:  # one block early in the window: the Q rail left out
                self.nch = 1
                try:
                    return send(self, np.asarray(audio)[..., 0], sends, marker)
                finally:
                    self.nch = 2
        return send(self, audio, sends, marker)

    monkeypatch.setattr(edge_mod.RtpEdge, "send_block", one_rail)
    res = _run()
    assert seen["n"] >= 8
    assert res["checks"]["packets_off"]["value"] > 0 and not res["correct"]
    assert res["check_detail"]["by_group"]["iq"]["off"] > 0


def test_the_rails_of_a_payload_follow_the_detector_block_by_block():
    """A group whose payload flips between one rail and two (WFM's mono
    fallback): each block's payload is olen x its rails samples, each rail
    is held on its own, and the worst rail counts."""
    from judge import as_payloads, packets_off, presence, wave_errors

    rng = np.random.default_rng(3)
    B, n, first = 4, 16, 10
    rails = np.array([[1], [2], [2], [1]])
    x = rng.uniform(-0.5, 0.5, (B, 1, 2, n)) * 1e-2
    x[rails[:, 0] == 1, :, 1] = 0.0
    gain = np.full((B, 1, n), 0.5)
    mute = np.zeros((B, 1), bool)
    ref = {"x": x, "gain": gain, "audio": gain[:, :, None] * x, "rails": rails, "mute": mute}
    pay = as_payloads(ref, first)
    assert [pay[0][first + j].size for j in range(B)] == [n, 2 * n, 2 * n, n]
    e, db = wave_errors(pay, ref, first)
    assert np.all(e < 0.3) and np.all(db < 0.1)
    bad = [dict(pay[0])]
    bad[0][first + 2] = bad[0][first + 2].copy()
    bad[0][first + 2][1::2] = bad[0][first + 2][1::2][::-1]  # one block's second rail reversed
    e, _ = wave_errors(bad, ref, first)
    assert e[2, 0] > 10.0 and np.all(e[[0, 1, 3], 0] < 0.3)
    bad[0][first + 1] = bad[0][first + 1][0::2]  # a rail left out: the wrong size
    assert np.isinf(wave_errors(bad, ref, first)[0][1, 0])
    # the count: every aligned datagram counts against the block's send flag,
    # and one whose payload is not olen x the block's rails counts as off besides
    import array

    def rx(sizes, blocks_of):
        return {"ssrc": array.array("I", [7] * len(sizes)),
                "ts": array.array("I", [n * b for b in blocks_of]),
                "size": array.array("I", sizes)}

    sound = rx([2 * n, 2 * n * 2, 2 * n * 2, 2 * n], range(4))
    cnt, stray, wrong = presence(sound, {"g": np.array([7])}, {"g": n}, 0, 4, {"g": rails})
    assert stray == 0 and wrong == {"g": 0} and cnt["g"][:, 0].tolist() == [1, 1, 1, 1]
    short = rx([2 * n, 2 * n, 2 * n * 2, 2 * n], range(4))  # block 1 lost a rail
    cnt, stray, wrong = presence(short, {"g": np.array([7])}, {"g": n}, 0, 4, {"g": rails})
    assert stray == 0 and wrong == {"g": 1} and cnt["g"][:, 0].tolist() == [1, 1, 1, 1]
    dec = {"g": {"send": np.array([[True], [True], [True], [False]]), "rails": rails}}
    due = rx([2 * n, 2 * n * 2, 2 * n * 2], range(3))
    assert packets_off(due, {"g": np.array([7])}, {"g": n}, 0, 4, dec)[0] == 0
    for bad_rx in (
            rx([2 * n, 2 * n * 2, 2 * n * 2, n], [0, 1, 2, 1]),  # a truncated duplicate
            rx([2 * n, 2 * n * 2, 2 * n * 2, 3 * n], [0, 1, 2, 3]),  # wrong-sized, not due
            rx([2 * n, 2 * n, 2 * n * 2], range(3))):  # a rail left out
        off, detail = packets_off(bad_rx, {"g": np.array([7])}, {"g": n}, 0, 4, dec)
        assert off > 0 and detail["by_group"]["g"]["off"] == off, detail
