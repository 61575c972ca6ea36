"""The harness's comparison against faults planted under the timed path: a
whole run of a small cell on the CPU (the look for a card skipped), once
sound and once with each fault this kind of cell can have, and `correct`
comes out false for every fault. (A cell runs on one card: there is no
exchange between cards to leave out.)"""
from __future__ import annotations

import time

import numpy as np
import pytest
from conftest import SMALL_BENCH, SMALL_CFG, SMALL_WL

import cell
from ka9q_radio_tpu_torch.runtime import radiod as radiod_mod

SEED, SECONDS = 2**31 + 404, 3.0  # the window starts at block 4: warm-up, 2 dispatches of 2


def _run():
    return cell.run_cell(SMALL_BENCH, "small", SEED, SECONDS, False, time.monotonic(),
                         device="cpu", wl=SMALL_WL, cfg=SMALL_CFG)


def test_a_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["checks"]["packets_off"]["value"] == 0
    assert res["check_detail"]["compared_channel_blocks"] > 0
    assert list(res)[-1] == "checks"


def test_a_step_that_returns_its_state_unchanged(monkeypatch):
    step = radiod_mod.GraphStep.__call__

    def stuck(self, state, params, block):
        return state, step(self, state, params, block)[1]

    monkeypatch.setattr(radiod_mod.GraphStep, "__call__", stuck)
    res = _run()
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("section, line", [("10m-FM", "headroom = -12"), ("WSPR", "gain = 57")])
def test_a_gain_3_db_off(section, line):
    """The headroom that sets 10m-FM's gain (-15 dB), or WSPR's fixed gain (60
    dB), 3 dB off in the program's configuration, with every sample still in
    place. (The USB AGC's headroom acts only once the AGC has ramped up to
    the tones, seconds of blocks that a CPU run does not reach: that fault is
    read against the reference in test_bench_reference.py and on the card.)"""
    text = SMALL_CFG["text"].replace(f"[{section}]\n", f"[{section}]\n{line}\n")
    assert text != SMALL_CFG["text"]
    res = cell.run_cell(SMALL_BENCH, "small", SEED, SECONDS, False, time.monotonic(),
                        device="cpu", wl=SMALL_WL, cfg=dict(SMALL_CFG, text=text))
    assert res["checks"]["gain_db"]["value"] > 2.0 * res["checks"]["gain_db"]["limit"]
    assert not res["correct"] and res["checks"]["packets_off"]["value"] == 0


def test_half_of_the_channels_left_out(monkeypatch):
    fetch = radiod_mod.Radiod._fetch_out

    def half(self, out):
        host = fetch(self, out)
        for name, g in host.items():
            if not name.startswith("_"):
                a = np.asarray(g["audio"])
                a[..., 1::2, :] = 0.0  # every other channel row of the batch
        return host

    monkeypatch.setattr(radiod_mod.Radiod, "_fetch_out", half)
    res = _run()
    assert not res["correct"], res["checks"]


def test_an_answer_altered_where_it_is_produced(monkeypatch):
    finish = radiod_mod.Radiod._finish_block
    seen = {"n": 0}

    def altered(self, host_out):
        seen["n"] += 1
        if seen["n"] == 8:  # one block early in the window: one sample of one WSPR channel
            a = np.asarray(host_out["wspr"]["audio"])
            a[0, 100] += 0.02
        return finish(self, host_out)

    monkeypatch.setattr(radiod_mod.Radiod, "_finish_block", altered)
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["packets_off"]["value"] == 0


@pytest.mark.parametrize("what", ["sends", "ssrc"])
def test_a_packet_lost_or_misaddressed_fails_the_exact_count(monkeypatch, what):
    finish = radiod_mod.Radiod._finish_block
    seen = {"n": 0}

    def broken(self, host_out):
        seen["n"] += 1
        if seen["n"] == 8:
            if what == "sends":  # the last open channel of one block's egress lost
                info = host_out["wspr"]["info"]
                info["egress_count"] = np.asarray(info["egress_count"]) - 1
            else:  # one channel's packets sent under another's SSRC
                ch = next(c for c in self.chans.values() if c.group == "wspr")
                edge = self.edges["wspr"][0]
                edge.ssrc[ch.idx] = edge.ssrc[ch.idx] + 7
        return finish(self, host_out)

    monkeypatch.setattr(radiod_mod.Radiod, "_finish_block", broken)
    res = _run()
    assert res["checks"]["packets_off"]["value"] > 0 and not res["correct"]


@pytest.mark.parametrize("stalls, lost", [({5: 0.1}, False), ({5: 0.1, 15: 0.53}, True)])
def test_a_late_dispatch_is_late_and_a_lost_block_fails(monkeypatch, stalls, lost):
    """Paced at 40 ms a dispatch under a front end that holds 0.3 s: a
    dispatch held up 0.1 s is late and no block fails; one held up 0.53 s,
    and those that catch up after it, return more than 0.3 s after they were
    due: their blocks are lost, and they alone fail. (The step is a stub that
    returns at once, so the judge's numbers are not read here.)"""
    seen = {"n": 0}

    def stub(self, block=None):
        seen["n"] += 1
        time.sleep(stalls.get(seen["n"] - SMALL_WL["warmup_dispatches"], 0.0))

    monkeypatch.setattr(radiod_mod.Radiod, "step_block", stub)
    monkeypatch.setattr(cell, "BUFFER_S", 0.3)
    res = cell.run_cell(SMALL_BENCH, "small", SEED, 1.5, False, time.monotonic(), device="cpu",
                        wl=dict(SMALL_WL, loop="paced"), cfg=SMALL_CFG)
    per = SMALL_CFG["reference"]["time_shards"]
    assert res["failed"] == res["lost_blocks"] and res["failed"] % per == 0
    if lost:  # 0.53 s less 40 ms a dispatch stays over 0.3 s for 6 dispatches
        assert 4 * per <= res["failed"] <= 7 * per
        assert res["late_dispatches"] >= 2 + res["failed"] // per
    else:
        assert res["failed"] == 0 and res["late_dispatches"] >= 1
