"""The port's daemon held to the JAX daemon on the whole control plane
(decode_radio_commands, radio_status.c:133-702): the twins of
tests/test_control_plane.py, each on its config.

Each twin builds both daemons (the port's on the CPU), feeds both the same
blocks and command packets, and asserts the JAX test's own assertions on
the port's daemon, then holds the two to each other (torch_parity
DaemonPair): channel tables, free slots, host mirrors, params and every
packet on the wire. Each runs twice: eager, and through the emulated graph
dispatch (the static-buffer body of runtime/graphs.py in the daemon's place,
its rebuilds' and restocks' too), where graph_stats() must show no eager
block but the spectrum's warm-up frames, and a params leaf a writer replaced
would raise at the next dispatch.

The scene puts a signal in every static channel: a carrier 1 kHz above the
usb dial, an FM carrier (1 kHz tone, 2.5 kHz deviation) on the pm channel,
and a tone 50 Hz into the cwu passband, over -60 dBFS noise. An FM channel
on noise alone reports an SNR of P/N - 1 with P/N near 1, whose dB the
packages' 1e-6 apart powers move by 1e-2 dB (ROADMAP Queue 3's traps)."""
import time

import numpy as np
import pytest
import torch

from ka9q_radio_tpu_torch.net.rtp import Encoding
from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status
from test_control_plane import CONF
from torch_parity import FS, DaemonPair

torch.set_num_threads(2)


def scene(b: int, L: int, rng) -> np.ndarray:
    t = np.arange(b * L, (b + 1) * L) / FS
    x = 0.1 * np.exp(2j * np.pi * 201_000 * t)
    x += 0.05 * np.exp(1j * (2 * np.pi * 300_000 * t + 2.5 * np.sin(2 * np.pi * 1000 * t)))
    x += 0.02 * np.exp(2j * np.pi * 150_050 * t)
    x += 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


DISPATCH = ["eager", "graph"]


def make_pair(dispatch, monkeypatch, conf=CONF, seed=51):
    p = DaemonPair(conf, dispatch, monkeypatch, scene, seed=seed)
    p.step()
    return p


@pytest.fixture(params=DISPATCH)
def pair(request, monkeypatch):
    return make_pair(request.param, monkeypatch)


def last_status(rd, ssrc):
    for kind, pkt in reversed(rd._sent):
        if kind != "status":
            continue
        _, fields, _ = decode_status(pkt)
        if fields.get(T.OUTPUT_SSRC) == ssrc:
            return fields
    raise AssertionError("no status for ssrc")


def host_val(rd, ch, key):
    return np.asarray(rd.engine.groups[ch.group].host["demod"][key][ch.idx])


def data_count(rd) -> int:
    return sum(1 for k, _ in rd._sent if k == "data")


# ---------------------------------------------------------------- runtime keys
def test_runtime_keys_no_rebuild(pair):
    rd = pair.t
    eng = rd.engine
    ch = pair.cmd(200, SQUELCH_OPEN=9.5, SQUELCH_CLOSE=8.5, HEADROOM=-12.0,
                  AGC_HANGTIME=0.5, AGC_RECOVERY_RATE=30.0, AGC_THRESHOLD=-12.0,
                  SNR_SQUELCH=True, SHIFT_FREQUENCY=100.0, STATUS_INTERVAL=7)
    assert rd.engine is eng
    np.testing.assert_allclose(host_val(rd, ch, "squelch_open"), 10 ** 0.95, rtol=1e-5)
    np.testing.assert_allclose(host_val(rd, ch, "squelch_close"), 10 ** 0.85, rtol=1e-5)
    np.testing.assert_allclose(host_val(rd, ch, "headroom"), 10 ** (-12 / 20), rtol=1e-5)
    assert int(host_val(rd, ch, "hangtime_samples")) == 8000
    np.testing.assert_allclose(host_val(rd, ch, "recovery_per_sample"),
                               10 ** (30 / 20 / 16000), rtol=1e-6)
    assert bool(host_val(rd, ch, "snr_squelch_enable"))
    assert int(host_val(rd, ch, "shift_inc_q32")) != 0
    assert ch.update_every == 7
    pair.assert_same_state()

    # GAIN implies AGC off (radio_status.c:404)
    pair.cmd(200, GAIN=20.0)
    assert rd.engine is eng
    np.testing.assert_allclose(host_val(rd, ch, "manual_gain"), 10.0, rtol=1e-5)
    assert not bool(host_val(rd, ch, "agc_enable"))
    pair.step(2)
    pair.cmd(200, AGC_ENABLE=True)
    assert bool(host_val(rd, ch, "agc_enable"))

    # KAISER_BETA redesigns the filter without a rebuild
    resp_before = np.copy(rd.engine.groups[ch.group].host["responses"][ch.idx])
    pair.cmd(200, KAISER_BETA=5.0)
    assert rd.engine is eng
    assert not np.allclose(resp_before, rd.engine.groups[ch.group].host["responses"][ch.idx])
    assert last_status(rd, 200)[T.KAISER_BETA] == pytest.approx(5.0)
    pair.check(7)


def test_fm_runtime_keys(pair):
    rd = pair.t
    eng = rd.engine
    ch = pair.cmd(300, PL_TONE=100.0, THRESH_EXTEND=True)
    assert rd.engine is eng
    np.testing.assert_allclose(host_val(rd, ch, "tone_freq"), 100.0)
    assert bool(host_val(rd, ch, "threshold_ext"))
    pair.check(5)


def test_filter2_beta_runtime(pair):
    rd = pair.t
    eng = rd.engine
    ch = rd.chans[150]
    r2_before = np.copy(rd.engine.groups[ch.group].host["responses2"][ch.idx])
    pair.cmd(150, FILTER2_KAISER_BETA=3.0)
    assert rd.engine is eng
    assert not np.allclose(r2_before, rd.engine.groups[ch.group].host["responses2"][ch.idx])
    assert last_status(rd, 150)[T.FILTER2_KAISER_BETA] == pytest.approx(3.0)
    pair.check(5)


def test_spectrum_keys(pair):
    rd = pair.t
    ch = rd.chans[0]
    eng = rd.engine
    # base/step are host-side: no rebuild
    pair.cmd(0, SPECTRUM_BASE=-100.0, SPECTRUM_STEP=1.0)
    assert rd.engine is eng
    assert ch.spectrum_base == -100.0 and ch.spectrum_step == 1.0
    # geometry keys rebuild the spectrum class
    ch = pair.cmd(0, RESOLUTION_BW=50.0, BIN_COUNT=64, SPECTRUM_AVG=4,
                  WINDOW_TYPE=5, SPECTRUM_OVERLAP=0.5)
    spec = rd.engine.groups[ch.group].spec
    assert spec.bin_bw == 50.0 and spec.bin_count == 64
    assert spec.fft_avg == 4 and spec.spectrum_window == "hann"
    assert spec.spectrum_overlap == 0.5
    pair.step()
    st = last_status(rd, 0)
    assert st[T.BIN_COUNT] == 64
    # PRESET is refused on spectrum channels (radio_status.c:688)
    ch = pair.cmd(0, PRESET="usb")
    assert rd.engine.groups[ch.group].spec.demod == "spectrum"
    # a second geometry switch and a poll once its warm-up frames are in
    ch = pair.cmd(0, BIN_COUNT=16, RESOLUTION_BW=200.0)
    assert rd.engine.groups[ch.group].spec.bin_count == 16
    pair.step(4)
    pair.cmd(0, COMMAND_TAG=9)
    pair.check(3)
    assert len(last_status(rd, 0)[T.BIN_DATA]) == 16


def test_output_encoding_and_opus(pair):
    from ka9q_radio_tpu_torch.net import opus as opuslib

    rd = pair.t
    ch = pair.cmd(200, OUTPUT_ENCODING=int(Encoding.F32LE))
    assert ch.encoding == Encoding.F32LE
    assert last_status(rd, 200)[T.OUTPUT_ENCODING] == int(Encoding.F32LE)
    pair.step(3)  # F32LE samples on the wire, held within one s16 LSB
    if opuslib.available():
        ch = pair.cmd(200, OUTPUT_ENCODING=int(Encoding.OPUS))
        assert ch.encoding == Encoding.OPUS
        assert ch.samprate in (8000, 12_000, 16_000, 24_000, 48_000)
        pair.cmd(200, OPUS_BIT_RATE=32_000, OPUS_DTX=True, OPUS_APPLICATION=2048)
        assert ch.opus_bitrate == 32_000 and ch.opus_dtx and ch.opus_app == 2048
        pair.step()
        st = last_status(rd, 200)
        assert st[T.OPUS_BIT_RATE] == 32_000
    pair.check(2)


def test_maxdelay_aggregation(pair):
    rd = pair.t
    eng = rd.engine
    ch = pair.cmd(200, MAXDELAY=3)
    assert rd.engine is eng and ch.maxdelay == 3
    n0 = data_count(rd)
    pair.step(3)
    n1 = data_count(rd)
    assert n1 > n0  # aggregated flush still emits
    assert last_status(rd, 200)[T.MAXDELAY] == 3
    pair.check(9)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("how", ["block = 2", "MAXDELAY = 3"])
def test_aggregation_matches_jax(dispatch, how, monkeypatch):
    """Aggregated RTP (`[global] block = 2`, or MAXDELAY = 3 on the usb
    channel) over 16 blocks: each packet carries its blocks' samples,
    within 1 LSB of JAX's. Through the graph dispatch the blocks a packet
    joins are outputs of replays of one graph key, which the next replay
    of that key overwrites in place: a queued block must be the host's own
    copy (Radiod's _host_copy), or a packet carries a later block's
    samples."""
    conf = CONF.replace("update = 5", "update = 5\nblock = 2") if how == "block = 2" else CONF
    pair = make_pair(dispatch, monkeypatch, conf)
    if how == "MAXDELAY = 3":
        pair.cmd(200, MAXDELAY=3)
    n0 = len(pair.t._sent)
    pair.step(16)
    # a flush of agg blocks of 320 s16 samples, in packets of at most 700
    left = (2 if how == "block = 2" else 3) * pair.t.engine.groups["hf"].olen
    want = set()
    while left:
        want.add(12 + 2 * min(left, 700))
        left -= min(left, 700)
    sizes = {len(p) for k, p in pair.t._sent[n0:]
             if k == "data" and int.from_bytes(p[8:12], "big") == 200}
    assert sizes == want, (sizes, want)
    pair.check()


def test_doppler_and_lifetime_and_opts(pair):
    rd = pair.t
    eng = rd.engine
    ch = pair.cmd(200, DOPPLER_FREQUENCY=50.0, DOPPLER_FREQUENCY_RATE=10.0,
                  LIFETIME=100, SETOPTS=0b1010)
    assert rd.engine is eng
    assert rd.doppler[200] == [50.0, 10.0]
    assert ch.lifetime == 100 and ch.options == 0b1010
    pair.cmd(200, CLEAROPTS=0b0010)
    assert ch.options == 0b1000
    pair.step(3)
    assert rd.doppler == pair.j.doppler and rd.doppler[200][0] != 50.0
    pair.check(3)


# ----------------------------------------------------- dynamic channel latency
def test_spare_slots_zero_recompile(pair):
    """First dynamic create rebuilds once with dyn-slots spares; the next
    dyn-slots creates (and removals/recreates) reuse tombstones with the
    SAME engine."""
    rd = pair.t
    pair.cmd(7001, PRESET="am", RADIO_FREQUENCY=100_000.0)
    eng = rd.engine
    dt = 0.0
    for k in range(3):  # dyn-slots = 3 spares
        t0 = time.monotonic()
        ch = pair.cmd(7002 + k, PRESET="am", RADIO_FREQUENCY=101_000.0 + k)
        dt += time.monotonic() - t0
        assert ch is not None and rd.engine is eng, k
    assert dt < 2.0  # params surgery in both daemons, not a compile
    for r in (pair.j, rd):
        r.remove_channel(7002)
    ch = pair.cmd(7010, PRESET="am", RADIO_FREQUENCY=110_000.0)
    assert rd.engine is eng
    pair.step()
    assert np.isfinite(np.asarray(rd.chans[7010].last_info["baseband_power"])).all()
    pair.check(4)


def test_dynamic_create_reuses_static_group(pair):
    """A dynamic create whose preset matches a static section's compiled
    class lands in THAT group (radio.c:1465)."""
    rd = pair.t
    ch = pair.cmd(7100, PRESET="cwu", RADIO_FREQUENCY=150_500.0)
    assert ch is not None and ch.group == "cw"
    assert "dyn-cwu" not in rd.engine.groups
    eng = rd.engine
    for k in range(3):
        c2 = pair.cmd(7101 + k, PRESET="cwu", RADIO_FREQUENCY=151_000.0 + k)
        assert c2 is not None and c2.group == "cw" and rd.engine is eng, k
    pair.step()
    assert np.isfinite(np.asarray(rd.chans[7100].last_info["baseband_power"])).all()
    static_cw = next(c for c in rd.chans.values() if c.group == "cw" and not c.dynamic)
    assert np.isfinite(np.asarray(static_cw.last_info["baseband_power"])).all()
    pair.check(4)


def test_move_carries_runtime_params(pair):
    rd = pair.t
    pair.cmd(200, GAIN=14.0)
    ch = pair.cmd(200, OUTPUT_SAMPRATE=24_000)
    np.testing.assert_allclose(host_val(rd, ch, "manual_gain"), 10 ** (14 / 20), rtol=1e-5)
    assert not bool(host_val(rd, ch, "agc_enable"))
    pair.check(5)


def test_out_of_coverage_parks_channel(pair):
    """A tune outside front-end coverage parks the channel muted with the
    requested frequency remembered (radio.c:1472-1498); tuning back in
    coverage unparks it."""
    rd = pair.t
    eng = rd.engine
    ch = pair.cmd(200, RADIO_FREQUENCY=900_000_000.0)
    assert rd.engine is eng
    assert ch.parked and ch.freq == 900_000_000.0
    assert last_status(rd, 200)[T.RADIO_FREQUENCY] == 900_000_000.0
    assert host_val(rd, ch, "squelch_open") > 1e20
    pair.step()
    ch = pair.cmd(200, RADIO_FREQUENCY=200_000.0)
    assert not ch.parked
    assert host_val(rd, ch, "squelch_open") < 1e6
    pair.step()
    assert np.isfinite(np.asarray(rd.chans[200].last_info["baseband_power"])).all()
    pair.check(4)


def test_unpark_restores_user_params(pair):
    rd = pair.t
    ch = pair.cmd(200, GAIN=14.0, SQUELCH_OPEN=11.0)
    g14 = float(host_val(rd, ch, "manual_gain"))
    pair.cmd(200, RADIO_FREQUENCY=900_000_000.0)
    assert ch.parked
    pair.step()
    ch = pair.cmd(200, RADIO_FREQUENCY=200_000.0)
    assert not ch.parked
    np.testing.assert_allclose(host_val(rd, ch, "manual_gain"), g14, rtol=1e-6)
    np.testing.assert_allclose(host_val(rd, ch, "squelch_open"), 10 ** 1.1, rtol=1e-5)
    pair.check(4)


def test_samprate_zero_ignored(pair):
    rd = pair.t
    ch = rd.chans[200]
    g0, r0 = ch.group, ch.samprate
    pair.cmd(200, OUTPUT_SAMPRATE=0)
    assert rd.chans[200].group == g0 and rd.chans[200].samprate == r0
    pair.check(5)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_maxdelay_zero_overrides_global(dispatch, monkeypatch):
    pair = make_pair(dispatch, monkeypatch, CONF.replace("update = 5", "update = 5\nblock = 3"))
    r = pair.t
    pair.step(2)
    pair.cmd(200, MAXDELAY=0)
    assert r.chans[200].maxdelay == 0  # disables the global aggregation
    n0 = data_count(r)
    pair.step(2)
    assert data_count(r) > n0  # per-block emission resumed immediately
    pair.check(4)


def test_parked_channel_stays_muted_through_commands_and_moves(pair):
    """Runtime commands while parked land in the snapshot and apply on
    unpark; a rate-class move of a parked channel keeps it muted."""
    rd = pair.t
    pair.cmd(200, RADIO_FREQUENCY=900_000_000.0)
    ch = rd.chans[200]
    assert ch.parked
    pair.cmd(200, GAIN=20.0, SQUELCH_OPEN=5.0)
    assert float(host_val(rd, ch, "squelch_open")) > 1e20
    ch = pair.cmd(200, OUTPUT_SAMPRATE=24_000)
    assert ch.parked
    assert float(host_val(rd, ch, "squelch_open")) > 1e20
    pair.step()
    ch = pair.cmd(200, RADIO_FREQUENCY=200_000.0)
    assert not ch.parked
    np.testing.assert_allclose(host_val(rd, ch, "manual_gain"), 10.0, rtol=1e-5)
    np.testing.assert_allclose(host_val(rd, ch, "squelch_open"), 10 ** 0.5, rtol=1e-4)
    pair.step()
    assert np.isfinite(np.asarray(rd.chans[200].last_info["baseband_power"])).all()
    pair.check(4)


def test_spectrum_lazy_poll_gating(pair):
    """Sweep groups idle disarmed (spectrum.c:54-77); a poll arms the group
    by params surgery (the same engine and step), the window decays
    idle-timeout seconds after the last poll. Through the graph dispatch
    the armed and disarmed branches are two graph keys of one GraphStep."""
    rd = pair.t
    ch = rd.chans[0]
    gname = ch.group
    g = rd.engine.groups[gname]
    assert g.spec.demod == "spectrum" and g.spec.spectrum_lazy
    assert float(g.host["armed"]) == 0.0
    eng_before, step_before = rd.engine, rd.step
    pair.step(3)

    def fields():
        pair.j.encode_channel_status(pair.j.chans[0])  # both counters move alike
        return decode_status(rd.encode_channel_status(ch))[1]

    assert T.BIN_DATA not in fields()
    pair.cmd(0)  # bare poll arms it
    assert float(rd.engine.groups[gname].host["armed"]) == 1.0
    assert rd.engine is eng_before and rd.step is step_before
    pair.step(2)
    f = fields()
    assert T.BIN_DATA in f and max(f[T.BIN_DATA]) > 0.0
    pair.step(12)  # idle-timeout = 0.2 s = 10 blocks: the window decays
    assert float(rd.engine.groups[gname].host["armed"]) == 0.0
    assert T.BIN_DATA not in fields()
    assert rd.engine is eng_before and rd.step is step_before
    if pair.dispatch == "graph":
        keys = rd.graph_stats()["current"]["graphs"]
        assert any("i" in k for k in keys) and any("i" not in k for k in keys), keys
    pair.check()
