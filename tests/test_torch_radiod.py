"""The port's radiod against the JAX package's on the CPU: both daemons run
with use_network=False on the tests/test_radiod.py config (its one section
is usb, a ported mode), and the same numpy blocks go in through
step_block(block=...). RTP headers are equal and payload samples within
1 LSB; status TLVs equal field by field (integers exact, floats rtol 2e-5;
the wall-clock GPS time and block-time test point left out); the same
command packets give the same results. Then the port's own behaviour:
checkpoints, time-shards, the big-group path with egress compaction, mode
switches into every demodulator, CTCSS, WFM's stereo/mono switch and RDS
stream, the refusal of what it does not carry yet, errors that propagate,
and a multicast loopback driven by the JAX package's tune client.

The scene's steady carrier puts its channel's AGC on the strong threshold
by construction (after a strong ramp the gain is headroom/ampl, and the next
block's ampl is the same up to the noise): the side each package takes
moves the gain by about 1e-5, which neither a 1-LSB sample bound nor the
GAIN field's rtol can see, so those are compared as they are. The noise is
loud enough (-60 dBFS) that the two master FFT libraries' rounding cannot
flip a bin across the N0 estimator's cut (ROADMAP Queue 3)."""
import os
import threading
import time

import jax
import numpy as np
import pytest
import torch

from ka9q_radio_tpu.config import load_config as jload
from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
from ka9q_radio_tpu_torch.config import load_config as tload
from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader, decode_samples
from ka9q_radio_tpu_torch.net.status import StatusType as T
from ka9q_radio_tpu_torch.net.status import PacketType, decode_status, encode_status
from ka9q_radio_tpu_torch.runtime import radiod as tradiod
from ka9q_radio_tpu_torch.runtime import state_from_jax
from test_radiod import CONF

torch.set_num_threads(2)

FS = 1_024_000
UNTIMED = {T.GPS_TIME, T.TP1}  # wall clock and block time: not a function of the input


def _daemons(conf: str = CONF):
    return (JRadiod(jload(conf), use_network=False),
            tradiod.Radiod(tload(conf), use_network=False, device="cpu"))


def _block(b: int, L: int, rng, real: bool = False, carrier: float = 201_000.0) -> np.ndarray:
    t = np.arange(b * L, (b + 1) * L) / FS
    if real:
        x = 0.1 * np.cos(2 * np.pi * carrier * t) + 1e-3 * rng.standard_normal(L)
        return x.astype(np.float32)
    x = 0.1 * np.exp(2j * np.pi * carrier * t)
    x += 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def _step_both(jr, tr, nblocks: int, rng, **kw):
    for _ in range(nblocks):
        x = _block(tr.blocks, tr.engine.L, rng, **kw)
        jr.step_block(block=x)
        tr.step_block(block=x)


# (rtol, atol) of the demodulators' readouts where 2e-5 cannot hold: the
# frequency offsets are means over a block, zero up to rounding here, which
# the packages sum in another order (1e-3 Hz); the CTCSS deviation is read
# off the Goertzel resonator, which XLA runs with a contracted multiply-add
# (test_torch_demods holds it to 1e-3); the PLL's phase and offset follow
# its VCO word, held there to 1e-6 rev; the FM SNR goes through i0e/i1e,
# whose torch and XLA versions differ by a few ulp (1e-3 dB); the peak
# deviation is the largest of a block's discriminator outputs, each an atan2
# that the two libraries round apart (1e-4)
FIELD_TOL = {T.FREQ_OFFSET: (2e-5, 1e-3), T.PL_DEVIATION: (1e-3, 0.0),
             T.PLL_PHASE: (0.0, 1e-5), T.FM_SNR: (0.0, 1e-3),
             T.PEAK_DEVIATION: (1e-4, 0.0)}


def assert_same_status(pj: bytes, pt: bytes):
    kj, fj, rj = decode_status(pj)
    kt, ft, rt = decode_status(pt)
    assert kj == kt and rj == rt
    assert set(fj) == set(ft), set(fj) ^ set(ft)
    for k in fj:
        if k in UNTIMED:
            continue
        a, b = fj[k], ft[k]
        if isinstance(a, float):
            rtol, atol = FIELD_TOL.get(k, (2e-5, 1e-12))
            np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=k.name)
        elif isinstance(a, list):
            np.testing.assert_allclose(b, a, rtol=2e-5, err_msg=k.name)
        else:
            assert a == b, (k.name, a, b)


def assert_same_sent(jsent: list, tsent: list, f16=()):
    """The two daemons' packets, in order: RTP headers equal and samples
    within 1 LSB; status field by field. Streams whose SSRC is in `f16`
    carry F16LE samples (WFM's RDS companion): within 2 half-float ulp."""
    assert [k for k, _ in jsent] == [k for k, _ in tsent]
    for (kind, pj), (_, pt) in zip(jsent, tsent):
        if kind == "status":
            assert_same_status(pj, pt)
            continue
        hj, aj = RtpHeader.unpack(pj)
        ht, at = RtpHeader.unpack(pt)
        assert (hj.ssrc, hj.seq, hj.timestamp, hj.type, hj.marker) == \
            (ht.ssrc, ht.seq, ht.timestamp, ht.type, ht.marker)
        assert len(aj) == len(at)
        if hj.ssrc in f16:
            a, b = (np.frombuffer(x, "<f2").astype(np.float64) for x in (aj, at))
            assert np.all(np.abs(a - b) <= 2 * 2.0**-10 * np.maximum(np.abs(a), 2.0**-14))
            continue
        d = np.frombuffer(aj, ">i2").astype(np.int32) - np.frombuffer(at, ">i2").astype(np.int32)
        assert np.abs(d).max(initial=0) <= 1  # s16be, the configs' encoding


def _settle(*daemons):
    """Land any background pool restock now (its timing is the host's)."""
    for rd in daemons:
        rd._finish_restock(wait=True)


def _chan_table(rd) -> dict:
    return {s: (c.group, c.idx, c.freq, c.low, c.high, c.samprate, c.pt, c.preset, c.dynamic,
                c.lifetime, c.parked) for s, c in rd.chans.items()}


def _host_mirrors_equal(jr, tr):
    assert list(jr.engine.groups) == list(tr.engine.groups)
    for name, jg in jr.engine.groups.items():
        tg = tr.engine.groups[name]
        for k in ("shifts", "inc_q32", "adj_q32", "tile_lo", "slope"):
            np.testing.assert_array_equal(tg.host[k], jg.host[k], err_msg=f"{name}/{k}")
        np.testing.assert_array_equal(tg.host["responses"], jg.host["responses"])
        for k, v in jg.host["demod"].items():
            np.testing.assert_array_equal(tg.host["demod"][k], v, err_msg=f"{name}/demod/{k}")
            np.testing.assert_array_equal(tr.params[name]["demod"][k].numpy(), v)
        np.testing.assert_array_equal(tr.params[name]["shifts"].numpy(), jg.host["shifts"])


def test_rtp_and_status_match_jax():
    jr, tr = _daemons()
    rng = np.random.default_rng(31)
    _step_both(jr, tr, 12, rng)
    for tag in (42, 43):
        for rd in (jr, tr):
            rd.handle_packet(encode_status({T.OUTPUT_SSRC: 200, T.COMMAND_TAG: tag}, cmd=True))
    assert sum(k == "data" for k, _ in tr._sent) == 12
    assert sum(k == "status" for k, _ in tr._sent) == 2 + 2  # update = 5, two polls
    assert_same_sent(jr._sent, tr._sent)
    # the carrier 1 kHz above the dial is the audio's tone
    audio = np.concatenate([decode_samples(RtpHeader.unpack(p)[1], Encoding.S16BE)
                            for k, p in tr._sent[-12:] if k == "data"])
    f = np.fft.rfftfreq(audio.size, 1 / 16_000)
    assert abs(f[np.argmax(np.abs(np.fft.rfft(audio * np.hanning(audio.size))))] - 1000.0) < 20.0


def test_commands_match_jax():
    """Retune, a usb -> lsb preset (a move to another rate class: a table
    rebuild), new edges and headroom, a dynamic create whose lifetime
    expires, and a removal give the same packets, channel tables and params
    from both daemons. Background pool restocks are landed before each
    comparison and sized by dyn-slots alone: when one lands, and the pool
    the measured create rate asks for, are the host's timing, not the
    input's."""
    conf = CONF.replace("update = 5", "update = 5\nlifetime = 0.08\ndyn-slots = 2")
    jr, tr = _daemons(conf)
    for rd in (jr, tr):
        rd._pool_need = lambda gname: 0  # the provisioning rule reads the host's clock
    rng = np.random.default_rng(32)
    _step_both(jr, tr, 4, rng)
    cmds = [
        {T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 1, T.RADIO_FREQUENCY: 200_500.0},
        {T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 2, T.LOW_EDGE: -2000.0, T.HIGH_EDGE: 2000.0},
        {T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 3, T.HEADROOM: -10.0},
        {T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 4, T.PRESET: "lsb", T.RADIO_FREQUENCY: 202_000.0},
        {T.OUTPUT_SSRC: 9999, T.COMMAND_TAG: 5, T.PRESET: "usb", T.RADIO_FREQUENCY: 200_000.0},
        {T.OUTPUT_SSRC: 8888, T.COMMAND_TAG: 6, T.PRESET: "usb", T.RADIO_FREQUENCY: 199_000.0},
    ]
    for c in cmds:
        pkt = encode_status(c, cmd=True)
        jr.handle_packet(pkt)
        tr.handle_packet(pkt)
        _settle(jr, tr)
        assert _chan_table(tr) == _chan_table(jr)
        _host_mirrors_equal(jr, tr)
        _step_both(jr, tr, 1, rng)
    assert tr.chans[200].preset == "lsb" and tr.chans[200].group != "hf"
    assert tr.chans[9999].dynamic and 8888 in tr.chans
    for rd in (jr, tr):
        rd.remove_channel(8888)
    _settle(jr, tr)
    assert _chan_table(tr) == _chan_table(jr) and 8888 not in tr.chans
    assert {g: sorted(v) for g, v in tr.free_slots.items()} == \
        {g: sorted(v) for g, v in jr.free_slots.items()}
    _step_both(jr, tr, 6, rng)  # lifetime 0.08 s = 4 blocks: 9999 expires
    _settle(jr, tr)
    assert 9999 not in tr.chans and 9999 not in jr.chans
    assert {g: sorted(v) for g, v in tr.free_slots.items()} == \
        {g: sorted(v) for g, v in jr.free_slots.items()}
    _host_mirrors_equal(jr, tr)
    assert_same_sent(jr._sent, tr._sent)


def test_checkpoint_round_trip(tmp_path):
    """The carried state, the host mirrors and the generator survive a
    save and restore: the restored daemon's next block equals the
    original's."""
    rd = tradiod.Radiod(tload(CONF), use_network=False, device="cpu")
    for _ in range(6):
        rd.step_block()
    path = str(tmp_path / "state.npz")
    rd.save_checkpoint(path)
    before = rd.step_block()
    rd2 = tradiod.Radiod(tload(CONF), use_network=False, device="cpu")
    assert rd2.load_checkpoint(path)
    assert rd2.blocks == 6 and rd2.state["host"]["jobnum"] == 6
    after = rd2.step_block()
    np.testing.assert_array_equal(before["hf"]["audio"], after["hf"]["audio"])
    assert rd2.chans[200].rtp_timestamp == rd.chans[200].rtp_timestamp
    # a different channel table refuses cleanly
    rd3 = tradiod.Radiod(tload(CONF.replace("freq = 200k0", "freq = 200k0 210k0")),
                         use_network=False, device="cpu")
    assert not rd3.load_checkpoint(path)


def test_time_shards_equal_single_steps():
    """time-shards = 2: two blocks a dispatch, one device->host copy; the
    packets equal those of two single steps."""
    conf2 = CONF.replace("update = 5", "update = 4\ntime-shards = 2")
    conf1 = CONF.replace("update = 5", "update = 4")
    r2 = tradiod.Radiod(tload(conf2), use_network=False, device="cpu")
    r1 = tradiod.Radiod(tload(conf1), use_network=False, device="cpu")
    rng = np.random.default_rng(33)
    L = r1.engine.L
    for d in range(5):
        pair = np.stack([_block(2 * d, L, rng), _block(2 * d + 1, L, rng)])
        r2.step_block(block=pair)
        r1.step_block(block=pair[0])
        r1.step_block(block=pair[1])
    assert r2.blocks == r1.blocks == 10
    assert [k for k, _ in r2._sent] == [k for k, _ in r1._sent]
    for (kind, a), (_, b) in zip(r2._sent, r1._sent):
        if kind == "data":
            assert a == b
        else:
            assert_same_status(a, b)


BIG = """
[global]
hardware = sig_gen
mode = usb
update = 2
big-group = 4
[sig_gen]
device = sig_gen
samprate = 1m024
real = yes
carrier = 60k7
amplitude = -20
noise = -60
[hf]
mode = usb
samprate = 12k
raster = 40k 120k 10k
snr-squelch = yes
squelch-open = 8
squelch-close = 7
egress-slots = 4
"""


def test_big_group_egress_matches_jax():
    """A big-group threshold of 4 puts the 8-channel group on the scalable
    path (lazy info, squelch-compacted egress into 4 slots): the packets,
    the overflow count and the open channel match JAX's."""
    jr, tr = _daemons(BIG)
    assert tr.engine.groups["hf"].spec.egress_slots == 4 and tr.engine.groups["hf"].C == 8
    rng = np.random.default_rng(34)
    _step_both(jr, tr, 16, rng, real=True, carrier=60_700.0)
    assert isinstance(tr.chans[60].last_info, tradiod._LazyGroupInfo)
    assert tr.egress_overflows == jr.egress_overflows
    assert_same_sent(jr._sent, tr._sent)
    late = {int.from_bytes(p[8:12], "big") for k, p in tr._sent[-30:] if k == "data"}
    assert late == {60}


@pytest.mark.parametrize("budget", [16, 2])
def test_big_group_beacons_keep_each_channels_interval(budget):
    """A big group (8 channels, big-group 4, update 2) with mixed
    STATUS_INTERVAL overrides on the native edge: the channel whose beacons
    are off (ssrc 50) sends none, the one set to 5 blocks (ssrc 70) beacons
    every 5th block, the others every 2nd, and no block encodes more than
    beacon-budget. With a budget of 2 the intervals stretch to fit. The JAX
    daemon takes the first channel's interval for all (its fault, kept
    there); wherever both beacon a channel in the same block, the status
    is JAX's field for field but for the channel's count of them."""
    tag = f"torch-beacon-{os.getpid()}-{budget}"
    conf = BIG.replace("big-group = 4", f"big-group = 4\nbeacon-budget = {budget}\n"
                       f"status = {tag}.local\ndata = {tag}-pcm.local\n"
                       "advertise = no\nsap = no\nttl = 0")
    jr = JRadiod(jload(conf), use_network=True)
    tr = tradiod.Radiod(tload(conf), use_network=True, device="cpu")
    assert "hf" in tr.edges and "hf" in jr.edges
    seen = {}
    for rd in (jr, tr):
        for ssrc, every in ((50, 0), (70, 5)):
            rd.handle_packet(encode_status({T.OUTPUT_SSRC: ssrc, T.COMMAND_TAG: ssrc,
                                            T.STATUS_INTERVAL: every}, cmd=True))
        sent = seen[id(rd)] = []
        rd._send_beacon = lambda pkt, ch=None, rd=rd, sent=sent: sent.append(
            (rd.blocks, ch.ssrc, pkt))
    _step_both(jr, tr, 20, np.random.default_rng(41), real=True, carrier=60_700.0)
    tsent, jsent = seen[id(tr)], seen[id(jr)]
    per_block = {}
    for b, ssrc, _ in tsent:
        per_block.setdefault(b, []).append(ssrc)
    assert max(len(v) for v in per_block.values()) <= budget
    blocks_of = {s: [b for b, ss, _ in tsent if ss == s] for s in range(40, 120, 10)}
    assert blocks_of[50] == []
    gaps = {s: set(np.diff(v)) for s, v in blocks_of.items() if s != 50}
    if budget == 16:
        assert gaps[70] == {5} and all(gaps[s] == {2} for s in gaps if s != 70), gaps
    else:  # 6 channels of interval 2 and one of 5 share 2 encodes a block
        assert gaps[70] == {5} and all(gaps[s] == {6} for s in gaps if s != 70), gaps
    both = {(b, s): p for b, s, p in jsent}
    common = [(p, both[b, s]) for b, s, p in tsent if (b, s) in both]
    assert len(common) >= 5
    for pt, pj in common:
        # the count of the channel's status packets so far follows the
        # cadence, which is what differs
        assert_same_status(*(_without(p, T.OUTPUT_METADATA_PACKETS) for p in (pj, pt)))


@pytest.mark.parametrize("budget,counts,intervals", [
    # 32,766 channels at update 25, one overridden to 50 and one to 100
    (16, {25: 32766, 50: 1, 100: 1}, {25: 2341, 50: 50, 100: 100}),
    (3, {2: 30, 4: 4, 9: 1}, {2: 30, 4: 4, 9: 9}),
    # more intervals than the budget: the classes take turns
    (2, {2: 4, 3: 2, 5: 1, 7: 1}, {2: 8, 3: 4, 5: 6, 7: 8}),
])
def test_big_group_beacons_under_budget_pressure(budget, counts, intervals):
    """Three or more beacon intervals whose slices exceed beacon-budget:
    every channel whose beacons are on beacons at one fixed interval, never
    faster than its own, no block encodes more than the budget, and the
    off channel sends none."""
    from types import SimpleNamespace as NS
    chans = [NS(update_every=u, ssrc=i) for i, u in
             enumerate(u for u, n in counts.items() for _ in range(n))]
    chans.append(NS(update_every=0, ssrc=len(chans)))
    sent = []
    rd = NS(blocks=0, update_every=25, beacon_budget=budget, _beacon_plans={},
            encode_channel_status=lambda ch: b"",
            _send_beacon=lambda pkt, ch: sent.append((rd.blocks, ch.ssrc)))
    nb = 3 * max(intervals.values())
    for rd.blocks in range(nb):
        tradiod.Radiod._staggered_beacons(rd, "g", chans)
    per_block = np.bincount([b for b, _ in sent], minlength=nb)
    assert per_block.max() <= budget
    blocks_of: dict[int, list] = {}
    for b, s in sent:
        blocks_of.setdefault(s, []).append(b)
    assert chans[-1].ssrc not in blocks_of
    silent = {ch.update_every for ch in chans[:-1] if len(blocks_of.get(ch.ssrc, [])) < 2}
    assert not silent, f"intervals whose channels did not beacon twice: {silent}"
    for ch in chans[:-1]:
        got = blocks_of[ch.ssrc]
        assert set(np.diff(got)) == {intervals[ch.update_every]}, (ch.update_every, got[:4])
        assert intervals[ch.update_every] >= ch.update_every


def _without(pkt: bytes, field) -> bytes:
    ptype, f, _ = decode_status(pkt)
    f.pop(field)
    return encode_status(f, cmd=ptype == PacketType.CMD)


@pytest.mark.parametrize("fields,demod", [
    ({T.PRESET: "fm"}, "fm"), ({T.DEMOD_TYPE: 1}, "fm"),
    ({T.PRESET: "am"}, "linear"), ({T.PRESET: "cwu"}, "linear")])
def test_mode_command_switches_channel(fields, demod):
    """A preset or demod switch moves the channel into a group of the new
    class in both daemons alike (the same channel tables, host params and
    packets), and a dynamic create in nfm makes its channel."""
    jr, tr = _daemons()
    for rd in (jr, tr):
        rd._pool_need = lambda gname: 0  # the provisioning rule reads the host's clock
    rng = np.random.default_rng(37)
    _step_both(jr, tr, 2, rng)
    for f in ({T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 7, T.RADIO_FREQUENCY: 190_000.0, **fields},
              {T.OUTPUT_SSRC: 7777, T.COMMAND_TAG: 8, T.PRESET: "nfm",
               T.RADIO_FREQUENCY: 150_000.0}):
        pkt = encode_status(f, cmd=True)
        jr.handle_packet(pkt)
        tr.handle_packet(pkt)
        _settle(jr, tr)
        assert _chan_table(tr) == _chan_table(jr)
        _host_mirrors_equal(jr, tr)
    assert tr.engine.groups[tr.chans[200].group].spec.demod == demod
    assert 7777 in tr.chans and tr.engine.groups[tr.chans[7777].group].spec.demod == "fm"
    _step_both(jr, tr, 4, rng)
    assert_same_sent(jr._sent, tr._sent)


# the id keeps the case's name from when the refusal pointed at ROADMAP item 17
@pytest.mark.parametrize("edit,match", [(("[global]", "[global]\nmesh = yes"),
                                         "every local CUDA device")], ids=["edit0-item 17"])
def test_unported_at_startup_raises(edit, match, monkeypatch):
    """`mesh = yes` builds its mesh over every local CUDA device: on a host
    without one the daemon refuses at startup rather than run the sharded
    engine (or the single-device one) on the CPU; a CPU mesh is only ever
    the caller's own (Radiod(mesh=...), tests/test_torch_timeshard.py)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=match):
        tradiod.Radiod(tload(CONF.replace(*edit)), use_network=False, device="cpu")


def test_fm_section_starts():
    """An nfm section, which earlier slices refused at startup, starts its
    channel in an FM group and the daemon runs it like the JAX daemon: the
    same channel table and packets."""
    conf = CONF.replace("[hf]", "[fm]\nmode = nfm\nfreq = 150k0\n[hf]")
    jr, tr = _daemons(conf)
    ch = next(c for c in tr.chans.values() if c.freq == 150_000.0)
    assert tr.engine.groups[ch.group].spec.demod == "fm"
    assert _chan_table(tr) == _chan_table(jr)
    _step_both(jr, tr, 4, np.random.default_rng(39), carrier=150_000.0)
    assert_same_sent(jr._sent, tr._sent)


CTCSS = """
[global]
hardware = sig_gen
mode = pm
update = 4
[sig_gen]
device = sig_gen
samprate = 1m024
real = no
carrier = 0
amplitude = -200
[repeaters]
samprate = 24k
freq0 = 150k0
tone0 = 100.0
freq1 = 150k0
tone1 = 103.5
freq2 = 250k0
"""


def _fm_block(b: int, L: int, rng, carrier=150_000.0, tone=100.0) -> np.ndarray:
    """An FM carrier with a 1 kHz tone at 2.5 kHz deviation and a CTCSS tone
    at 500 Hz deviation, over noise."""
    t = np.arange(b * L, (b + 1) * L) / FS
    ph = 2 * np.pi * carrier * t + 2.5 * np.sin(2 * np.pi * 1000 * t) \
        + 500.0 / tone * np.sin(2 * np.pi * tone * t)
    x = 0.1 * np.exp(1j * ph) + 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def _audio_of(sent, ssrc):
    return np.concatenate([decode_samples(RtpHeader.unpack(p)[1], Encoding.S16BE)
                           for k, p in sent if k == "data" and RtpHeader.unpack(p)[0].ssrc == ssrc]
                          or [np.zeros(0)])


def test_ctcss_opens_and_mutes_like_jax():
    """Two pm channels on one FM carrier with a 100 Hz CTCSS tone: the one
    configured for 100.0 Hz opens after two 240 ms integrations agree on the
    tone's phase (fm.c:279-325) and carries the 1 kHz audio; the one
    configured for 103.5 Hz stays tone-muted (silent frames), as in the JAX
    daemon: the same packets and status fields (PL_TONE, PL_DEVIATION,
    FM_SNR, THRESH_EXTEND, ...). Then a PL tone command retunes the muted
    one's decoder to 100.0 Hz, and it opens; a threshold-extend command
    reaches the group's params."""
    jr, tr = _daemons(CTCSS)
    assert tr.engine.groups["repeaters"].spec.ctcss
    rng = np.random.default_rng(38)
    for _ in range(28):
        x = _fm_block(tr.blocks, tr.engine.L, rng)
        jr.step_block(block=x)
        tr.step_block(block=x)
    assert_same_sent(jr._sent, tr._sent)
    a150, a151 = _audio_of(tr._sent[-12:], 150), _audio_of(tr._sent[-12:], 151)
    assert np.abs(a150).max() > 0.01 and a151.size and np.abs(a151).max() == 0.0
    f = np.fft.rfftfreq(a150.size, 1 / 24_000)
    assert abs(f[np.argmax(np.abs(np.fft.rfft(a150 * np.hanning(a150.size))))] - 1000) < 30
    jr.encode_channel_status(jr.chans[151])  # both counters move alike
    _, fields, _ = decode_status(tr.encode_channel_status(tr.chans[151]))
    assert fields[T.PL_TONE] == pytest.approx(103.5) and bool(fields[T.THRESH_EXTEND])
    n = len(tr._sent)
    for rd in (jr, tr):
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: 151, T.COMMAND_TAG: 9, T.PL_TONE: 100.0,
                                        T.THRESH_EXTEND: 0}, cmd=True))
    assert tr.engine.groups["repeaters"].host["demod"]["tone_freq"][1] == np.float32(100.0)
    assert not tr.params["repeaters"]["demod"]["threshold_ext"][1]
    for _ in range(26):
        x = _fm_block(tr.blocks, tr.engine.L, rng)
        jr.step_block(block=x)
        tr.step_block(block=x)
    assert_same_sent(jr._sent, tr._sent)
    assert np.abs(_audio_of(tr._sent[n:][-8:], 151)).max() > 0.01


WFM = """
[global]
hardware = sig_gen
update = 3
rds = yes
[sig_gen]
device = sig_gen
samprate = 1m024
real = no
carrier = 0
amplitude = -200
[fm]
mode = wfm
freq = 300k0
"""


def _wfm_block(b: int, L: int, pilot: bool) -> np.ndarray:
    """A stereo (or, without the pilot, mono) FM broadcast station at
    300 kHz: L = 700 Hz, R = 1,100 Hz, 75 kHz deviation; its phase is the
    composite's exact integral, so any block can be made alone."""
    from torch_scenes import dsb_integral

    t = np.arange(b * L, (b + 1) * L) / FS
    w = 2 * np.pi
    ph = 0.225 * (-np.cos(w * 700 * t) / (w * 700) - np.cos(w * 1100 * t) / (w * 1100))
    if pilot:
        ph = ph + 0.1 * -np.cos(w * 19e3 * t) / (w * 19e3) + 0.225 * dsb_integral(t)
    x = 0.1 * np.exp(1j * (w * 300e3 * t + w * 75e3 * ph))
    return (x + 1e-4).astype(np.complex64)


def test_wfm_stereo_switch_and_rds_like_jax():
    """A WFM station with `rds = yes`: the stereo payload type while the
    pilot is on, the mono one after it goes, switched per block; and the
    RDS companion stream on ssrc + 1 (F16LE, 48 kHz); the same packets and
    status as the JAX daemon's. The first two blocks are left out of the
    comparison (the discriminator's turn-on transient, where atan2 of
    near-zero samples is ill-conditioned, reaches the second through the
    composite's overlap and the frequency offset's slow average): after
    them the port continues from the JAX daemon's carried state. So are the
    RDS samples after the pilot goes (the derotation divides by a pilot of
    noise)."""
    jr, tr = _daemons(WFM)
    ch = tr.chans[300]
    assert (ch.samprate, ch.channels) == (48_000, 2) and tr.chans[301].rds
    assert tr.chans[301].encoding == Encoding.F16LE and "fm" not in tr.edges
    for b in range(12):
        if b == 2:
            jr._sent.clear()
            tr._sent.clear()
            tr.state = state_from_jax(jax.device_get(jr.state), device="cpu")
        x = _wfm_block(b, tr.engine.L, pilot=b < 7)
        jr.step_block(block=x)
        tr.step_block(block=x)
        if b == 6:
            assert_same_sent(jr._sent, tr._sent, f16=(301,))
            n_st = len(tr._sent)
    keep = lambda sent: [(k, p) for i, (k, p) in enumerate(sent)  # noqa: E731
                         if i < n_st or k != "data" or RtpHeader.unpack(p)[0].ssrc != 301]
    assert_same_sent(keep(jr._sent), keep(tr._sent), f16=(301,))
    pts = [RtpHeader.unpack(p)[0].type for k, p in tr._sent
           if k == "data" and RtpHeader.unpack(p)[0].ssrc == 300]
    st, mo = (tr.registry.pt_from_info(48_000, n, Encoding.S16BE) for n in (2, 1))
    assert st in pts[:5] and pts[-1] == mo and set(pts) == {st, mo}
    assert any(k == "data" and RtpHeader.unpack(p)[0].ssrc == 301 for k, p in tr._sent)
    # OUTPUT_CHANNELS = 1 turns stereo off (radio_status.c:452-456)
    n = len(tr._sent)
    for rd in (jr, tr):
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: 300, T.COMMAND_TAG: 3,
                                        T.OUTPUT_CHANNELS: 1}, cmd=True))
    assert not tr.engine.groups["fm"].host["demod"]["stereo_enable"][0]
    assert_same_sent(jr._sent[n:], tr._sent[n:])


@pytest.mark.parametrize("preset", ["sam", "isb", "iq", "cwl", "wfm"])
def test_linear_and_wfm_status_fields_match_jax(preset):
    """A channel moved to each new class reports the PLL (lock, phase,
    offset, wraps), filter2/ISB or FM fields the JAX daemon reports, byte
    for byte up to the float bounds, on its polls."""
    jr, tr = _daemons()
    rng = np.random.default_rng(39)
    _step_both(jr, tr, 2, rng)
    for rd in (jr, tr):
        rd._pool_need = lambda gname: 0
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 5,
                                        T.PRESET: preset}, cmd=True))
    _settle(jr, tr)
    _step_both(jr, tr, 6, rng)
    for rd in (jr, tr):
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: 200, T.COMMAND_TAG: 6}, cmd=True))
    assert_same_sent(jr._sent, tr._sent)
    _, fields, _ = decode_status(tr._sent[-1][1])
    want = {"sam": T.PLL_LOCK, "isb": T.INDEPENDENT_SIDEBAND, "iq": T.PLL_ENABLE,
            "cwl": T.FILTER2_FIR_LENGTH, "wfm": T.DEEMPH_TC}[preset]
    assert want in fields


def test_engine_error_propagates(monkeypatch):
    """An error of the engine step is never a dropped block: step_block
    raises it and counts no drop."""
    def broken(self, state, params, block):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(tradiod.Engine, "step", broken)
    rd = tradiod.Radiod(tload(CONF), use_network=False, device="cpu")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        rd.step_block()
    assert rd.block_drops == 0 and rd.blocks == 0


def test_frontend_read_gaps_count_drops():
    """Block drops count the front end's read gaps, and only those."""
    rd = tradiod.Radiod(tload(CONF), use_network=False, device="cpu")

    class Starved:
        timeouts = 0

        def read_block(self, L):
            self.timeouts += 1  # the reader zero-filled this block
            return np.zeros(L, np.complex64)

    rd.frontend, rd.source_state = Starved(), None
    rd.step_block()
    rd.step_block()
    assert rd.block_drops == 2 and rd.blocks == 2


def test_radiod_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tradiod.Radiod(tload(CONF), use_network=False)


def test_cli_runs_on_cpu(tmp_path, capsys):
    from ka9q_radio_tpu_torch.cli.radiod import main

    path = tmp_path / "radiod.conf"
    path.write_text(CONF)
    assert main(["--device", "cpu", "--no-network", "--flat-out", "--blocks", "3",
                 "-v", str(path)]) == 0
    err = capsys.readouterr().err
    assert "1 channels ready on cpu" in err and "3 blocks" in err


def _loopback_daemon(conf: str):
    rd = tradiod.Radiod(tload(conf), use_network=True, device="cpu")
    stop = threading.Event()

    def run():
        while not stop.is_set():
            rd.step_block()

    t = threading.Thread(target=run, daemon=True)
    t.start()
    deadline = time.time() + 30
    while rd.blocks < 4 and time.time() < deadline:
        time.sleep(0.05)
    return rd, stop, t


def test_loopback_tune_client(capsys):
    """The JAX package's tune client polls and retunes the port's daemon
    over multicast loopback."""
    from ka9q_radio_tpu.cli.tune import main as tune

    tag = f"torch-lb-{os.getpid()}"
    conf = CONF.replace("status = test.local", f"status = {tag}.local").replace(
        "data = test-pcm.local", f"data = {tag}-pcm.local").replace(
        "[global]", "[global]\nadvertise = no\nsap = no\nttl = 0")
    rd, stop, t = _loopback_daemon(conf)
    try:
        assert tune(["--radio", f"{tag}.local", "--ssrc", "200", "--timeout", "5"]) == 0
        out = capsys.readouterr().out
        assert "RADIO_FREQUENCY" in out and "200000" in out
        assert tune(["--radio", f"{tag}.local", "--ssrc", "200", "-f", "201k5",
                     "--timeout", "5"]) == 0
        assert "201500" in capsys.readouterr().out
        assert rd.chans[200].freq == 201_500.0
    finally:
        stop.set()
        t.join(timeout=10)


def test_loopback_native_edge():
    """With g++ present the big group sends through the native edge
    (sendmmsg, indexed by the egress compaction): only the carrier's channel
    reaches the wire, and every channel beacons from the edge's socket."""
    import select
    import shutil

    from ka9q_radio_tpu_torch.net.multicast import listen_socket, resolve_dest

    if shutil.which("g++") is None:
        pytest.skip("no g++: the native edge cannot build here")
    tag = f"torch-edge-{os.getpid()}"
    conf = BIG.replace("[global]", f"[global]\nstatus = {tag}-ctl.local\ndata = {tag}-pcm.local\n"
                                   "advertise = no\nsap = no\nttl = 0")
    rd = tradiod.Radiod(tload(conf), use_network=True, device="cpu")
    assert "hf" in rd.edges, "the native edge did not come up"
    rx = listen_socket(resolve_dest(f"{tag}-pcm.local", 5004))
    rx_st = listen_socket(resolve_dest(f"{tag}-pcm.local", 5006))
    for _ in range(8):  # warm-up opens every squelch for a block or two
        rd.step_block()
    while select.select([rx, rx_st], [], [], 0)[0]:
        for sk in select.select([rx, rx_st], [], [], 0)[0]:
            sk.recvfrom(65536)
    audio, beacons = set(), set()
    deadline = time.time() + 30
    n = 0
    while time.time() < deadline and (n < 30 or len(beacons) < 8):
        rd.step_block()
        n += 1
        for sk in select.select([rx, rx_st], [], [], 0)[0]:
            pkt, _ = sk.recvfrom(65536)
            if sk is rx and len(pkt) > 12:
                audio.add(int.from_bytes(pkt[8:12], "big"))
            elif sk is rx_st:
                ssrc = decode_status(pkt)[1].get(T.OUTPUT_SSRC)
                if ssrc is not None:
                    beacons.add(ssrc)
    assert audio == {60}, audio
    assert beacons >= {40, 50, 60, 70, 80, 90, 100, 110}, beacons
    rx.close()
    rx_st.close()


def _no_edge(reason):
    raise OSError(reason)


@pytest.mark.parametrize("patch,said", [
    (dict(native_available=lambda: False), "native edge unavailable"),
    (dict(native_available=lambda: True, native_has_opus=lambda: False,
          RtpEdge=lambda *a, **k: _no_edge("no socket")), "[hf] native edge to"),
], ids=["build", "socket"])
def test_native_edge_failure_is_said(monkeypatch, capsys, patch, said):
    """A big group left on the Python path (it cannot keep up there) says
    why on stderr, and the daemon goes on."""
    import ka9q_radio_tpu_torch.native as native

    for name, fn in patch.items():
        monkeypatch.setattr(native, name, fn)
    tag = f"torch-noedge-{os.getpid()}"
    conf = BIG.replace("[global]", f"[global]\nstatus = {tag}-ctl.local\ndata = {tag}-pcm.local\n"
                                   "advertise = no\nsap = no\nttl = 0")
    rd = tradiod.Radiod(tload(conf), use_network=True, device="cpu")
    assert rd.edges == {}
    assert said in capsys.readouterr().err
    rd.step_block()
    assert rd.blocks == 1


def test_file_source_matches_jax(tmp_path):
    """A capture file through the file front end of both daemons (the block
    crosses to the device from pinned host memory in the port): the same
    packets."""
    rng = np.random.default_rng(35)
    L = 20_480
    x = np.concatenate([_block(b, L, rng) for b in range(8)])
    inter = np.empty(2 * x.size, np.float32)
    inter[0::2], inter[1::2] = x.real, x.imag
    path = tmp_path / "hf.iq"
    path.write_bytes(inter.astype("<f4").tobytes())
    conf = f"""
[global]
hardware = cap
mode = usb
update = 3
[cap]
device = file
path = {path}
samprate = 1m024
format = cf32le
[hf]
mode = usb
samprate = 16k
freq = 200k0
"""
    jr, tr = _daemons(conf)
    assert type(tr.frontend).__module__ == "ka9q_radio_tpu_torch.runtime.frontends"
    for _ in range(8):
        jr.step_block()
        tr.step_block()
    assert tr.block_drops == 0
    assert_same_sent(jr._sent, tr._sent)


@pytest.mark.parametrize("native", [False, True], ids=["python", "native"])
def test_rtp_source_matches_jax(native):
    """An RTP A/D stream with one lost packet, read by the port's RtpSource
    and the JAX package's side by side (Python reassembly, or the native
    recvmmsg ring built from the port's own rtp_edge.cpp): the same
    samples, the loss zero-filled."""
    import shutil
    import socket

    from ka9q_radio_tpu.runtime.frontends import RtpSource as JRtpSource
    from ka9q_radio_tpu_torch.net.multicast import make_maddr
    from ka9q_radio_tpu_torch.net.rtp import encode_samples
    from ka9q_radio_tpu_torch.runtime.frontends import RtpSource

    if native and shutil.which("g++") is None:
        pytest.skip("no g++: the native reader cannot build here")
    stream = f"torch-feed-{os.getpid()}-{int(native)}.local"
    port = 46000 + os.getpid() % 1000 + 7 * int(native)
    kw = dict(samprate=48_000, real=False, encoding="s16be", native=native)
    tsrc, jsrc = RtpSource(f"{stream}:{port}", **kw), JRtpSource(f"{stream}:{port}", **kw)
    assert (tsrc._native is not None) == native
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    tx.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, 0)
    rng = np.random.default_rng(36)
    nf = 240
    for k in range(40):
        iq = 0.3 * (rng.standard_normal(nf) + 1j * rng.standard_normal(nf)) / 4
        x = np.empty(2 * nf, np.float32)
        x[0::2], x[1::2] = iq.real, iq.imag
        if k != 20:
            hdr = RtpHeader(type=97, seq=k, timestamp=k * nf, ssrc=7)
            tx.sendto(hdr.pack() + encode_samples(x, Encoding.S16BE), (make_maddr(stream), port))
    time.sleep(0.3)
    a, b = tsrc.read_block(39 * nf, timeout=1.0), jsrc.read_block(39 * nf, timeout=1.0)
    assert a.dtype == np.complex64
    np.testing.assert_array_equal(a, b)
    assert np.all(a[20 * nf: 21 * nf] == 0) and np.abs(a[:nf]).max() > 0
    for s in (tsrc, jsrc):
        s.close()
    tx.close()
