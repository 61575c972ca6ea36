"""The port's RTCP, SAP and doppler steering held to the JAX package's: the
twins of tests/test_rtcp_doppler.py. The builders' bytes equal (the SR's
NTP time words aside, which read the wall clock), each package parses the
other's packets, the daemons send the same RTCP and SAP for the same
channel table, and doppler steering moves the same shifts block by block
(eager and through the emulated graph dispatch)."""
import numpy as np
import pytest
import torch

from ka9q_radio_tpu.net import rtcp as jrtcp
from ka9q_radio_tpu.net import sap as jsap
from ka9q_radio_tpu_torch.net import rtcp as trtcp
from ka9q_radio_tpu_torch.net import sap as tsap
from ka9q_radio_tpu_torch.net.status import StatusType as T
from test_rtcp_doppler import CONF
from torch_parity import FS, DaemonPair

torch.set_num_threads(2)

NTP_WORDS = slice(8, 16)  # the SR's NTP seconds and fraction


def _without_ntp(pkt: bytes) -> bytes:
    return pkt[:NTP_WORDS.start] + pkt[NTP_WORDS.stop:]


def scene(b: int, L: int, rng) -> np.ndarray:
    t = np.arange(b * L, (b + 1) * L) / FS
    x = 0.1 * np.exp(2j * np.pi * 201_000 * t)
    x += 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def test_rtcp_roundtrip():
    pkts = {}
    for name, m in (("jax", jrtcp), ("port", trtcp)):
        pkts[name] = m.compound(
            m.build_sr(1234, 987654, 42, 100000),
            m.build_sdes(1234, "radiod-tpu test"),
            m.build_bye([1234, 5678]),
        )
    assert _without_ntp(pkts["port"]) == _without_ntp(pkts["jax"])
    # the same wall clock gives the same bytes whole
    assert trtcp.build_sr(7, 8, 9, 10, when=1.7e9) == jrtcp.build_sr(7, 8, 9, 10, when=1.7e9)
    for parse, pkt in ((trtcp.parse_rtcp, pkts["port"]), (trtcp.parse_rtcp, pkts["jax"]),
                       (jrtcp.parse_rtcp, pkts["port"])):
        items = parse(pkt)
        assert [pt for pt, _ in items] == [200, 202, 203]
        sr = items[0][1]
        assert sr["ssrc"] == 1234 and sr["rtp_timestamp"] == 987654 and sr["packets"] == 42
        assert sr["ntp_sec"] > 3_900_000_000  # sane NTP era
        assert items[1][1]["items"][1] == "radiod-tpu test"
        assert items[2][1]["ssrcs"] == [1234, 5678]


class _Recorder:
    """Stands in for the RTCP socket and the SAP announcer."""

    def __init__(self):
        self.sent = []

    def sendto(self, pkt, addr):
        self.sent.append((pkt, addr))

    def announce(self, *args):
        self.sent.append(args)


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_daemon_rtcp_and_sap_match_jax(dispatch, monkeypatch):
    """Both daemons, their RTCP socket and SAP announcer recorded, send the
    same SR + SDES compound for the open channel (the NTP words aside) to
    the same address, and announce the same session."""
    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=61)
    pair.step(4)
    for rd in (pair.j, pair.t):
        rd.rtcp_sock, rd.sap = _Recorder(), _Recorder()
        rd._data_dest = rd._sap_dest = ("239.1.2.3", 5004)
        rd._sap_ttl = 1
        rd._send_rtcp()
        rd._send_sap()
    (jp, ja), = pair.j.rtcp_sock.sent
    (tp, ta), = pair.t.rtcp_sock.sent
    assert ta == ja == ("239.1.2.3", 5005)
    assert _without_ntp(tp) == _without_ntp(jp)
    sr, sdes = trtcp.parse_rtcp(tp)
    assert sr[1]["ssrc"] == 200 and sr[1]["packets"] == 4 and sdes[1]["items"][1].endswith("200")
    assert pair.t.sap.sent == pair.j.sap.sent
    pair.check()


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_doppler_steering(dispatch, monkeypatch):
    """A doppler rate of +50 kHz/s (1 kHz a block) steers the channel's
    shift block by block as JAX's does, the two daemons' shifts equal after
    every block; cancelling restores the nominal frequency in both."""
    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=62)
    rd = pair.t
    pair.step(3)
    shift0 = int(np.asarray(rd.params["hf"]["shifts"][0]))
    pair.send({T.OUTPUT_SSRC: 200, T.DOPPLER_FREQUENCY: 0.0, T.DOPPLER_FREQUENCY_RATE: 50_000.0})
    assert 200 in rd.doppler
    shifts = []
    for _ in range(12):
        pair.step()
        s = int(np.asarray(rd.params["hf"]["shifts"][0]))
        assert s == int(np.asarray(pair.j.params["hf"]["shifts"][0]))
        assert rd.doppler == pair.j.doppler
        shifts.append(s)
    assert len(set(shifts)) == len(shifts)  # it moved every block
    moved_hz = (shifts[9] - shift0) * rd.engine.samprate / rd.engine.master.N
    assert 8_000 < moved_hz < 12_000, moved_hz  # ~10 blocks * 1 kHz
    pair.send({T.OUTPUT_SSRC: 200, T.DOPPLER_FREQUENCY: 0.0, T.DOPPLER_FREQUENCY_RATE: 0.0})
    assert 200 not in rd.doppler and 200 not in pair.j.doppler
    assert int(np.asarray(rd.params["hf"]["shifts"][0])) == shift0
    pair.check(2)
    assert int(np.asarray(rd.params["hf"]["shifts"][0])) == shift0


def test_sap_sdp_roundtrip():
    args = ("my radio", "239.1.2.3", 5004, "10.0.0.1",
            [(77, "L16", 24000, 1), (123, "opus", 48000, 2)])
    sdp = tsap.build_sdp(*args, session_id=1234)
    assert sdp == jsap.build_sdp(*args, session_id=1234)
    assert "m=audio 5004 RTP/AVP 77 123" in sdp
    assert "a=rtpmap:77 L16/24000/1" in sdp
    assert "c=IN IP4 239.1.2.3/1" in sdp
    pkt = tsap.build_sap(sdp, "10.0.0.1", msg_id=42)
    assert pkt == jsap.build_sap(sdp, "10.0.0.1", msg_id=42)
    for parse in (tsap.parse_sap, jsap.parse_sap):
        origin, msg_id, deletion, text = parse(pkt)
        assert origin == "10.0.0.1" and msg_id == 42 and not deletion
        assert text == sdp
    assert tsap.parse_sap(tsap.build_sap(sdp, "10.0.0.1", 7, deletion=True))[2]


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_doppler_rate_with_time_shards(dispatch, monkeypatch):
    """With `time-shards = 2` a dispatch is two blocks: the port's offset
    advances two blocks' worth a dispatch, so the tuning walks at the
    commanded rate (10 kHz over 10 blocks at 50 kHz/s); the JAX daemon
    advances one block's worth a dispatch and walks at half the rate (its
    defect, kept there: ROADMAP Queue 3). Cancelling restores the nominal
    shift in both."""
    pair = DaemonPair(CONF.replace("update = 100", "update = 100\ntime-shards = 2"), dispatch,
                      monkeypatch, scene, seed=63)
    rd = pair.t
    pair.step(2)
    shift0 = int(np.asarray(rd.params["hf"]["shifts"][0]))
    pair.send({T.OUTPUT_SSRC: 200, T.DOPPLER_FREQUENCY: 0.0, T.DOPPLER_FREQUENCY_RATE: 50_000.0})
    pair.step(5)
    hz = rd.engine.samprate / rd.engine.master.N
    moved = {name: (int(np.asarray(r.params["hf"]["shifts"][0])) - shift0) * hz
             for name, r in (("port", rd), ("jax", pair.j))}
    assert rd.doppler[200][0] == pytest.approx(10_000.0)
    assert pair.j.doppler[200][0] == pytest.approx(5_000.0)
    assert abs(moved["port"] - 10_000.0) <= hz and abs(moved["jax"] - 5_000.0) <= hz, moved
    pair.send({T.OUTPUT_SSRC: 200, T.DOPPLER_FREQUENCY: 0.0, T.DOPPLER_FREQUENCY_RATE: 0.0})
    for r in (rd, pair.j):
        assert 200 not in r.doppler
        assert int(np.asarray(r.params["hf"]["shifts"][0])) == shift0
