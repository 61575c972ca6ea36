"""The shipped example deployments, the port's daemon against the JAX daemon
on the CPU: examples/radiod@siggen.conf, @aviation, @hf-generic, @spectrum
and @fm, each with the scene that chip_smoke.py's `examples` phase holds the
card to (its scene functions, made with numpy from a seed): siggen on its
own sig_gen, the spectrum survey on a sig_gen carrier over known noise, and
aviation (an AM carrier that stops halfway), hf-generic (USB tones, an NBFM
tone and carriers on every 10m-FM channel) and fm (a stereo station with
RDS, a mono one, carriers on the other two) from a capture file in the
example's own format, which both daemons read through their FileSource.
Every channel, group and option of the example stays as shipped; only its
RTP front end is replaced.

Both daemons run 8-12 blocks, the port's eager and through the emulated
graph dispatch, and are held to each other as tests/torch_parity.py's
DaemonPair holds them: channel tables, free slots, host mirrors and params
equal, s16 audio within 1 LSB, status field by field (dB fields as linear
powers); the survey's byte levels within one step, equal where the two
daemons' float bins are equal, and those bins within 2e-4 of the largest.
fm as tests/test_torch_radiod.py holds a WFM daemon: its first two blocks
left out (the discriminator's turn-on, atan2 of near-zero samples, reaches
the second through the composite's overlap), the port continuing from the
JAX daemon's state, and the RDS companions of the stations without a pilot
left out (their derotation divides by a pilot of noise). Each test runs
under its own time limit of TIME_LIMIT_S."""
import signal
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ka9q_radio_tpu_torch.config import load_config
from ka9q_radio_tpu_torch.net.rtp import RtpHeader
from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status
from ka9q_radio_tpu_torch.runtime import state_from_jax
from ka9q_radio_tpu_torch.runtime.source import siggen_block, siggen_init
from torch_parity import DaemonPair, assert_same_wire

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402  (the examples phase's scenes)

torch.set_num_threads(2)

TIME_LIMIT_S = 30
BLOCKS = {"siggen": 10, "aviation": 12, "hf-generic": 8, "spectrum": 10, "fm": 10}


@pytest.fixture(autouse=True)
def time_limit():
    """The test body under a SIGALRM of TIME_LIMIT_S."""
    def over(signum, frame):
        raise TimeoutError(f"over this test's {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, over)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    yield
    signal.setitimer(signal.ITIMER_REAL, 0)
    signal.signal(signal.SIGALRM, old)


def sig_gen_scene(text: str):
    """The config's sig_gen as the port makes it on the CPU, as numpy
    blocks for both daemons (the two packages draw different noise)."""
    src = load_config(text).source
    state = [siggen_init(src, device="cpu")]

    def scene(b, L, rng):
        state[0], x = siggen_block(src, state[0], L)
        return x.numpy()

    return scene


def pair_for(name: str, dispatch: str, monkeypatch, tmp_path) -> DaemonPair:
    text, _ = cs.example_config(name, tmp_path, BLOCKS[name])
    scene = sig_gen_scene(text) if name in ("siggen", "spectrum") else None
    return DaemonPair(text, dispatch, monkeypatch, scene)


def float_bins(rd, ssrc: int) -> np.ndarray:
    """A survey channel's last bins as the float format sends them, lowest
    first (BIN_DATA goes out in FFT order)."""
    saved = rd.spectrum_byte
    rd.spectrum_byte = False
    try:
        b = np.asarray(decode_status(rd.encode_channel_status(rd.chans[ssrc]))[1][T.BIN_DATA],
                       np.float32)
    finally:
        rd.spectrum_byte = saved
    return np.roll(b, b.size // 2)


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
@pytest.mark.parametrize("name", ["siggen", "aviation", "hf-generic"])
def test_example_matches_jax(name, dispatch, monkeypatch, tmp_path):
    pair = pair_for(name, dispatch, monkeypatch, tmp_path)
    pair.check(BLOCKS[name])
    assert any(k == "data" for k, _ in pair.t._sent), name
    if name == "aviation":
        # prealloc = amsq: the same spare slots in the tower's class as JAX's
        assert len(pair.t.free_slots["tower"]) == len(pair.j.free_slots["tower"]) >= 8


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_fm_example_matches_jax(dispatch, monkeypatch, tmp_path):
    pair = pair_for("fm", dispatch, monkeypatch, tmp_path)
    pair.step(2)
    for rd in (pair.j, pair.t):
        rd._sent.clear()
    pair.t.state = state_from_jax(jax.device_get(pair.j.state), device="cpu")
    pair.step(BLOCKS["fm"] - 2)
    pair.assert_same_state()
    rds = {c.ssrc: c.group for c in pair.t.chans.values() if c.rds}
    assert sorted(rds.values()) == ["classical", "jazz", "news", "npr"]  # rds = yes
    noisy = {s for s, g in rds.items() if g != "jazz"}  # no pilot in the scene

    def kept(sent):
        return [(k, p) for k, p in sent if k != "data" or RtpHeader.unpack(p)[0].ssrc not in noisy]

    assert_same_wire(kept(pair.j._sent), kept(pair.t._sent), pair.t.registry)
    heard = {RtpHeader.unpack(p)[0].ssrc for k, p in kept(pair.t._sent) if k == "data"}
    assert {c.ssrc for c in pair.t.chans.values() if not c.rds} | set(rds) - noisy <= heard


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
def test_spectrum_example_matches_jax(dispatch, monkeypatch, tmp_path):
    n = BLOCKS["spectrum"]
    pair = pair_for("spectrum", dispatch, monkeypatch, tmp_path)
    survey = sorted(s for s, c in pair.t.chans.items() if c.group == "survey")
    assert len(survey) == len([c for c in pair.j.chans.values() if c.group == "survey"])
    for s in survey:  # a bare poll arms the lazy survey
        pair.send({T.OUTPUT_SSRC: s})
    pair.step(n - 1)
    for s in survey:
        pair.send({T.OUTPUT_SSRC: s})
    pair.check(1, skip=(T.BIN_BYTE_DATA,))
    stat = [(pj, pt) for (k, pj), (_, pt) in zip(pair.j._sent, pair.t._sent) if k == "status"]
    swept = set()
    for pj, pt in stat:
        fj, ft = decode_status(pj)[1], decode_status(pt)[1]
        assert (T.BIN_BYTE_DATA in fj) == (T.BIN_BYTE_DATA in ft)
        if T.BIN_BYTE_DATA in fj:
            lj, lt = (np.frombuffer(f[T.BIN_BYTE_DATA], np.uint8).astype(int) for f in (fj, ft))
            assert lt.shape == lj.shape and np.abs(lt - lj).max() <= 1
            swept.add(ft[T.OUTPUT_SSRC])
    assert swept == set(survey)
    for s in survey:  # the last sweep: levels equal where the float bins are
        bj, bt = float_bins(pair.j, s), float_bins(pair.t, s)
        assert np.abs(bt - bj).max() <= 2e-4 * np.abs(bj).max()
        lv = [np.frombuffer(decode_status(rd.encode_channel_status(rd.chans[s]))[1]
                            [T.BIN_BYTE_DATA], np.uint8) for rd in (pair.j, pair.t)]
        np.testing.assert_array_equal(lv[1][bt == bj], lv[0][bt == bj])
