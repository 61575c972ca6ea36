"""PyTorch port, dual-antenna beamforming (the Fobos independent-I/Q mode,
filter.c:723-742) and the daemon on complex masters that are not whole
128-bin tiles, against the JAX package on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.config import load_config as jload
from ka9q_radio_tpu.ops import filterbank as jfb
from ka9q_radio_tpu.ops.filter_design import design_bandpass_response
from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
from ka9q_radio_tpu_torch.config import load_config as tload
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from ka9q_radio_tpu_torch.runtime.radiod import Radiod as TRadiod
from test_beam import make_signal
from test_torch_radiod import assert_same_sent
from torch_parity import assert_same_tree, step_against_jax, tree_np

torch.set_num_threads(2)

FS = 1_024_000


@pytest.mark.parametrize("multi", [False, True])
def test_channelize_beam_matches_jax(multi):
    """The beamforming channelizer on one spectrum and on three with
    per-channel inputs (the engine's padded rows), slices over DC and the
    master Nyquist, random complex weights: within 3e-5 of the peak."""
    rng = np.random.default_rng(21)
    N, n, olen, C, B = 16_384, 256, 200, 24, 3
    F = (rng.standard_normal((B, N)) + 1j * rng.standard_normal((B, N))).astype(np.complex64)
    r = design_bandpass_response(n, olen, -5e3 / 16e3, 5e3 / 16e3, 11.0, real_master=False,
                                 master_points=N)
    resp = np.broadcast_to(r, (C, n)).astype(np.complex64)
    shifts = rng.integers(-N // 2, N // 2, C).astype(np.int32)
    shifts[:4] = [0, 3, N // 2 - 5, -N // 2 + 1]
    alpha = (rng.standard_normal(C) + 1j * rng.standard_normal(C)).astype(np.complex64)
    beta = (rng.standard_normal(C) + 1j * rng.standard_normal(C)).astype(np.complex64)
    inputs = (np.arange(C) % B).astype(np.int32)
    want = np.asarray(jax.jit(lambda Fv: jfb.channelize_beam(
        Fv, jnp.asarray(resp), jnp.asarray(shifts), olen, N, jnp.asarray(alpha),
        jnp.asarray(beta), inputs=inputs if multi else None))(jnp.asarray(F if multi else F[0])))
    t = torch.from_numpy
    Ft = t(np.pad(F, ((0, 0), (0, 128)))) if multi else t(F[0])
    got = tfb.channelize_beam(Ft, t(resp), t(shifts), olen, N, t(alpha), t(beta),
                              inputs=t(inputs) if multi else None)
    assert got.shape == want.shape == (C, olen)
    assert np.max(np.abs(got.numpy() - want)) < 3e-5 * np.abs(want).max()


def _beam_groups(rt, a, b):
    return [rt.GroupSpec(name="beam", demod="iq", samprate=16_000, agc=False, beam=True,
                         a_weight=a, b_weight=b, channels=(
                             rt.ChannelSpec(freq=100_000.0, low=-6000.0, high=6000.0, gain_db=0.0),
                             rt.ChannelSpec(freq=110_000.0, low=-6000.0, high=6000.0, gain_db=0.0)))]


@pytest.mark.parametrize("a,b,want", [(0.5 + 0j, 0.5 + 0j, 0), (0.5 + 0j, -0.5 + 0j, 1)])
def test_beam_antenna_selection(a, b, want):
    """tests/test_beam.py's scene (antenna A on I at 100 kHz, B on Q at
    110 kHz) through both engines, each block from JAX's state: the port's
    outputs are JAX's, and the selected antenna's channel is more than
    40 dB above the nulled one's."""
    je = jrt.Engine(samprate=FS, real=False, groups=_beam_groups(jrt, a, b), fft="monolithic")
    te = trt.Engine(samprate=FS, real=False, groups=_beam_groups(trt, a, b), device="cpu")
    g = te.groups["beam"]
    assert not g.tiled
    np.testing.assert_array_equal(g.params["beam_alpha"].numpy(), np.full(2, a, np.complex64))
    sig = make_signal(10, te.L)
    to, _ = step_against_jax(je, te, [sig[k * te.L:(k + 1) * te.L] for k in range(10)])
    p = to["beam"]["info"]["baseband_power"].numpy()
    assert p[want] > 1e-5 and p[want] / max(p[1 - want], 1e-30) > 1e4


def test_beam_needs_complex_master():
    for rt, kw in ((jrt, {"fft": "monolithic"}), (trt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="beamforming needs a complex master"):
            rt.Engine(samprate=FS, real=True, groups=_beam_groups(rt, 1.0, 0.0), **kw)


BEAM_CONF = """
[global]
hardware =
mode = iq
[beamch]
mode = iq
samprate = 16k
beam = yes
a-amp = 0.5
a-phase = 0
b-amp = 0.5
b-phase = 180
freq = 100k0 110k0
"""


def test_beam_config_builds_jax_params():
    """A beam section (a-amp/a-phase/b-amp/b-phase) builds the JAX engine's
    params in the port, the weights included."""
    jc, tc = jload(BEAM_CONF), tload(BEAM_CONF)
    je = jrt.Engine(samprate=FS, real=False, groups=jc.groups, fft="monolithic")
    te = trt.Engine(samprate=FS, real=False, groups=tc.groups, device="cpu")
    assert te.groups["beamch"].spec.beam
    assert abs(complex(te.groups["beamch"].params["beam_beta"][0]) + 0.5) < 1e-6
    assert_same_tree(tree_np(te.init_params()), jax.device_get(je.init_params()))


ODD_CONF = {
    # an RTL-SDR's 2.4 Msps (N 60,000): NBFM and USB, SSRCs by frequency
    2_400_000: """
[global]
hardware = rtl
mode = usb
update = 4
[rtl]
device = sig_gen
samprate = 2m4
real = no
[nfm]
mode = nfm
freq = 300k
[usb]
mode = usb
samprate = 12k
freq = 600k
""",
    # a Funcube Pro+'s 192 ksps (N 4,800): USB and a beamforming I/Q pair
    192_000: """
[global]
hardware = fcd
mode = usb
update = 4
[fcd]
device = sig_gen
samprate = 192k
real = no
[usb]
mode = usb
samprate = 12k
freq = 30k 60k
[beam]
mode = iq
samprate = 12k
beam = yes
a-amp = 0.5
b-amp = 0.5
b-phase = 180
freq = 41k
""",
}


def _odd_rate_block(b: int, L: int, fs: int, rng) -> np.ndarray:
    """At 2.4 Msps 1 kHz FM (2.5 kHz deviation) at 300 kHz and a tone 700 Hz
    above 600 kHz; at 192 ksps a tone 700 Hz above 30 kHz and two real
    antennas on I (a tone 1 kHz above 41 kHz) and Q (1.5 kHz above); over
    noise."""
    t = np.arange(b * L, (b + 1) * L) / fs
    x = 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    if fs == 2_400_000:
        x += 0.1 * np.exp(1j * (2 * np.pi * 300e3 * t + 2.5 * np.sin(2 * np.pi * 1000 * t)))
        x += 0.05 * np.exp(2j * np.pi * (600e3 + 700) * t)
    else:
        x += 0.05 * np.exp(2j * np.pi * (30e3 + 700) * t)
        x += 0.05 * np.cos(2 * np.pi * (41e3 + 1000) * t) + 0.05j * np.cos(2 * np.pi * (41e3 + 1500) * t)
    return x.astype(np.complex64)


@pytest.mark.parametrize("fs", [2_400_000, 192_000])
def test_odd_rate_daemon_matches_jax(fs):
    """radiod on complex masters that are not whole 128-bin tiles (with a
    beamforming section at 192 ksps): the same numpy blocks into both
    daemons give the same RTP (1 LSB) and status; the tones are where they
    belong."""
    from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader, decode_samples

    jr, tr = JRadiod(jload(ODD_CONF[fs]), use_network=False), \
        TRadiod(tload(ODD_CONF[fs]), use_network=False, device="cpu")
    assert not any(g.tiled for g in tr.engine.groups.values())
    rng = np.random.default_rng(fs % 1000 + 41)
    for b in range(10):
        x = _odd_rate_block(b, tr.engine.L, fs, rng)
        jr.step_block(block=x)
        tr.step_block(block=x)
    assert_same_sent(jr._sent, tr._sent)
    ssrc = 600 if fs == 2_400_000 else 30
    data = [p for k, p in tr._sent if k == "data" and RtpHeader.unpack(p)[0].ssrc == ssrc]
    audio = np.concatenate([decode_samples(RtpHeader.unpack(p)[1], Encoding.S16BE)
                            for p in data[4:]])
    f = np.fft.rfftfreq(audio.size, 1 / 12_000)
    assert abs(f[np.argmax(np.abs(np.fft.rfft(audio * np.hanning(audio.size))))] - 700.0) < 30.0


def test_cli_runs_beam_at_192k(tmp_path, capsys):
    """radiod-torch --device cpu starts the 192 ksps config with its beam
    section, which earlier slices refused."""
    from ka9q_radio_tpu_torch.cli.radiod import main

    path = tmp_path / "radiod.conf"
    path.write_text(ODD_CONF[192_000])
    assert main(["--device", "cpu", "--no-network", "--flat-out", "--blocks", "3",
                 "-v", str(path)]) == 0
    err = capsys.readouterr().err
    assert "3 channels ready on cpu" in err and "3 blocks" in err
