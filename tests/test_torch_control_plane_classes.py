"""The port's daemon held to the JAX daemon on the control plane's restart
classes (radio_status.c:167-209, 452-542): the twins of
tests/test_control_plane.py's PRESET, DEMOD_TYPE, OUTPUT_SAMPRATE, ISB,
PLL/envelope, OUTPUT_CHANNELS and FILTER2 tests, which move a channel to
another compiled class (a table rebuild in both daemons, a new GraphStep in
the port's). As tests/test_torch_control_plane.py: each twin on its
config and scene, eager and through the emulated graph dispatch, held to
the JAX daemon on state and on the wire."""
import numpy as np
import torch

from ka9q_radio_tpu_torch.runtime.radiod import DEMOD_TYPE_CODES
from ka9q_radio_tpu_torch.net.status import StatusType as T
from test_torch_control_plane import host_val, last_status, pair  # noqa: F401 (the fixture)

torch.set_num_threads(2)


def test_preset_switch_existing_channel(pair):
    """Live mode switch on an existing channel (radio_status.c:167-209)."""
    rd = pair.t
    ch = pair.cmd(200, PRESET="pm")
    assert rd.engine.groups[ch.group].spec.demod == "fm"
    assert ch.samprate == 24_000
    assert ch.preset == "pm"
    st = last_status(rd, 200)
    assert st[T.DEMOD_TYPE] == DEMOD_TYPE_CODES["fm"]
    assert st[T.PRESET] == "pm"
    pair.step(2)
    # and back, with runtime audio still flowing
    ch = pair.cmd(200, PRESET="usb")
    assert rd.engine.groups[ch.group].spec.demod == "linear"
    pair.step()
    assert np.isfinite(np.asarray(rd.chans[200].last_info["baseband_power"])).all()
    pair.check(4)


def test_demod_type_switch(pair):
    rd = pair.t
    ch = pair.cmd(300, DEMOD_TYPE=DEMOD_TYPE_CODES["linear"])
    assert rd.engine.groups[ch.group].spec.demod == "linear"
    pair.step(2)
    ch = pair.cmd(300, DEMOD_TYPE=DEMOD_TYPE_CODES["fm"])
    assert rd.engine.groups[ch.group].spec.demod == "fm"
    pair.check(4)


def test_output_samprate(pair):
    rd = pair.t
    ch = pair.cmd(200, OUTPUT_SAMPRATE=24_000)
    assert ch.samprate == 24_000
    assert rd.engine.groups[ch.group].spec.samprate == 24_000
    assert last_status(rd, 200)[T.OUTPUT_SAMPRATE] == 24_000
    # non-commensurate rates round to a legal one (modes.c:525-542), as JAX's
    for r in (1, 11_997, 13_000, 44_100, 47_999):
        assert rd.round_samprate(r) == pair.j.round_samprate(r), r
    assert rd.round_samprate(11_997) % rd.round_samprate(1) == 0
    pair.check(5)


def test_isb_forces_stereo_and_filter2(pair):
    rd = pair.t
    ch = pair.cmd(200, INDEPENDENT_SIDEBAND=True)
    spec = rd.engine.groups[ch.group].spec
    assert spec.isb and spec.stereo and spec.filter2 >= 1
    assert ch.channels == 2
    assert bool(last_status(rd, 200)[T.INDEPENDENT_SIDEBAND])
    pair.check(5)


def test_pll_and_envelope_toggles(pair):
    rd = pair.t
    ch = pair.cmd(200, PLL_ENABLE=True, PLL_BW=25.0, PLL_SQUARE=True)
    spec = rd.engine.groups[ch.group].spec
    assert spec.enable_pll
    np.testing.assert_allclose(host_val(rd, ch, "pll_loop_bw"), 25.0)
    assert bool(host_val(rd, ch, "pll_square"))
    pair.step(2)
    ch = pair.cmd(200, ENVELOPE=True)
    assert rd.engine.groups[ch.group].spec.envelope
    pair.check(4)


def test_output_channels_linear_and_wfm(pair):
    rd = pair.t
    ch = pair.cmd(200, OUTPUT_CHANNELS=2)
    assert rd.engine.groups[ch.group].spec.stereo
    assert ch.channels == 2
    pair.step(2)
    ch = pair.cmd(200, OUTPUT_CHANNELS=1)
    assert not rd.engine.groups[ch.group].spec.stereo
    pair.check(4)


def test_filter2_blocking(pair):
    rd = pair.t
    ch = pair.cmd(200, FILTER2=2)
    assert rd.engine.groups[ch.group].spec.filter2 == 2
    pair.check(5)


def test_combined_demod_switch_applies_linear_keys(pair):
    """DEMOD_TYPE=linear + PLL_ENABLE in ONE packet both apply."""
    rd = pair.t
    ch = pair.cmd(300, DEMOD_TYPE=DEMOD_TYPE_CODES["linear"], PLL_ENABLE=True)
    spec = rd.engine.groups[ch.group].spec
    assert spec.demod == "linear" and spec.enable_pll
    pair.check(5)


def test_pll_after_isb_hands_the_kernel_whole_rows(pair, monkeypatch):
    """ISB, then the PLL on the same channel (the control-plane script's
    order): a class with filter2, whose second stage leaves the block as a
    column slice. The PLL kernel's wrapper refuses a strided block on the
    card (its CPU path takes any), so the demodulator must hand it whole
    rows. The channel is tuned to the carrier, which the PLL acquires; the
    daemons' state and audio stay JAX's. Their status is not compared: the
    acquiring loop behind a second FFT stage turns the packages' rounding
    into 3.4e-5 rad of PLL_PHASE in five blocks (ROADMAP Queue 3's feedback
    trap; test_pll_and_envelope_toggles holds the PLL's fields without
    filter2)."""
    import ka9q_radio_tpu_torch.models.linear as linear
    from torch_parity import assert_same_wire

    seen = []
    scan = linear.cuda_pll_scan

    def whole_rows(bb, *args):
        seen.append(bb.is_contiguous())
        return scan(bb, *args)

    monkeypatch.setattr(linear, "cuda_pll_scan", whole_rows)
    rd = pair.t
    pair.cmd(200, INDEPENDENT_SIDEBAND=True, RADIO_FREQUENCY=201_000.0)
    pair.step()
    ch = pair.cmd(200, PLL_ENABLE=True, PLL_BW=25.0)
    spec = rd.engine.groups[ch.group].spec
    assert spec.isb and spec.enable_pll and spec.filter2 >= 1
    pair.step(4)
    assert seen and all(seen), seen
    pair.assert_same_state()
    data = [[(k, p) for k, p in r._sent if k == "data"] for r in (pair.j, rd)]
    assert_same_wire(*data, rd.registry)
