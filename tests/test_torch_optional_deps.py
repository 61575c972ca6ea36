"""The port's optional-dependency surface held to the JAX package's: the
twins of tests/test_optional_deps.py. scipy backs monitor's PL notch, libopus
the Opus encoding (refused on the command, the channel working on, where it
is missing), a system player the monitor's --device output. The daemon
twins run eager and through the emulated graph dispatch."""
import os
import stat
import sys

import numpy as np
import pytest
import torch

from ka9q_radio_tpu_torch.net.rtp import Encoding
from ka9q_radio_tpu_torch.net.status import StatusType as T
from test_optional_deps import CONF
from torch_parity import FS, DaemonPair

torch.set_num_threads(2)

DISPATCH = ["eager", "graph"]


def scene(b: int, L: int, rng) -> np.ndarray:
    """A tone 1 kHz above the [usb] section's dial, over -60 dBFS noise."""
    t = np.arange(b * L, (b + 1) * L) / FS
    x = 0.1 * np.exp(2j * np.pi * 101_000 * t)
    x += 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def test_notch_available_reflects_scipy(monkeypatch):
    from ka9q_radio_tpu.cli import monitor as jmonitor
    from ka9q_radio_tpu_torch.cli import monitor

    assert monitor.notch_available() and jmonitor.notch_available()  # scipy is in this image
    monkeypatch.setitem(sys.modules, "scipy.signal", None)
    monkeypatch.setitem(sys.modules, "scipy", None)
    assert not monitor.notch_available() and not jmonitor.notch_available()


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_opus_encoding_rejected_without_libopus(dispatch, monkeypatch, capsys):
    import ka9q_radio_tpu.native as jnative
    import ka9q_radio_tpu.net.opus as jopus
    import ka9q_radio_tpu_torch.native as native_mod
    import ka9q_radio_tpu_torch.net.opus as opus_mod

    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=81)
    ch = next(iter(pair.t.chans.values()))
    for mod, nat in ((opus_mod, native_mod), (jopus, jnative)):
        monkeypatch.setattr(mod, "available", lambda: False)
        monkeypatch.setattr(nat, "native_has_opus", lambda: False, raising=False)
    pair.send({T.OUTPUT_SSRC: ch.ssrc, T.OUTPUT_ENCODING: int(Encoding.OPUS)})
    assert ch.encoding != Encoding.OPUS  # rejected, channel keeps working
    assert pair.j.chans[ch.ssrc].encoding == ch.encoding
    assert capsys.readouterr().err.count("Opus encoding rejected") == 2  # both daemons said it
    x = scene(pair.t.blocks, pair.t.engine.L, pair.rng)
    pair.j.step_block(block=x)
    out = pair.t.step_block(block=x)
    assert np.all(np.isfinite(np.asarray(out["usb"]["audio"])))
    pair.check(3)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_opus_encoding_accepted_with_libopus(dispatch, monkeypatch):
    from ka9q_radio_tpu_torch.native import native_has_opus
    from ka9q_radio_tpu_torch.net.opus import available

    if not (available() or native_has_opus()):
        pytest.skip("no libopus in this image")
    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=82)
    ch = next(iter(pair.t.chans.values()))
    pair.send({T.OUTPUT_SSRC: ch.ssrc, T.OUTPUT_ENCODING: int(Encoding.OPUS)})
    # 12 kHz is a legal Opus rate, so the encoding flips directly
    assert ch.encoding == Encoding.OPUS == pair.j.chans[ch.ssrc].encoding
    pair.check(4)  # the Opus streams decoded and held to each other


def _stub_player(tmp_path, monkeypatch):
    """An `aplay` on PATH that records its arguments and its stdin."""
    stub = tmp_path / "aplay"
    stub.write_text(f'#!/bin/sh\necho "$@" > {tmp_path}/argv\ncat > {tmp_path}/pcm.raw\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")


def test_monitor_device_output(tmp_path, monkeypatch):
    """--device pipes the mix into a system player: with a stub player on
    PATH the PCM bytes arrive intact, the player run with the JAX package's
    arguments."""
    from ka9q_radio_tpu.cli.monitor import _open_audio_device as jopen
    from ka9q_radio_tpu_torch.cli.monitor import _open_audio_device

    _stub_player(tmp_path, monkeypatch)
    pcm = (np.arange(960, dtype="<i2")).tobytes()
    seen = []
    for open_device in (_open_audio_device, jopen):
        dac = open_device("hw:1,0", 48_000)
        assert dac is not None
        dac.stdin.write(pcm)
        dac.stdin.close()
        dac.wait(timeout=5)
        seen.append(((tmp_path / "argv").read_text(), (tmp_path / "pcm.raw").read_bytes()))
    assert seen[0] == seen[1] and seen[0][1] == pcm
    assert "-D hw:1,0" in seen[0][0] and "-r 48000" in seen[0][0]


def test_monitor_device_absent(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    from ka9q_radio_tpu.cli.monitor import _open_audio_device as jopen
    from ka9q_radio_tpu_torch.cli.monitor import _open_audio_device

    assert _open_audio_device("default", 48_000) is None
    assert jopen("default", 48_000) is None
