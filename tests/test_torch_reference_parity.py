"""The port's radiod against the REAL reference radiod, on the CPU.

tests/golden/ref_*.npz hold RTP audio and TLV status captured from the
reference binary (reference_build/capture_golden.py) running its own sig_gen
front end, or for WFM the file front end on reference_build/wfm_scene.py's
composite. The same config drives the port's Radiod(device="cpu") here,
under the bounds tests/test_reference_parity.py holds the JAX package to:
outputs within 0.1 dB (BASELINE.md), noise statistics with the wider
allowance for independent noise realizations (the port's sig_gen draws its
noise from a torch.Generator). WFM runs through the port's `device = file`
front end (runtime/frontends.py FileSource).
"""
import json
import os
import re
import sys

import numpy as np
import pytest

import torch

from ka9q_radio_tpu_torch.config import load_config
from ka9q_radio_tpu_torch.runtime.radiod import Radiod
from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status
from ka9q_radio_tpu_torch.net.rtp import RtpHeader, Encoding, decode_samples

torch.set_num_threads(2)


def _radiod(conf: str):
    return Radiod(load_config(conf), use_network=False, device="cpu")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BLOCKS = 250  # 5 s at the 20 ms cadence


def _load(name):
    path = os.path.join(GOLDEN, f"ref_{name}.npz")
    if not os.path.exists(path):
        pytest.skip("golden captures absent (run reference_build/capture_golden.py)")
    z = np.load(path)
    status = json.loads(bytes(z["status_json"]).decode())
    conf = bytes(z["conf"]).decode()
    return z, status, conf


def _run_ours(conf):
    rd = _radiod(conf)
    for _ in range(BLOCKS):
        rd.step_block()
    audio: dict[int, np.ndarray] = {}
    for kind, pkt in rd._sent:
        if kind != "data":
            continue
        h, payload = RtpHeader.unpack(pkt)
        audio.setdefault(h.ssrc, []).append(decode_samples(payload, Encoding.S16BE))
    audio = {s: np.concatenate(v) for s, v in audio.items() if v}
    status = {}
    for ssrc, ch in rd.chans.items():
        _, fields, _ = decode_status(rd.encode_channel_status(ch))
        status[ssrc] = fields
    return rd, audio, status


def _tone(audio, fs=12_000):
    a = audio[audio.size // 4:]
    A = np.abs(np.fft.rfft(a * np.hanning(a.size)))
    f = np.fft.rfftfreq(a.size, 1 / fs)
    rms_db = 20 * np.log10(np.sqrt(np.mean(a**2)) + 1e-12)
    return f[np.argmax(A)], rms_db


def test_torch_linear8_parity():
    z, gold, conf = _load("linear8")
    rd, audio, status = _run_ours(conf)

    # channel 50 carries the 1 kHz tone (carrier at dial+1 kHz)
    g50 = gold["50"]
    ours = status[50]
    ref_audio = z["audio_50"].astype(np.float64) / 32768.0
    ref_freq, ref_rms = _tone(ref_audio)
    our_freq, our_rms = _tone(audio[50].astype(np.float64))
    assert abs(ref_freq - 1000.0) < 2 and abs(our_freq - 1000.0) < 2
    # audio level: the BASELINE 0.1 dB bound on the demodulated tone
    assert abs(our_rms - ref_rms) < 0.1, (our_rms, ref_rms)
    # reported baseband power (the -20 dBFS carrier) within 0.1 dB
    assert abs(float(ours[T.BASEBAND_POWER]) - g50["BASEBAND_POWER"]) < 0.1
    # AGC gain settles to the same value (output pinned to headroom)
    assert abs(float(ours[T.GAIN]) - g50["GAIN"]) < 0.15
    assert abs(float(ours[T.OUTPUT_LEVEL]) - g50["OUTPUT_LEVEL"]) < 0.15
    # noise density estimate: independent noise realizations; allow 0.4 dB
    assert abs(float(ours[T.NOISE_DENSITY]) - g50["NOISE_DENSITY"]) < 0.4

    # a noise-only channel: same N0, same railed AGC behavior
    g70 = gold["70"]
    o70 = status[70]
    assert abs(float(o70[T.NOISE_DENSITY]) - g70["NOISE_DENSITY"]) < 0.4
    assert abs(float(o70[T.BASEBAND_POWER]) - g70["BASEBAND_POWER"]) < 1.5
    assert float(o70[T.GAIN]) > 100.0  # gain railed into the noise floor

    # wire format identical: PT maps to 12 kHz mono s16be on both sides
    info = rd.registry.info_from_pt(int(z["pt_50"]))
    assert info == (12_000, 1, Encoding.S16BE)


def _tone_amp_db(a, f0, fs=48_000):
    """Amplitude (dBFS) of the tone at f0: hann-windowed cluster ENERGY
    (±4 bins), which is independent of both segment length and where the
    tone falls between bins (peak-bin readings scallop by up to 1.4 dB)."""
    n = a.size
    w = np.hanning(n)
    X = np.fft.rfft(a * w)
    f = np.fft.rfftfreq(n, 1 / fs)
    k = int(np.argmin(np.abs(f - f0)))
    e = float(np.sum(np.abs(X[k - 4 : k + 5]) ** 2))
    amp = 2.0 * np.sqrt(e / (n * np.sum(w**2)))
    return 20 * np.log10(amp + 1e-15)


def _trim(a, frac=0.15):
    n = int(a.shape[0] * frac)
    return a[n : a.shape[0] - n]


def test_torch_wfm_parity(tmp_path):
    """WFM stereo golden parity: the SAME deterministic composite file
    (reference_build/wfm_scene.py) drives the reference radiod (captured in
    ref_wfm.npz via the file.so plugin) and our radiod (device = file).
    Holds the stereo matrix (wfm.c:237-258), the pilot-gated mono fallback
    + per-block payload-type switch (wfm.c:226-276), and levels to the
    0.1 dB BASELINE bound."""
    z, gold, conf = _load("wfm")
    sys.path.insert(0, os.path.join(os.path.dirname(GOLDEN), "..", "reference_build"))
    import wfm_scene

    path = wfm_scene.write_composite(str(tmp_path / "wfm.cf32"))
    conf = re.sub(r"(?m)^path = .*$", f"path = {path}", conf)

    rd = _radiod(conf)
    assert type(rd.frontend).__name__ == "FileSource"
    assert type(rd.frontend).__module__ == "ka9q_radio_tpu_torch.runtime.frontends"
    for _ in range(400):  # 8 s — spans stereo [0,3) / mono [3,6) / stereo
        rd.step_block()
    runs: list[tuple[int, list]] = []  # contiguous same-PT packet runs
    for kind, pkt in rd._sent:
        if kind != "data":
            continue
        h, payload = RtpHeader.unpack(pkt)
        assert h.ssrc == wfm_scene.SSRC
        if not runs or runs[-1][0] != h.type:
            runs.append((h.type, []))
        runs[-1][1].append(decode_samples(payload, Encoding.S16BE))

    pt_st = rd.registry.pt_from_info(48_000, 2, Encoding.S16BE)
    pt_mo = rd.registry.pt_from_info(48_000, 1, Encoding.S16BE)
    # same static payload-type numbers as the reference's PT_table
    assert (pt_st, pt_mo) == (113, 112)
    # pilot gating drove stereo -> mono -> stereo payload-type switches
    assert [pt for pt, _ in runs] == [pt_st, pt_mo, pt_st], runs

    # decode_samples already normalizes to [-1, 1]; compare the FIRST
    # stereo run and the mono run (junction blocks stay at the run edges
    # where _trim drops them)
    ours_st = np.concatenate(runs[0][1]).astype(np.float64).reshape(-1, 2)
    ours_mo = np.concatenate(runs[1][1]).astype(np.float64)
    # stereo re-entry after the mono gap, ~2 s of it (mirrors ref pt77)
    n_re = sum(x.size for x in runs[2][1])
    assert n_re > 48_000 * 2  # frames*2ch: > 1 s of resumed stereo
    # reference segments: 113 = first stereo, 77 = re-entry stereo (the
    # reference re-allocates from its dynamic pool), 112 = mono
    ref_st = z["audio_100100_pt113"].reshape(-1, 2).astype(np.float64) / 32767.0
    ref_mo = z["audio_100100_pt112"].astype(np.float64) / 32767.0
    assert z["audio_100100_pt77"].size > 0  # stereo resumed after mono

    for chan, f0, f_other in ((0, 700.0, 1100.0), (1, 1100.0, 700.0)):
        ref_a = _tone_amp_db(_trim(ref_st[:, chan]), f0)
        our_a = _tone_amp_db(_trim(ours_st[:, chan]), f0)
        assert abs(ref_a - our_a) < 0.1, (chan, ref_a, our_a)
        # stereo separation: the other channel's tone suppressed > 30 dB
        assert _tone_amp_db(_trim(ours_st[:, chan]), f_other) < our_a - 30
        assert _tone_amp_db(_trim(ref_st[:, chan]), f_other) < ref_a - 30
    # mono fallback: both tones at (L+R)/2 amplitude, level parity
    for f0 in (700.0, 1100.0):
        ref_a = _tone_amp_db(_trim(ref_mo), f0)
        our_a = _tone_amp_db(_trim(ours_mo), f0)
        assert abs(ref_a - our_a) < 0.1, (f0, ref_a, our_a)

    g = gold[str(wfm_scene.SSRC)]
    ch = rd.chans[wfm_scene.SSRC]
    _, fields, _ = decode_status(rd.encode_channel_status(ch))
    assert abs(float(fields[T.BASEBAND_POWER]) - g["BASEBAND_POWER"]) < 0.1
    assert int(fields[T.OUTPUT_SAMPRATE]) == int(g["OUTPUT_SAMPRATE"]) == 48_000
    assert int(fields[T.DEMOD_TYPE]) == int(g["DEMOD_TYPE"]) == 2
    assert abs(float(fields[T.RADIO_FREQUENCY]) - g["RADIO_FREQUENCY"]) < 1e-3


def test_torch_nbfm_parity():
    z, gold, conf = _load("nbfm")
    rd, audio, status = _run_ours(conf)
    g = gold["100"]
    ours = status[100]
    assert abs(float(ours[T.BASEBAND_POWER]) - g["BASEBAND_POWER"]) < 0.1
    assert abs(float(ours[T.NOISE_DENSITY]) - g["NOISE_DENSITY"]) < 0.4
    # unmodulated carrier: enormous SNR on both sides, silent audio
    assert g["FM_SNR"] > 60.0
    assert float(ours[T.FM_SNR]) > 60.0
    ref_audio = z["audio_100"].astype(np.float64) / 32768.0
    _, ref_rms = _tone(ref_audio)
    if 100 in audio:  # squelch may mute entirely on our side
        _, our_rms = _tone(audio[100].astype(np.float64))
        assert our_rms < -50.0
    assert ref_rms < -50.0
    assert int(ours[T.OUTPUT_SAMPRATE]) == int(g["OUTPUT_SAMPRATE"]) == 12_000
    assert int(ours[T.DEMOD_TYPE]) == int(g["DEMOD_TYPE"]) == 1
