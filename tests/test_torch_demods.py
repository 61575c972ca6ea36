"""PyTorch port, the demodulators against the JAX package on the CPU: linear
with the PLL, envelope and stereo paths, NBFM with CTCSS and threshold
extension, WFM stereo and mono fallback, the narrowband spectrum, and the
FFT-IDFT form of the tiled channelizer. Each runs several blocks, and each
block of the port starts from JAX's state after the previous block (both
are carried as numpy), so a decision that flips cannot carry on.

Bounds, and why:
  * audio and float readouts: rtol 2e-5 of the array's peak (linear, FM) -
    the PLL, the discriminator and the Bessel series run the same float32
    sequence in both packages, XLA contracting some multiply-adds;
  * WFM: 2e-5 of the peak after its first block (the first block's
    discriminator reads the master's turn-on transient, where atan2 of
    near-zero samples is ill-conditioned);
  * the PLL's Q32 VCO word within 4,096 LSB (1e-6 rev) after a 240-sample
    block: a 1-ulp difference of a VCO step moves the word by up to 32 LSB,
    and the loop feeds each sample's phase into the next (seen: 728 LSB on
    a weak DSB channel);
  * integer and boolean state exact, where the compared quantities lie more
    than 1e-4 (relative) from their thresholds; the scenes are built so
    that none lies closer, and each test asserts so.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.models import fm as jfm
from ka9q_radio_tpu.models import linear as jlin
from ka9q_radio_tpu.models import spectrum as jspec
from ka9q_radio_tpu.models import wfm as jwfm
from ka9q_radio_tpu.ops import filterbank as jfb
from ka9q_radio_tpu_torch.models import fm as tfm
from ka9q_radio_tpu_torch.models import linear as tlin
from ka9q_radio_tpu_torch.models import spectrum as tspec
from ka9q_radio_tpu_torch.models import wfm as twfm
from ka9q_radio_tpu_torch.ops import agc as tagc
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from test_torch_models import agc_margins, agc_on_edge, assert_agc_held

torch.set_num_threads(2)

EDGE = 1e-4


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _off_edge(x, *thresholds):
    """x lies more than EDGE (relative) from every threshold."""
    x = np.asarray(x, np.float64)
    return all((np.abs(x / np.asarray(t, np.float64) - 1.0) > EDGE).all() for t in thresholds)


def _close(got, want, rtol, what, atol=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin, err_msg=what)
    scale = max(np.abs(want[fin]).max(initial=0.0), 1e-30)
    assert np.abs(got[fin] - want[fin]).max(initial=0.0) <= rtol * scale + atol, what


# ---------------------------------------------------------------- linear

LRATE, LN, LC = 12_000, 240, 16
CARRIERS = np.arange(LC) < 12  # the rest carry noise only


def _linear_params():
    C = LC
    return {
        "agc_enable": np.arange(C) % 3 != 0,
        "headroom": np.full(C, 10 ** (-15 / 20), np.float32),
        "hangtime_samples": np.full(C, int(1.1 * LRATE), np.int32),
        "recovery_per_sample": np.full(C, 10 ** (20 / 20 / LRATE), np.float32),
        "threshold": np.full(C, 10 ** (-15 / 20), np.float32),
        "bandwidth": np.full(C, 5000.0, np.float32),
        "manual_gain": np.full(C, 10 ** (30 / 20), np.float32),
        "shift_inc_q32": np.where(np.arange(C) % 4 == 1, 12_345_678, 0).astype(np.int32),
        "squelch_open": np.full(C, 10 ** 0.8, np.float32),
        "squelch_close": np.full(C, 10 ** 0.7, np.float32),
        "squelch_tail": np.full(C, 1, np.int32),
        "snr_squelch_enable": np.arange(C) % 5 == 2,
        "pll_square": np.arange(C) % 2 == 1,
        "pll_loop_bw": np.full(C, 20.0, np.float32),
        "dc_tau": np.where(np.arange(C) % 3 == 1, 0.01, 0.0).astype(np.float32),
    }


def _linear_block(b: int, rng) -> np.ndarray:
    """Carriers a few Hz off the dial, AM (even channels) or DSB (odd) by
    400 Hz, levels from -60 to -10 dBFS, the last four noise only."""
    C, N = LC, LN
    t = np.arange(b * N, (b + 1) * N) / LRATE
    amp = np.where(np.arange(C) < 12, np.logspace(-3, -0.5, C), 0.0)[:, None]
    mod = np.cos(2 * np.pi * 400 * t)[None, :]
    dsb = np.where((np.arange(C) % 2 == 1)[:, None], mod, 1.0 + 0.5 * mod)
    foff = np.linspace(-15, 15, C)[:, None]
    bb = amp * dsb * np.exp(2j * np.pi * (foff * t + 0.1))
    bb += 3e-4 * (rng.standard_normal((C, N)) + 1j * rng.standard_normal((C, N)))
    return bb.astype(np.complex64)


@pytest.mark.parametrize("flags", [dict(enable_pll=True), dict(envelope=True), dict(stereo=True),
                                   dict(envelope=True, stereo=True)],
                         ids=["pll", "envelope", "stereo", "envelope+stereo"])
def test_linear_demod_paths_match_jax(flags, monkeypatch):
    """Eight blocks. The PLL case starts with some channels locked, and lock
    counts that cross both hysteresis limits inside the run; the AGC is held
    as in test_torch_models (exact off its thresholds, rtol 1e-3 on them)."""
    seen = {}

    def agc_spy(state, bb, bb_power, n0, **kw):
        seen["m"] = agc_margins(state["gain"].numpy(), bb.numpy(), bb_power.numpy(), n0.numpy(),
                                kw["headroom"].numpy(), kw["threshold"].numpy(),
                                kw["bandwidth"].numpy(), kw["blocktime"])
        return tagc.agc_block(state, bb, bb_power, n0, **kw)

    monkeypatch.setattr(tlin, "agc_block", agc_spy)
    p = _linear_params()
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _tensors(p)
    n0 = np.full(LC, 1e-9, np.float32)
    js = jlin.linear_init(LC)
    if flags.get("enable_pll"):
        lock = np.arange(LC) % 4 == 0
        lc = np.where(lock, 6000, np.where(np.arange(LC) % 4 == 1, 5600, -5600)).astype(np.int32)
        js = dict(js, pll_lock=jnp.asarray(lock), pll_lock_count=jnp.asarray(lc))
    step = jax.jit(lambda s, bb, pw, n: jlin.linear_demod(s, bb, pw, n, jp, samprate=LRATE,
                                                          blocktime=0.02, **flags))
    rng = np.random.default_rng(5)
    locks = set()
    for b in range(8):
        bb = _linear_block(b, rng)
        pw = (np.abs(bb) ** 2).mean(-1).astype(np.float32)
        prev = jax.device_get(js)
        js, ja, ji = step(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, ta, ti = tlin.linear_demod(_tensors(prev), torch.from_numpy(bb), torch.from_numpy(pw),
                                       torch.from_numpy(n0), tp, samprate=LRATE, blocktime=0.02,
                                       **flags)
        jsn, ji = jax.device_get(js), jax.device_get(ji)
        snr = ji["snr"]
        fin = np.isfinite(snr)
        assert _off_edge(snr[fin], p["squelch_open"][fin], p["squelch_close"][fin])
        edge = agc_on_edge(seen["m"], p["agc_enable"])
        assert_agc_held(ts.pop("agc"), jsn.pop("agc"), prev["agc"]["hangcount"], edge, seen["m"],
                        p["hangtime_samples"], LN, LRATE, rtol=2e-5)
        _close(ta.numpy()[~edge], np.asarray(ja)[~edge], 2e-5, f"audio {b}")
        # Two detectors are chaotic in both packages, and their loop state
        # and readouts are held on the other channels: on noise alone the
        # atan2 detector crosses its branch cut, where one ulp flips the
        # error by a whole revolution; and the locked DSB detector
        # re*im/(re^2 - im^2) divides two near-zero numbers at each zero
        # crossing of the modulation (seen: 0.04 rev apart after a block)
        held = CARRIERS & ~(p["pll_square"] & prev["pll_lock"])
        tpll, jpll = _np(ts.pop("pll")), jsn.pop("pll")
        dv = (tpll.pop("vco_phase").astype(np.int64) - jpll.pop("vco_phase") + 2**31) % 2**32 - 2**31
        assert np.abs(dv[held]).max() <= 4096, b
        for k in jpll:
            _close(tpll[k][held], jpll[k][held], 2e-5, f"pll/{k} {b}")
        for k in jsn:
            _close(_np(ts[k]), jsn[k], 2e-5, f"state/{k} {b}")
        for k in ji:
            rows = ~edge if k in ("gain", "output_power") else (
                held if k in ("cphase", "foffset", "pll_snr", "pll_wraps") else slice(None))
            _close(_np(ti[k])[rows], ji[k][rows], 2e-6 if k == "cphase" else 2e-5,
                   f"info/{k} {b}")
        assert sorted(ti) == sorted(ji)
        locks |= set(np.nonzero(jsn["pll_lock"] != prev["pll_lock"])[0].tolist())
    if flags.get("enable_pll"):
        assert locks, "no channel crossed a lock limit"
    assert (np.asarray(ji["squelch_state"]) > 0).any()


# ---------------------------------------------------------------- FM

FRATE, FN = 24_000, 480
# the Goertzel is a marginally stable resonator and XLA contracts its
# multiply-add: its state and what is read off it (the tone deviation and
# phase) are held to 1e-3 of their peak (test_torch_iir holds the recurrence
# itself to the float64 one)
GOERTZEL_RTOL = 1e-3
TONE_KEYS = ("tone_deviation", "old_pl_phase")


def _fm_scene(C: int):
    """Per channel: (carrier amplitude, 1 kHz deviation Hz, CTCSS tone Hz
    sent, tone configured)."""
    return [(0.1, 2500.0, 100.0, 100.0),   # right tone: opens after 240 ms
            (0.1, 2500.0, 100.0, 103.5),   # wrong tone: stays tone-muted
            (0.1, 3000.0, 0.0, 0.0),       # no CTCSS configured
            (0.0, 0.0, 0.0, 100.0),        # noise only: squelch closed
            (0.01, 2500.0, 100.0, 100.0),  # weaker, 30 dB SNR
            (0.1, 2500.0, 103.5, 100.0),   # tone 3.5 Hz off
            (0.05, 1500.0, 0.0, 0.0),
            (0.1, 2500.0, 100.0, 0.0)][:C]


def _fm_block(b: int, scene, phase, rng):
    t = np.arange(b * FN, (b + 1) * FN) / FRATE
    rows = []
    for i, (a, dev, tone, _) in enumerate(scene):
        f = dev * np.cos(2 * np.pi * 1000 * t) + 300.0 * np.cos(2 * np.pi * tone * t) * (tone > 0)
        ph = phase[i] + 2 * np.pi * np.cumsum(f) / FRATE
        phase[i] = ph[-1]
        rows.append(a * np.exp(1j * ph))
    bb = np.stack(rows) + 3e-4 * (rng.standard_normal((len(scene), FN))
                                  + 1j * rng.standard_normal((len(scene), FN)))
    return bb.astype(np.complex64)


@pytest.mark.parametrize("ctcss,text", [(True, False), (True, True), (False, True)],
                         ids=["ctcss", "ctcss+threshold_ext", "threshold_ext"])
def test_fm_demod_matches_jax(ctcss, text):
    """16 blocks (320 ms, one CTCSS integration of 240 ms after the squelch
    opens): audio, state and readouts; tone_mute exact, away from the
    tone-deviation threshold of 250 Hz."""
    scene = _fm_scene(8)
    C = len(scene)
    p = {"bandwidth": np.full(C, 16_000.0, np.float32),
         "headroom": np.full(C, 10 ** (-15 / 20), np.float32),
         "squelch_open": np.full(C, 10 ** 0.8, np.float32),
         "squelch_close": np.full(C, 10 ** 0.7, np.float32),
         "squelch_tail": np.full(C, 1, np.int32),
         "snr_squelch_enable": np.arange(C) % 3 == 2,
         "threshold_ext": np.full(C, text) & (np.arange(C) % 2 == 0),
         "deemph_rate": np.where(np.arange(C) % 4 == 3, 0.0,
                                 -np.expm1(-1 / (530.5e-6 * FRATE))).astype(np.float32),
         "deemph_gain": np.full(C, 10 ** (12 / 20), np.float32),
         "tone_freq": np.array([s[3] for s in scene], np.float32)}
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _tensors(p)
    n0 = np.full(C, 1e-11, np.float32)
    js = jfm.fm_init(C)
    np.testing.assert_equal(_np(tfm.fm_init(C, device="cpu")), jax.device_get(js))
    step = jax.jit(lambda s, bb, pw, n: jfm.fm_demod(s, bb, pw, n, jp, samprate=FRATE,
                                                     blocktime=0.02, ctcss=ctcss))
    rng = np.random.default_rng(6)
    phase = np.zeros(C)
    done = 0
    for b in range(16):
        bb = _fm_block(b, scene, phase, rng)
        pw = (np.abs(bb) ** 2).mean(-1).astype(np.float32)
        prev = jax.device_get(js)
        js, ja, ji = step(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, ta, ti = tfm.fm_demod(_tensors(prev), torch.from_numpy(bb), torch.from_numpy(pw),
                                  torch.from_numpy(n0), tp, samprate=FRATE, blocktime=0.02,
                                  ctcss=ctcss)
        jsn, ji = jax.device_get(js), jax.device_get(ji)
        assert _off_edge(ji["fm_snr"], p["squelch_open"], p["squelch_close"])
        if ctcss:
            assert _off_edge(jsn["tone_deviation"][jsn["tone_deviation"] > 0], 250.0)
            done += int((jsn["pl_count"] < prev["pl_count"]).sum())
        _close(ta.numpy(), np.asarray(ja), 2e-5, f"audio {b}")
        tsn = _np(ts)
        tg, jg = tsn.pop("goertzel"), jsn.pop("goertzel")
        for k in jg:
            _close(tg[k], jg[k], GOERTZEL_RTOL, f"goertzel/{k} {b}")
        for k in jsn:
            _close(tsn[k], jsn[k], GOERTZEL_RTOL if k in TONE_KEYS else 2e-5, f"state/{k} {b}")
        assert sorted(ti) == sorted(ji)
        for k in ji:
            _close(_np(ti[k]), ji[k], GOERTZEL_RTOL if k in TONE_KEYS else 2e-5, f"info/{k} {b}")
    send = np.asarray(ji["send"])
    assert send[[0, 1, 2]].all() and not send[3]
    if ctcss:
        assert done >= 4, "no CTCSS interval completed"
        mute = jsn["tone_mute"]
        assert not mute[0] and mute[1] and not mute[2], mute


def test_fm_snr_correct_matches_jax():
    r = np.concatenate([[0.0, 1.0, np.pi / (4 - np.pi), 3.67, 50.0, 100.0, 100.5, 1e4],
                        np.logspace(-1, 2.2, 40)]).astype(np.float32)
    want = np.asarray(jfm.fm_snr_correct(jnp.asarray(r)))
    got = tfm.fm_snr_correct(torch.from_numpy(r)).numpy()
    # torch's and XLA's i0e/i1e differ by a few ulp; ten fixed-point steps
    # carry that to ~3e-5
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------- WFM

def _wfm_composite(b: int, geo, pilot: np.ndarray, phase, rng):
    """Stations at the composite rate: L = 700 Hz, R = 1,100 Hz, and where
    `pilot` says so a 19 kHz pilot with an RDS-like subcarrier at 57 kHz;
    FM at 75 kHz deviation; the last station carries noise only."""
    C = pilot.size
    rate = jwfm.COMPOSITE_SAMPRATE
    t = np.arange(b * geo.Lc, (b + 1) * geo.Lc) / rate
    left, right = np.sin(2 * np.pi * 700 * t), np.sin(2 * np.pi * 1100 * t)
    rows = []
    for i in range(C):
        comp = 0.45 * (left + right) / 2
        if pilot[i]:
            comp = comp + 0.1 * np.sin(2 * np.pi * 19e3 * t) \
                + 0.45 * (left - right) / 2 * np.sin(2 * np.pi * 38e3 * t) \
                + 0.05 * np.cos(2 * np.pi * 1187.5 * t) * np.sin(2 * np.pi * 57e3 * t)
        ph = phase[i] + 2 * np.pi * 75e3 * np.cumsum(comp) / rate
        phase[i] = ph[-1]
        rows.append(0.1 * np.exp(1j * ph) if i < C - 1 else np.zeros_like(ph))
    bb = np.stack(rows) + 1e-4 * (rng.standard_normal((C, geo.Lc))
                                  + 1j * rng.standard_normal((C, geo.Lc)))
    return bb.astype(np.complex64)


@pytest.mark.parametrize("with_pilot", [True, False], ids=["stereo", "mono"])
def test_wfm_demod_matches_jax(with_pilot):
    """Six blocks of two stations and a noise-only slot, with or without the
    pilot (the mono fallback); compared from the second block on, each from
    JAX's state. The slave designs and the geometry are equal."""
    jgeo, tgeo = jwfm.wfm_geometry(0.02), twfm.wfm_geometry(0.02)
    assert dataclasses.astuple(jgeo) == dataclasses.astuple(tgeo)
    jresp, tresp = jwfm.wfm_design(jgeo), twfm.wfm_design(tgeo)
    for k in jresp:
        np.testing.assert_array_equal(tresp[k], jresp[k])
    consts = twfm.wfm_constants(tgeo, tresp, device="cpu")
    C = 3
    pilot = np.array([with_pilot, with_pilot, False])
    p = {"bandwidth": np.full(C, 200_000.0, np.float32),
         "headroom": np.full(C, 10 ** (-15 / 20), np.float32),
         "squelch_open": np.full(C, 10 ** 0.8, np.float32),
         "squelch_close": np.full(C, 10 ** 0.7, np.float32),
         "squelch_tail": np.full(C, 1, np.int32),
         "snr_squelch_enable": np.ones(C, bool),
         "deemph_rate": np.array([-np.expm1(-1 / (75e-6 * 48_000)), 0.0, 0.1], np.float32),
         "deemph_gain": np.ones(C, np.float32),
         "stereo_enable": np.ones(C, bool)}
    jp, tp = {k: jnp.asarray(v) for k, v in p.items()}, _tensors(p)
    n0 = np.full(C, 2e-13, np.float32)
    js = jwfm.wfm_init(C, jgeo)
    np.testing.assert_equal(_np(twfm.wfm_init(C, tgeo, device="cpu")), jax.device_get(js))
    step = jax.jit(lambda s, bb, pw, n: jwfm.wfm_demod(s, bb, pw, n, jp, jgeo, jresp))
    rng = np.random.default_rng(7)
    phase = np.zeros(C)
    for b in range(6):
        bb = _wfm_composite(b, tgeo, pilot, phase, rng)
        pw = (np.abs(bb) ** 2).mean(-1).astype(np.float32)
        prev = jax.device_get(js)
        js, ja, ji = step(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, ta, ti = twfm.wfm_demod(_tensors(prev), torch.from_numpy(bb), torch.from_numpy(pw),
                                    torch.from_numpy(n0), tp, tgeo, consts)
        if b == 0:
            continue
        jsn, ji = jax.device_get(js), jax.device_get(ji)
        assert _off_edge(ji["fm_snr"][:2], p["squelch_open"][:2], p["squelch_close"][:2])
        assert _off_edge(ji["pilot_power"], 1e-6)
        np.testing.assert_array_equal(ti["stereo"].numpy(), ji["stereo"])
        np.testing.assert_array_equal(ji["stereo"][:2], pilot[:2])
        _close(ta.numpy(), np.asarray(ja), 2e-5, f"audio {b}")
        # the frequency offset is the mean of 7,680 discriminator samples,
        # zero here up to rounding, which the two packages sum in another
        # order: held to 1e-3 Hz
        for k in jsn:
            _close(_np(ts[k]), jsn[k], 2e-5, f"state/{k} {b}", atol=1e-3 if k == "foffset" else 0)
        assert sorted(ti) == sorted(ji)
        for k in ji:
            # the RDS derotation divides by the pilot's magnitude: noise
            # only where there is no pilot, so held on pilot stations
            rows = pilot if k == "rds_baseband" else slice(None)
            if k == "rds_baseband" and not with_pilot:
                continue
            _close(_np(ti[k])[rows], ji[k][rows], 2e-5, f"info/{k} {b}",
                   atol=1e-3 if k == "foffset" else 0)
    if with_pilot:
        a = ta.numpy()[0]
        spec = np.abs(np.fft.rfft(a * np.hanning(a.shape[0])[:, None], axis=0))
        f = np.fft.rfftfreq(a.shape[0], 1 / 48_000)
        assert abs(f[np.argmax(spec[:, 0])] - 700) < 60 and abs(f[np.argmax(spec[:, 1])] - 1100) < 60


# ---------------------------------------------------------------- spectrum

def test_spectrum_accumulate_matches_jax():
    """Two frames a block and fft_avg 5: blocks 0-2 run the boxcar warm-up
    (block 2 straddles its end), later blocks the steady closed form."""
    jg = jspec.spectrum_geometry(12_000, 240, 100.0, 64, fft_avg=5)
    tg = tspec.spectrum_geometry(12_000, 240, 100.0, 64, fft_avg=5)
    assert (tg.fft_n, tg.hop, tg.frames_per_block, tg.carry) == (jg.fft_n, jg.hop,
                                                                  jg.frames_per_block, jg.carry)
    assert tg.frames_per_block == 2
    np.testing.assert_array_equal(tg.window, jg.window)
    assert tg.noise_bw == jg.noise_bw
    C = 4
    consts = tspec.spectrum_constants(tg, device="cpu")
    js, ts = jspec.spectrum_init(C, jg), tspec.spectrum_init(C, tg, device="cpu")
    acc = jax.jit(lambda s, x: jspec.spectrum_accumulate(s, x, jg))
    rng = np.random.default_rng(8)
    frames = 0
    for b in range(7):
        t = np.arange(b * 240, (b + 1) * 240) / 12_000
        bb = (np.array([0.5, 0.05, 0.0, 0.2])[:, None]
              * np.exp(2j * np.pi * np.array([300.0, -1250.0, 0.0, 50.0])[:, None] * t)
              + 1e-3 * (rng.standard_normal((C, 240)) + 1j * rng.standard_normal((C, 240))))
        bb = bb.astype(np.complex64)
        js, jp = acc(js, jnp.asarray(bb))
        ts, tp = tspec.spectrum_accumulate(ts, torch.from_numpy(bb), tg, consts, frames)
        frames += tg.frames_per_block
        _close(tp.numpy(), np.asarray(jp), 1e-5, f"bins {b}")
        assert int(ts["frames"]) == int(js["frames"]) == frames
        _close(ts["carry"].numpy(), np.asarray(js["carry"]), 0.0, "carry")
    # lowest frequency first, centred on the channel: the 300 Hz tone of
    # channel 0 lands 3 bins above the centre
    assert int(np.argmax(tp.numpy()[0])) == 32 + 3


# ---------------------------------------------------------------- FFT-IDFT

@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_fft_idft_channelize_matches_jax(real):
    """The FFT-IDFT tiled channelizer (E = None: fold S -> n, rotate, one
    batched IFFT) against JAX's, and against the port's own [S, olen] IDFT
    product, at 3e-5 of the output's peak (the kernel's bound)."""
    from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response

    rng = np.random.default_rng(9 + real)
    N, n, olen = 25_600, 300, 240
    m_bins = N // 2 + 1 if real else N
    C = 12
    shifts = (rng.integers(-N // 2 + 400, N // 2 - 400, C) if not real
              else rng.integers(-m_bins + 200, m_bins - 200, C)).astype(np.int32)
    shifts[:2] = [5, -5]  # slices through DC
    resp = np.stack([design_bandpass_response(n, olen, -0.3, 0.3 - 0.01 * i, 11.0,
                                              real_master=real, master_points=N)
                     for i in range(C)]).astype(np.complex64)
    rt, tl, sl = tfb.build_tile_params(resp, shifts, real, N)
    S = rt.shape[-1]
    assert S - n <= n
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    want = np.asarray(jfb.tiled_channelize(jnp.asarray(F), jnp.asarray(rt), jnp.asarray(tl),
                                           jnp.asarray(sl), jnp.asarray(shifts), None, n, olen,
                                           real, N))
    args = [torch.from_numpy(a) for a in (F, rt, tl, sl, shifts)]
    got = tfb.tiled_channelize(*args, None, n, olen, real, N).numpy()
    scale = np.abs(want).max()
    assert got.dtype == np.complex64 and np.abs(got - want).max() <= 3e-5 * scale
    E = torch.from_numpy(tfb.tiled_idft_matrix(n, olen, S))
    dense = tfb.tiled_channelize(*args, E, n, olen, real, N).numpy()
    assert np.abs(got - dense).max() <= 3e-5 * scale
