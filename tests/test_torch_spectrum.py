"""The port's spectrum output paths against the JAX package on the CPU:

- net/rice.py: quantize_bins, rice_encode and rice_decode on random level
  vectors from a seed, byte for byte and round trip exact
  (tests/test_spectrum.py:222);
- `spectrum-format = byte` and `= rice` (tests/test_spectrum.py:79, :243):
  both daemons on that config, fed the same numpy blocks, polled on the
  sweep; SPECTRUM_BASE and SPECTRUM_STEP equal, every other status field as
  the daemon parity holds it, decoded levels equal where the two daemons'
  float bins are equal and within one step where they are not (a weak
  bin's rounding follows the master FFT's largest bins, ROADMAP Queue 3),
  and within the port the Rice decode equal to the byte levels of the same
  bins;
- `_fold_frames` (tests/test_spectrum.py:286) alone, and across the warm-up
  through the engine: a spectrum group whose fft_avg spans several blocks,
  dispatched through the emulated graph body (the warm-up blocks run
  eagerly, the rest replay), held to the port's eager step bit for bit and
  to the JAX engine within 2e-4 of the largest bin (the parity tests'
  bound for info leaves, tests/torch_parity.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.models.spectrum import _fold_frames as j_fold
from ka9q_radio_tpu.net import rice as jrice
from ka9q_radio_tpu_torch.models.spectrum import _ema_constants, _fold_frames as t_fold
from ka9q_radio_tpu_torch.net import rice as trice
from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status
from ka9q_radio_tpu_torch.runtime.graphs import GraphStep
from torch_parity import FS, DaemonPair, assert_same_fields, assert_same_tree, tree_np

torch.set_num_threads(2)


# ------------------------------------------------------------ the Rice codec
def _level_vectors(rng, n: int = 60):
    """Level vectors of the shapes a sweep gives: smooth noise floors
    (delta mode wins), spiky bins, flat runs, zeros, long and short; and
    levels quantized from random power bins."""
    out = []
    for i in range(n):
        size = int(rng.integers(1, 600))
        kind = i % 5
        if kind == 0:
            v = np.clip(40 + np.cumsum(rng.integers(-2, 3, size)), 0, None)
        elif kind == 1:
            v = rng.integers(0, 256, size)
        elif kind == 2:
            v = np.full(size, int(rng.integers(0, 300)))
        elif kind == 3:
            v = np.zeros(size, np.int64)
        else:
            p = 10.0 ** rng.uniform(-15, 0, size)
            base, step = float(rng.uniform(-140, -90)), float(rng.choice([0.25, 0.5, 1.0, 2.0]))
            v = jrice.quantize_bins(p, base, step)
            np.testing.assert_array_equal(trice.quantize_bins(p, base, step), v)
            np.testing.assert_array_equal(trice.dequantize_bins(v, base, step),
                                          jrice.dequantize_bins(v, base, step))
        out.append(np.asarray(v, np.int64))
    return out


def test_rice_codec_matches_jax():
    rng = np.random.default_rng(5)
    vectors = _level_vectors(rng)
    assert len(vectors) >= 50
    for i, levels in enumerate(vectors):
        enc = trice.rice_encode(levels)
        assert enc == jrice.rice_encode(levels), i
        np.testing.assert_array_equal(trice.rice_decode(enc, len(levels)), levels)
        np.testing.assert_array_equal(jrice.rice_decode(enc, len(levels)), levels)
    # tests/test_spectrum.py:222's compression claims on the port
    smooth = np.clip(40 + np.cumsum(rng.integers(-2, 3, 512)), 0, None)
    assert len(trice.rice_encode(smooth)) < smooth.size
    assert len(trice.rice_encode(np.full(128, 37))) < 64
    with pytest.raises(ValueError):
        trice.rice_encode(np.array([3, -1]))
    assert trice.rice_encode(np.zeros(0, np.int64)) == jrice.rice_encode(np.zeros(0, np.int64))


# ------------------------------------------- the byte and Rice wire formats
SPECTRUM_CONF = """
[global]
hardware = sig_gen
update = 2
spectrum-format = {fmt}
[sig_gen]
device = sig_gen
carrier = 250k0
amplitude = -6
noise = -120
samprate = 1m024
real = no
[sweep]
mode = spectrum
samprate = 32k
resolution-bw = 2k
bin-count = 64
freq = 240k0
"""
SWEEP_SSRC = 240
AMP = 10 ** (-6 / 20)  # the config's carrier
N0 = 10 ** (-120 / 10)  # and its noise density, power/Hz


def _spectrum_scene(b: int, L: int, rng) -> np.ndarray:
    """The config's sig_gen scene from numpy: a -6 dBFS carrier at 250 kHz
    over complex noise of -120 dBFS/Hz."""
    t = np.arange(b * L, (b + 1) * L) / FS
    std = np.sqrt(N0 * FS / 2.0)
    x = AMP * np.exp(2j * np.pi * 250e3 * t)
    x += std * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def _reencode(rd, fmt: str) -> dict:
    """The sweep's status fields as the daemon would send them in `fmt`
    ("float", "byte" or "rice"), from the same last outputs its own
    beacons were made of."""
    saved = rd.spectrum_byte, rd.spectrum_rice
    rd.spectrum_byte, rd.spectrum_rice = fmt == "byte", fmt == "rice"
    try:
        return decode_status(rd.encode_channel_status(rd.chans[SWEEP_SSRC]))[1]
    finally:
        rd.spectrum_byte, rd.spectrum_rice = saved


def _float_bins(rd) -> np.ndarray:
    """The float format's bins, lowest first (BIN_DATA goes out in FFT
    order)."""
    b = np.asarray(_reencode(rd, "float")[T.BIN_DATA], np.float32)
    return np.roll(b, b.size // 2)


def _levels(f: dict, fmt: str) -> np.ndarray:
    if fmt == "byte":
        assert T.BIN_BYTE_DATA in f and T.BIN_DATA not in f and T.BIN_RICE_DATA not in f
        return np.frombuffer(f[T.BIN_BYTE_DATA], np.uint8).astype(np.int64)
    assert T.BIN_RICE_DATA in f and T.BIN_DATA not in f and T.BIN_BYTE_DATA not in f
    return trice.rice_decode(bytes(f[T.BIN_RICE_DATA]), 64)


@pytest.mark.parametrize("dispatch", ["eager", "graph"])
@pytest.mark.parametrize("fmt", ["byte", "rice"])
def test_spectrum_wire_format_matches_jax(fmt, dispatch, monkeypatch):
    pair = DaemonPair(SPECTRUM_CONF.format(fmt=fmt), dispatch, monkeypatch, _spectrum_scene,
                      seed=11)
    # spectrum groups are poll-gated (spectrum.c:54-77): a bare poll arms it
    pair.send({T.OUTPUT_SSRC: SWEEP_SSRC})
    pair.step(8)
    jstat = [p for k, p in pair.j._sent if k == "status"]
    tstat = [p for k, p in pair.t._sent if k == "status"]
    assert len(tstat) == len(jstat) and tstat
    payload = (T.BIN_BYTE_DATA, T.BIN_RICE_DATA)
    n_bins = 0
    for pj, pt in zip(jstat, tstat):
        assert_same_fields(pj, pt, skip=payload)
        _, fj, _ = decode_status(pj)
        _, ft, _ = decode_status(pt)
        if not any(k in fj for k in payload):
            continue
        n_bins += 1
        assert (ft[T.SPECTRUM_BASE], ft[T.SPECTRUM_STEP]) == \
            (fj[T.SPECTRUM_BASE], fj[T.SPECTRUM_STEP])
        lj, lt = _levels(fj, fmt), _levels(ft, fmt)
        assert lt.shape == lj.shape == (64,)
        assert np.abs(lt - lj).max() <= 1, np.abs(lt - lj).max()
    assert n_bins > 0
    # the last packet: levels equal where the two daemons' float bins are
    # equal; one step apart only where the bins differ
    bj, bt = _float_bins(pair.j), _float_bins(pair.t)
    assert np.abs(bt - bj).max() <= 2e-4 * np.abs(bj).max()
    same = bt == bj
    np.testing.assert_array_equal(lt[same], lj[same])
    # the port's Rice decode is the same daemon's byte reading
    np.testing.assert_array_equal(lt, _levels(_reencode(pair.t, "byte"), "byte"))
    # tests/test_spectrum.py's own assertions on the port's last beacon
    base, step = ft[T.SPECTRUM_BASE], ft[T.SPECTRUM_STEP]
    db = trice.dequantize_bins(lt, base, step)
    assert abs(db[int(np.argmax(db))] - (-6.0)) < 2.5
    if fmt == "rice":
        assert len(bytes(ft[T.BIN_RICE_DATA])) < 64
    if dispatch == "graph":
        st = pair.t.graph_stats()["current"]
        assert st["dispatch"] == "emulated" and st["replays"] > 0, st


# --------------------------------------------- the fold of frames, alone
def test_fold_frames_matches_jax_and_the_scan():
    """tests/test_spectrum.py:286 on the port: nf sequential EMA steps
    (warm-up boxcar weights 1/(n+1), then alpha = 1/fft_avg) against the
    port's _fold_frames from a start inside, across and past the warm-up,
    at the JAX test's rtol 3e-6; and the port against JAX's at the same
    bound."""
    rng = np.random.default_rng(9)
    nf, bins, avg = 7, 33, 10
    consts = _ema_constants(nf, avg, "cpu")

    def reference(power, n0, p):
        pw, n = power.copy(), n0
        for k in range(p.shape[0]):
            a = 1.0 / (n + 1.0) if n < avg else 1.0 / avg
            pw = pw + np.float32(a) * (p[k] - pw)
            n += 1
        return pw

    power = rng.uniform(0.1, 2.0, bins).astype(np.float32)
    for n0 in (0, 4, 8, 10, 25, 1000):  # warm-up, straddling, steady
        p = rng.uniform(0.0, 3.0, (nf, bins)).astype(np.float32)
        got = t_fold(torch.from_numpy(power), n0, torch.from_numpy(p), avg, consts).numpy()
        want, wn = jax.jit(lambda pw, n, pp: j_fold(pw, n, pp, avg))(
            jnp.asarray(power), jnp.int32(n0), jnp.asarray(p))
        assert int(wn) == n0 + nf
        np.testing.assert_allclose(got, reference(power, n0, p), rtol=3e-6, err_msg=f"n0={n0}")
        np.testing.assert_allclose(got, np.asarray(want), rtol=3e-6, err_msg=f"n0={n0}")


# --------------------------------- the fold across the warm-up, in the engine
def _fold_group(rt, bin_bw: float, fft_avg: int = 10):
    """One spectrum channel on the 1.024 Msps complex master: bin_bw 100 Hz
    takes the narrowband algorithm, 2 kHz the wide one (above the 200 Hz
    crossover)."""
    return rt.GroupSpec(name="sp", demod="spectrum", samprate=32_000, bin_bw=bin_bw,
                        bin_count=64, fft_avg=fft_avg,
                        channels=(rt.ChannelSpec(freq=200_000.0),))


@pytest.mark.parametrize("bin_bw", [100.0, 2000.0])
def test_fold_across_the_warm_up_matches_jax(bin_bw):
    """A spectrum group whose fft_avg spans 2.5 blocks' frames, so that the
    warm-up ends inside its third block."""
    probe = trt.Engine(samprate=FS, real=False, groups=[_fold_group(trt, bin_bw)],
                       device="cpu").groups["sp"]
    assert probe.spectrum_wide == (bin_bw >= 200.0)
    nf = (probe.wide_geo if probe.spectrum_wide else probe.spectrum_geo).frames_per_block
    avg = 5 * nf // 2
    je = jrt.Engine(samprate=FS, real=False, groups=[_fold_group(jrt, bin_bw, avg)],
                    fft="monolithic")
    te = trt.Engine(samprate=FS, real=False, groups=[_fold_group(trt, bin_bw, avg)],
                    device="cpu")
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    gs = GraphStep(te, emulate=True)
    se, sg = te.init_state(), te.init_state()
    jstep = jax.jit(je.step)
    rng = np.random.default_rng(21)
    nblocks = 8
    for b in range(nblocks):
        x = _spectrum_scene(b, te.L, rng)
        blk = torch.from_numpy(x)
        js, jo = jstep(js, jp, jnp.asarray(x))
        se, oe = te.step(se, tp, blk)
        sg, og = gs(sg, tp, blk)
        # the graph body against the port's eager step, bit for bit
        assert sg["host"] == se["host"], b
        assert_same_tree(tree_np(og), tree_np(oe))
        assert_same_tree(tree_np({k: v for k, v in sg.items() if k != "host"}),
                         tree_np({k: v for k, v in se.items() if k != "host"}))
        # and against the JAX engine within 2e-4 of the largest bin
        w = np.asarray(jax.device_get(jo["sp"]["info"]["bin_data"]), np.float64)
        g = og["sp"]["info"]["bin_data"].numpy().astype(np.float64)
        assert np.abs(g - w).max() <= 2e-4 * np.abs(w).max(), (b, np.abs(g - w).max())
        assert int(sg["host"]["groups"]["sp"]["frames"]) == (b + 1) * nf
    stats = gs.graph_stats()
    # blocks 0-2 start inside the warm-up (frames 0, nf, 2 nf < 2.5 nf) and
    # run eagerly; every later one replays
    assert stats["eager_blocks"] == {"sp: spectrum warm-up (frame weights 1/(n+1))": 3}, stats
    assert stats["replays"] == nblocks - 3, stats
