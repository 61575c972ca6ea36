"""The radio's calibration on the port's plain path, against the JAX package
on the CPU, at each JAX test's own size:

- the filter bank (tests/test_filterbank.py:112, :122): a carrier 3 kHz
  beyond a Kaiser beta 11 passband's edge comes out at least 60 dB down,
  and unit-variance white noise through a 10 kHz passband of a real master
  comes out at 2 B/fs within 5%; the port's basebands within 3e-5 of their
  peak of JAX's (the channelizer parity bound, tests/test_torch_filterbank.py);
- the engine (tests/test_engine.py:125, :143, :160): reported N0 within 1 dB
  of the scene's density, SNR within 0.75 dB of analytic and the carrier's
  baseband power within 0.1 dB, and 2,000 FM channels stepping to [2000,
  160] finite audio, eagerly and through the emulated graph body (bit for
  bit against the eager step). The port's outputs are held to JAX's block
  by block at the parity tests' bounds (tests/torch_parity.py
  assert_outputs_close: info leaves within 2e-4 of their largest value,
  audio within 5e-4 of its peak, flags and counters exact), each block
  from the JAX engine's state.

The scenes are made with numpy from a seed (carrier plus complex Gaussian
noise of the JAX test's density), the same blocks into both packages: the
two packages' sig_gen noise streams are different draws."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.ops import filterbank as jfb
from ka9q_radio_tpu.ops.filter_design import design_bandpass_response as j_design
from ka9q_radio_tpu.ops.filter_design import response_to_device_order as j_order
from ka9q_radio_tpu.ops.osc import rev_to_q32 as j_q32
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response as t_design
from ka9q_radio_tpu_torch.ops.filter_design import response_to_device_order as t_order
from ka9q_radio_tpu_torch.ops.osc import rev_to_q32 as t_q32
from ka9q_radio_tpu_torch.runtime.graphs import GraphStep
from torch_parity import assert_same_tree, step_against_jax, tree_np

torch.set_num_threads(2)


# ----------------------------------------------------------- the filter bank
FB_FS, FB_OUT = 240_000, 12_000  # tests/test_filterbank.py's master and output rates
CHAN_TOL = 3e-5  # the channelizer's bound against JAX, of the baseband's peak


def _fb_setup(design, order, fb):
    cfg = fb.MasterConfig.from_rate(FB_FS, 0.02, overlap=5, real=True)
    olen = int(FB_OUT * 0.02)
    n_bins = olen * cfg.N // cfg.L
    resp = design(n_bins, olen, -5000 / FB_OUT, 5000 / FB_OUT, kaiser_beta=11.0,
                  real_master=True, master_points=cfg.N)
    return cfg, olen, order(resp)


def _fb_run(x: np.ndarray, tune: float) -> tuple[np.ndarray, np.ndarray]:
    """Real samples x through the master FFT, channelize and fine tune of
    both packages (tests/test_filterbank.py:_run_carrier's chain): the
    [blocks, olen] basebands (port, JAX)."""
    jcfg, olen, jresp = _fb_setup(j_design, j_order, jfb)
    tcfg, _, tresp = _fb_setup(t_design, t_order, tfb)
    np.testing.assert_array_equal(tresp, jresp)
    assert (tcfg.L, tcfg.N) == (jcfg.L, jcfg.N) == (4800, 6000)
    shift, rem, ok = tfb.compute_tuning(tcfg.N, FB_FS, tune)
    assert ok and (shift, rem, ok) == jfb.compute_tuning(jcfg.N, FB_FS, tune)
    inc, adj = t_q32(-rem / FB_OUT), tfb.block_phase_adjust_q32(shift, tcfg.L, tcfg.N)
    assert inc == j_q32(-rem / FB_OUT)
    i32 = lambda v: np.array([v], np.int32)  # noqa: E731
    js, ts = jfb.master_init(jcfg), tfb.master_init(tcfg)
    jacc, tacc = jnp.asarray(i32(0)), torch.from_numpy(i32(0))
    jargs = (jnp.asarray(jresp)[None, :], jnp.asarray(i32(shift)))
    targs = (torch.from_numpy(tresp)[None, :], torch.from_numpy(i32(shift)))
    jch = jax.jit(lambda F: jfb.channelize(F, *jargs, olen, True, jcfg.N))
    outs_t, outs_j = [], []
    for k in range(x.size // tcfg.L):
        blk = x[k * tcfg.L:(k + 1) * tcfg.L]
        js, jF = jfb.master_fft(jcfg, js, jnp.asarray(blk))
        jbb, jacc = jfb.fine_tune(jch(jF), jacc, jnp.asarray(i32(inc)), jnp.asarray(adj[None]))
        ts, tF = tfb.master_fft(tcfg, ts, torch.from_numpy(blk))
        tbb, tacc = tfb.fine_tune(tfb.channelize(tF, *targs, olen, True, tcfg.N), tacc,
                                  torch.from_numpy(i32(inc)), torch.from_numpy(adj[None]))
        outs_j.append(np.asarray(jbb[0]))
        outs_t.append(tbb[0].numpy())
    return np.stack(outs_t), np.stack(outs_j)


def _cosine(f: float, nblocks: int, phase0: float = 0.3) -> np.ndarray:
    t = np.arange(nblocks * 4800) / FB_FS
    return np.cos(2 * np.pi * f * t + phase0).astype(np.float32)


def test_stopband_matches_jax():
    """A carrier at +8 kHz with the passband at +/-5 kHz of the tune (3 kHz
    beyond the edge) against the in-band carrier: >= 60 dB down on the
    port (tests/test_filterbank.py:112); both basebands within 3e-5 of the
    in-band peak of JAX's."""
    tune = 100_000.0
    zt, zj = _fb_run(_cosine(tune + 8000.0, 8), tune)
    it, ij = _fb_run(_cosine(tune, 8), tune)
    peak = np.abs(ij).max()
    assert np.abs(zt - zj).max() < CHAN_TOL * peak
    assert np.abs(it - ij).max() < CHAN_TOL * peak
    # (the stopband itself is float32 rounding, some 150 dB down: the two
    # packages' dB readings of it are not compared)
    atten = 20 * np.log10(np.abs(zt[2:]).max() / np.abs(it[2:]).mean())
    assert atten < -60.0, atten


def test_white_noise_gain_matches_jax():
    """Unit-variance white real noise (a numpy seed) through the 10 kHz
    passband: mean output power 2 B/fs within 5% on the port (the real
    master's sqrt(2) convention, tests/test_filterbank.py:122), the port's
    within 2e-4 of JAX's, the basebands within 3e-5 of their peak."""
    rng = np.random.default_rng(42)
    nblocks = 40
    x = rng.normal(size=nblocks * 4800).astype(np.float32)
    bt, bj = _fb_run(x, 60_000.0)
    assert np.abs(bt - bj).max() < CHAN_TOL * np.abs(bj).max()
    pt, pj = (float(np.mean(np.abs(b[2:]) ** 2)) for b in (bt, bj))
    assert pt == pytest.approx(2.0 * 10_000.0 / FB_FS, rel=0.05)
    assert pt == pytest.approx(pj, rel=2e-4)


# ----------------------------------------------------------------- the engine
FS = 1_024_000  # tests/test_engine.py's complex master


def _scene(n: int, L: int, n0_db: float, carrier: float = 0.0, amp: float = 0.0,
           seed: int = 0) -> np.ndarray:
    """[n, L] complex blocks: a carrier of amplitude amp at `carrier` Hz
    over complex Gaussian noise of density n0_db dBFS/Hz (sig_gen's
    calibration: variance N0 fs split between I and Q)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * L).reshape(n, L) / FS
    std = np.sqrt(10 ** (n0_db / 10) * FS / 2.0)
    x = amp * np.exp(2j * np.pi * carrier * t)
    x = x + std * (rng.standard_normal((n, L)) + 1j * rng.standard_normal((n, L)))
    return x.astype(np.complex64)


def _iq_groups(rt, freq: float, bw: float, snr_squelch: bool = False):
    return [rt.GroupSpec(name="iq", demod="iq", samprate=16_000, agc=False,
                         snr_squelch=snr_squelch,
                         channels=(rt.ChannelSpec(freq=freq, low=-bw / 2, high=bw / 2,
                                                  gain_db=0.0),))]


def _run_port(te, blocks: np.ndarray) -> dict:
    """The port alone through the blocks, from its own state: the last
    block's outputs."""
    st, p = te.init_state(), te.init_params()
    for x in blocks:
        st, out = te.step(st, p, torch.from_numpy(x))
    return out


def _pair(groups, blocks):
    je = jrt.Engine(samprate=FS, real=False, groups=groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=FS, real=False, groups=groups(trt), device="cpu")
    step_against_jax(je, te, blocks)  # each block within the parity bounds
    return _run_port(te, blocks)["iq"]["info"]


def test_noise_density_calibration_matches_jax():
    """tests/test_engine.py:125: noise alone at -110 dBFS/Hz through a
    +/-6 kHz iq channel at 16 kHz, AGC off, 25 blocks: the port's N0 within
    1 dB of the density."""
    n0_db = -110.0
    blocks = _scene(25, 20_480, n0_db, seed=3)
    info = _pair(lambda rt: _iq_groups(rt, 100_000.0, 12_000.0), blocks)
    got = 10 * np.log10(float(info["n0"][0]))
    assert abs(got - n0_db) < 1.0, got


def test_snr_reporting_matches_jax():
    """tests/test_engine.py:160: a carrier of amplitude 0.01 over -120
    dBFS/Hz in a 12 kHz iq channel with SNR squelch, 30 blocks: the port's
    SNR within 0.75 dB of amp^2 / (N0 B) and its baseband power within 0.1
    dB of the carrier's."""
    amp, n0_db, bw = 0.01, -120.0, 12_000.0
    blocks = _scene(30, 20_480, n0_db, carrier=150_000.0, amp=amp, seed=4)
    info = _pair(lambda rt: _iq_groups(rt, 150_000.0, bw, snr_squelch=True), blocks)
    want = 10 * np.log10(amp**2 / (10 ** (n0_db / 10) * bw))
    bb = 10 * np.log10(float(info["baseband_power"][0]))
    snr = bb - (10 * np.log10(float(info["n0"][0])) + 10 * np.log10(bw))
    assert abs(snr - want) < 0.75, (snr, want)
    assert abs(bb - 20 * np.log10(amp)) < 0.1, bb


CAP_FS = 2_048_000  # tests/test_engine.py:143's master


def _capacity_groups(rt):
    freqs = np.linspace(-0.45 * CAP_FS, 0.45 * CAP_FS, 2000)
    return [rt.GroupSpec(name="scan", demod="fm", samprate=8000,
                         channels=tuple(rt.ChannelSpec(freq=float(f), low=-3000.0, high=3000.0)
                                        for f in freqs))]


def _capacity_blocks(n: int, L: int) -> np.ndarray:
    """A block of zeros (the JAX test's), then blocks with an FM carrier
    1.5 kHz deviated by a 1 kHz tone in every 100th channel over noise."""
    freqs = np.linspace(-0.45 * CAP_FS, 0.45 * CAP_FS, 2000)[::100]
    rng = np.random.default_rng(6)
    out = [np.zeros(L, np.complex64)]
    for b in range(1, n):
        t = np.arange(b * L, (b + 1) * L) / CAP_FS
        x = 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        for f in freqs:
            x += 0.02 * np.exp(1j * (2 * np.pi * f * t + 1.5 * np.sin(2 * np.pi * 1000 * t)))
        out.append(x.astype(np.complex64))
    return np.stack(out)


def test_capacity_2000_channels_matches_jax():
    """tests/test_engine.py:143: 2,000 FM channels (the reference's cap,
    radio.h:343-344) step to [2000, 160] finite audio on the port, eagerly
    and through the emulated graph body (bit for bit), and within the
    parity bounds of the JAX engine."""
    je = jrt.Engine(samprate=CAP_FS, real=False, groups=_capacity_groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=CAP_FS, real=False, groups=_capacity_groups(trt), device="cpu")
    assert te.groups["scan"].C == je.groups["scan"].C == 2000
    blocks = _capacity_blocks(5, te.L)
    step_against_jax(je, te, blocks)
    gs = GraphStep(te, emulate=True)
    p = te.init_params()
    se, sg = te.init_state(), te.init_state()
    for b, x in enumerate(blocks):
        blk = torch.from_numpy(x)
        se, oe = te.step(se, p, blk)
        sg, og = gs(sg, p, blk)
        assert sg["host"] == se["host"], b
        assert_same_tree(tree_np(og), tree_np(oe))
        assert og["scan"]["audio"].shape == (2000, 160)
        assert bool(torch.isfinite(og["scan"]["audio"]).all()), b
    stats = gs.graph_stats()
    assert stats["dispatch"] == "emulated" and stats["replays"] == len(blocks), stats
