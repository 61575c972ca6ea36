"""PyTorch port, ops/iir.py and the PLL of ops/osc.py against the JAX package
on the CPU: the log-depth first-order scan (real and complex, with an
initial condition and per-sample coefficients), the exponential smoother,
the Goertzel recurrence carried over several blocks, and the PLL's loop
constants and sample step.

The port's scan combines pairs in another tree than jax.lax.associative_scan,
so sums round differently: the scans are held to 2e-6 of the output's peak
(float32 with T = 512, about 20 ulp). The Goertzel runs the same sequential
recurrence in both packages, but XLA contracts its multiply-add into an FMA
and the two-pole resonator carries every rounding on: over 2,400 samples
each package is held to 2e-4 of the state's peak from the float64
recurrence, and the two to 4e-4 of each other; coeff and cf are float32 on
both sides and equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.ops import iir as jiir
from ka9q_radio_tpu.ops import osc as josc
from ka9q_radio_tpu_torch.ops import iir as tiir
from ka9q_radio_tpu_torch.ops import osc as tosc

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("dtype", [np.float32, np.complex64], ids=["real", "complex"])
@pytest.mark.parametrize("T", [1, 7, 512])
def test_first_order_scan_matches_jax(dtype, T):
    rng = np.random.default_rng(T)
    C = 6
    c = rng.uniform(0.5, 0.999, (C, T)).astype(np.float32)
    d = rng.standard_normal((C, T)).astype(np.float32)
    y0 = rng.standard_normal(C).astype(np.float32)
    if dtype is np.complex64:
        c = c.astype(np.complex64)
        d = (d + 1j * rng.standard_normal((C, T))).astype(np.complex64)
        y0 = (y0 + 1j * rng.standard_normal(C)).astype(np.complex64)
    want = np.asarray(jiir.first_order_scan(jnp.asarray(c), jnp.asarray(d), jnp.asarray(y0)))
    got = _np(tiir.first_order_scan(torch.from_numpy(c), torch.from_numpy(d), torch.from_numpy(y0)))
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()
    # and the recurrence itself, in float64
    y, ref = y0.astype(np.complex128), np.empty((C, T), np.complex128)
    for t in range(T):
        y = c[:, t] * y + d[:, t]
        ref[:, t] = y
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


def test_scan_along_first_axis_and_scalar_c():
    """axis=0 and a scalar coefficient, as ema_smooth uses it."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((300, 4)).astype(np.float32)
    y0 = rng.standard_normal(4).astype(np.float32)
    want = np.asarray(jiir.ema_smooth(jnp.asarray(x), 0.05, jnp.asarray(y0), axis=0))
    got = _np(tiir.ema_smooth(torch.from_numpy(x), 0.05, torch.from_numpy(y0), axis=0))
    assert np.abs(got - want).max() <= 2e-6 * np.abs(want).max()


def test_goertzel_over_blocks_matches_jax():
    """Five 480-sample blocks of a 100 Hz tone at 24 kHz (and off-frequency
    channels) carried block to block, then the output. (A 0 Hz bin, a
    double pole at z = 1, drifts quadratically; the engine reads no such bin.)"""
    rate, T = 24_000, 480
    tones = np.array([100.0, 100.0, 103.5, 250.3], np.float32)
    sig_f = np.array([100.0, 250.0, 100.0, 250.3])
    jc, jcf = jiir.goertzel_coeff(jnp.asarray(tones / rate))
    tc, tcf = tiir.goertzel_coeff(torch.from_numpy(tones) / rate)
    np.testing.assert_array_equal(_np(tc), np.asarray(jc))
    np.testing.assert_array_equal(_np(tcf), np.asarray(jcf))
    js, ts = jiir.goertzel_init((4,)), tiir.goertzel_init((4,))
    step = jax.jit(jiir.goertzel_update_block)
    rng = np.random.default_rng(2)
    s0 = s1 = np.zeros(4)
    k64 = np.asarray(jc, np.float64)
    for b in range(5):
        t = np.arange(b * T, (b + 1) * T) / rate
        x = (0.1 * np.cos(2 * np.pi * sig_f[:, None] * t + 0.3)
             + 0.01 * rng.standard_normal((4, T))).astype(np.float32)
        js = step(js, jnp.asarray(x), jc)
        ts = tiir.goertzel_update_block(ts, torch.from_numpy(x), tc)
        for n in range(T):
            s0, s1 = x[:, n] + k64 * s0 - s1, s0
        for k, ref in (("s0", s0), ("s1", s1)):
            w, scale = np.asarray(js[k]), np.abs(ref).max()
            assert np.abs(_np(ts[k]) - ref).max() <= 2e-4 * scale, (b, k)
            assert np.abs(w - ref).max() <= 2e-4 * scale, (b, k)
            assert np.abs(_np(ts[k]) - w).max() <= 4e-4 * scale, (b, k)
    jo = np.asarray(jiir.goertzel_output(js, jc, jcf))
    to = _np(tiir.goertzel_output(ts, tc, tcf))
    assert np.abs(to - jo).max() <= 4e-4 * np.abs(jo).max()
    # the on-frequency channel reads N/2 of its amplitude
    assert abs(abs(to[0]) / (5 * T) - 0.05) < 0.002


def test_pll_params_match_jax():
    bw = np.array([0.0, 1e-4, 10.0 / 12_000, -0.01, 0.05], np.float32)
    jk1, jk2 = josc.pll_params(jnp.asarray(bw))
    tk1, tk2 = tosc.pll_params(torch.from_numpy(bw))
    np.testing.assert_allclose(_np(tk1), np.asarray(jk1), rtol=1e-6)
    np.testing.assert_allclose(_np(tk2), np.asarray(jk2), rtol=1e-6)


def test_pll_step_matches_jax():
    """200 steps of phase errors that push the loop into both VCO limits and
    past +-1 rev of accumulated phase (the integrator freeze, the wraps and
    the Q32 word's int32 wrap): exact words and counters, u and phi to
    rounding."""
    C = 8
    rng = np.random.default_rng(3)
    k1, k2 = (np.full(C, v, np.float32) for v in (0.3, 0.05))
    js, ts = josc.pll_init((C,)), tosc.pll_init((C,))
    ts["vco_phase"] = torch.full((C,), 2**31 - 1000, dtype=torch.int32)
    js["vco_phase"] = jnp.full((C,), 2**31 - 1000, jnp.int32)
    step = josc.pll_step  # eager: XLA fusion would contract u + k1*pe into an FMA
    bias = np.linspace(-0.6, 0.6, C).astype(np.float32)
    for _ in range(200):
        pe = (bias + 0.05 * rng.standard_normal(C)).astype(np.float32)
        # each step starts from JAX's state: u and phi feed back
        ts = {k: torch.from_numpy(np.array(v)) for k, v in jax.device_get(js).items()}
        js, ju = step(js, jnp.asarray(pe), jnp.asarray(k1), jnp.asarray(k2))
        ts, tu = tosc.pll_step(ts, torch.from_numpy(pe), torch.from_numpy(k1),
                               torch.from_numpy(k2))
        jsn = jax.device_get(js)
        for k in ("vco_phase", "wraps"):
            np.testing.assert_array_equal(_np(ts[k]), jsn[k], err_msg=k)
        for k in ("u", "phi"):
            np.testing.assert_allclose(_np(ts[k]), jsn[k], rtol=1e-6, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(_np(tu), np.asarray(ju), rtol=1e-6, atol=1e-7)
    assert (np.asarray(js["wraps"]) != 0).any()
