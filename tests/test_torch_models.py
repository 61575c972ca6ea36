"""PyTorch port, ops/agc.py, models/linear.py and the wide part of
models/spectrum.py against the JAX package on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.models import linear as jlin
from ka9q_radio_tpu.models import spectrum as jspec
from ka9q_radio_tpu.ops import agc as jagc
from ka9q_radio_tpu_torch.models import linear as tlin
from ka9q_radio_tpu_torch.models import spectrum as tspec
from ka9q_radio_tpu_torch.ops import agc as tagc
from ka9q_radio_tpu_torch.ops import windows as twin

torch.set_num_threads(2)

RATE, BLOCKTIME, OLEN = 8_000, 0.02, 160


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _assert_tree_close(got, want, rtol, atol=0.0):
    got, want = _to_np(got), _to_np(jax.device_get(want))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], rtol, atol)
        elif want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _demod_params(C: int, rng) -> dict:
    """Per-channel linear params over every AGC and squelch branch."""
    return {
        "agc_enable": np.arange(C) % 5 != 0,
        "headroom": np.full(C, 10 ** (-15 / 20), np.float32),
        "hangtime_samples": np.full(C, int(1.1 * RATE), np.int32),
        "recovery_per_sample": np.full(C, 10 ** (20 / 20 / RATE), np.float32),
        "threshold": np.full(C, 10 ** (-15 / 20), np.float32),
        "bandwidth": rng.uniform(2000, 3000, C).astype(np.float32),
        "manual_gain": np.full(C, 10 ** (50 / 20), np.float32),
        "shift_inc_q32": np.where(np.arange(C) % 3 == 0, 12_345_678, 0).astype(np.int32),
        "squelch_open": np.full(C, 10 ** 0.8, np.float32),
        "squelch_close": np.full(C, 10 ** 0.7, np.float32),
        "squelch_tail": np.full(C, 1, np.int32),
        "snr_squelch_enable": np.arange(C) % 4 != 1,
        "pll_square": np.zeros(C, bool),
        "pll_loop_bw": np.full(C, 10.0, np.float32),
        "dc_tau": np.zeros(C, np.float32),
    }


def _blocks(C: int, nblocks: int, seed: int):
    """Baseband blocks whose levels span silence to overload, with bursts."""
    rng = np.random.default_rng(seed)
    amp = np.logspace(-6, 0.5, C)[:, None]
    out = []
    for b in range(nblocks):
        x = amp * (rng.standard_normal((C, OLEN)) + 1j * rng.standard_normal((C, OLEN)))
        if b == 2:
            x[::7, 40:60] *= 100.0  # 2 ms peaks
        out.append(x.astype(np.complex64))
    n0 = (amp[:, 0] ** 2 / 4000.0).astype(np.float32)
    return out, n0


def test_agc_block_matches_jax():
    C = 64
    rng = np.random.default_rng(0)
    p = _demod_params(C, rng)
    blocks, n0 = _blocks(C, 4, 1)
    js, ts = jagc.agc_init(C, 20.0), tagc.agc_init(C, 20.0, device="cpu")
    kw = dict(headroom=p["headroom"], hangtime_samples=p["hangtime_samples"],
              recovery_per_sample=p["recovery_per_sample"], threshold=p["threshold"],
              bandwidth=p["bandwidth"])
    jagc_block = jax.jit(lambda s, bb, pw, n: jagc.agc_block(
        s, bb, pw, n, enable=jnp.asarray(p["agc_enable"]), samprate=RATE, blocktime=BLOCKTIME,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    for bb in blocks:
        pw = (bb.real ** 2 + bb.imag ** 2).mean(-1).astype(np.float32)
        js, jr = jagc_block(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, tr = tagc.agc_block(ts, torch.from_numpy(bb), torch.from_numpy(pw),
                                torch.from_numpy(n0), enable=torch.from_numpy(p["agc_enable"]),
                                samprate=RATE, blocktime=BLOCKTIME,
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
        _assert_tree_close(ts, js, rtol=2e-5)
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=2e-5)


def test_linear_demod_matches_jax():
    """Five blocks of carried state: audio, state and readouts."""
    C = 64
    rng = np.random.default_rng(2)
    p = _demod_params(C, rng)
    blocks, n0 = _blocks(C, 5, 3)
    js, ts = jlin.linear_init(C), tlin.linear_init(C, device="cpu")
    _assert_tree_close(ts, js, rtol=0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    step = jax.jit(lambda s, bb, pw, n: jlin.linear_demod(s, bb, pw, n, jp, samprate=RATE,
                                                          blocktime=BLOCKTIME))
    for bb in blocks:
        pw = (bb.real ** 2 + bb.imag ** 2).mean(-1).astype(np.float32)
        js, ja, ji = step(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, ta, ti = tlin.linear_demod(ts, torch.from_numpy(bb), torch.from_numpy(pw),
                                       torch.from_numpy(n0), tp, samprate=RATE,
                                       blocktime=BLOCKTIME)
        ja = np.asarray(ja)
        _assert_tree_close(ts, js, rtol=2e-5)
        assert np.abs(ta.numpy() - ja).max() <= 5e-5 * max(np.abs(ja).max(), 1e-30)
        _assert_tree_close(ti, ji, rtol=2e-5)
    assert (np.asarray(ji["squelch_state"]) > 0).any() and (np.asarray(ji["squelch_state"]) == 0).any()


@pytest.mark.parametrize("flag", ["enable_pll", "envelope", "stereo"])
def test_linear_later_slice_flags_raise(flag):
    C = 2
    with pytest.raises(NotImplementedError, match="later slice"):
        tlin.linear_demod(tlin.linear_init(C, device="cpu"),
                          torch.zeros((C, OLEN), dtype=torch.complex64),
                          torch.zeros(C), torch.zeros(C), {}, samprate=RATE,
                          blocktime=BLOCKTIME, **{flag: True})


@pytest.mark.parametrize("kind,param", [("kaiser", 7.0), ("hann", None), ("blackman_harris", None),
                                        ("gaussian", 0.4), ("hp5ft", None)])
def test_windows_equal(kind, param):
    from ka9q_radio_tpu.ops import windows as jwin

    np.testing.assert_array_equal(twin.make_window(kind, 513, param),
                                  jwin.make_window(kind, 513, param))
    w = twin.make_window(kind, 513, param)
    assert twin.window_noise_bandwidth(w) == jwin.window_noise_bandwidth(w)


@pytest.mark.parametrize("real", [True, False])
def test_wide_spectrum_matches_jax(real):
    """The first block runs the warm-up loop (a boxcar over its first 10 of
    40 frames, then the EMA), later blocks the steady closed form; then the
    per-channel slices."""
    fs, L = 2_048_000.0, 40_960
    jg = jspec.wide_geometry(fs, L, real, 2_000.0, fft_avg=10)
    tg = tspec.wide_geometry(fs, L, real, 2_000.0, fft_avg=10)
    assert jg.mxu is None, "small geometry keeps JAX on its FFT, not the matmul cascade"
    assert (tg.fft_n, tg.hop, tg.frames_per_block, tg.carry, tg.bins) == (
        jg.fft_n, jg.hop, jg.frames_per_block, jg.carry, jg.bins)
    np.testing.assert_array_equal(tg.window, jg.window)
    assert tg.noise_bw == jg.noise_bw
    rng = np.random.default_rng(4)
    js, ts = jspec.wide_init(jg), tspec.wide_init(tg, device="cpu")
    consts = tspec.wide_constants(tg, device="cpu")
    frames = 0
    shifts = np.array([-20_000, -3, 0, 7, 12_345, 25_599, 25_600], np.int32)
    acc = jax.jit(lambda s, b: jspec.wide_accumulate(s, b, jg))
    for _ in range(3):
        x = rng.standard_normal(L).astype(np.float32)
        if not real:
            x = (x + 1j * rng.standard_normal(L)).astype(np.complex64)
        js, jp = acc(js, jnp.asarray(x))
        ts, tp = tspec.wide_accumulate(ts, torch.from_numpy(x), tg, consts, frames)
        frames += tg.frames_per_block
        jp = np.array(jp)
        np.testing.assert_allclose(tp.numpy(), jp, rtol=2e-4, atol=1e-6 * jp.max())
        assert int(ts["frames"]) == int(js["frames"]) == frames
        np.testing.assert_array_equal(ts["carry"].numpy(), np.asarray(js["carry"]))
        jb = np.asarray(jspec.wide_extract(jnp.asarray(jp), jnp.asarray(shifts), 51_200, jg, 32))
        tb = tspec.wide_extract(torch.from_numpy(jp), torch.from_numpy(shifts), 51_200, tg, 32)
        np.testing.assert_array_equal(tb.numpy(), jb)
