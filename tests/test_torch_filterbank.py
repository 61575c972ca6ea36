"""PyTorch port, ops/filterbank.py and the channelizer kernel's plain version,
against the JAX package on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.ops import filterbank as jfb
from ka9q_radio_tpu.ops.filter_design import design_bandpass_response as j_design
from ka9q_radio_tpu.ops.pallas_channelize import _CB, build_ramp, pallas_channelize, plan_runs
from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response as t_design

torch.set_num_threads(2)


def _setup(real_master: bool, C: int = 256, seed: int = 0):
    """The dense shift ladder of tests/test_pallas_channelize.py:_setup."""
    rng = np.random.default_rng(seed)
    master_N = 65_536
    m_bins = master_N // 2 + 1 if real_master else master_N
    n_bins, olen = 256, 200
    resp = np.zeros((C, n_bins), np.complex64)
    for c in range(C):
        r = j_design(n_bins, olen, 50.0 / 12_000.0, 3_000.0 / 12_000.0, 11.0,
                     real_master=real_master, master_points=master_N)
        resp[c] = r * np.exp(1j * rng.uniform(0, 2 * np.pi))
    if real_master:
        shifts = np.linspace(-8000, 20_000, C).astype(np.int32)
    else:
        shifts = np.linspace(2000, 24_000, C).astype(np.int32)
    rt, tl, sl = jfb.build_tile_params(resp, shifts, real_master, master_N)
    S = rt.shape[-1]
    E = jfb.tiled_idft_matrix(n_bins, olen, S)
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    return dict(F=F, resp=resp, rt=rt, tl=tl, sl=sl, shifts=shifts, E=E, S=S,
                n_bins=n_bins, olen=olen, master_N=master_N, m_bins=m_bins)


def _twin(s, real_master):
    t = torch.from_numpy
    return tfb.tiled_channelize(t(s["F"]), t(s["rt"]), t(s["tl"]), t(s["sl"]), t(s["shifts"]),
                                t(s["E"]), s["n_bins"], s["olen"], real_master, s["master_N"])


@pytest.mark.parametrize("samprate", [1_024_000, 2_048_000, 30_720_000, 64_800_000, 129_600_000])
@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("overlap", [5, 3])
def test_master_geometry_equal(samprate, real, overlap):
    j = jfb.MasterConfig.from_rate(samprate, 0.02, overlap, real, fft="monolithic")
    t = tfb.MasterConfig.from_rate(samprate, 0.02, overlap, real)
    assert (t.L, t.M, t.N, t.bins, t.overlap, t.real) == (j.L, j.M, j.N, j.bins, j.overlap, j.real)


@pytest.mark.parametrize("real", [True, False])
def test_master_fft_matches_jax(real):
    """Three blocks through the carried tail: tail and counter equal, the
    spectrum within 1e-5 of its peak (two FFT libraries' rounding)."""
    j = jfb.MasterConfig.from_rate(2_048_000, real=real, fft="monolithic")
    t = tfb.MasterConfig.from_rate(2_048_000, real=real)
    rng = np.random.default_rng(1)
    js, ts = jfb.master_init(j), tfb.master_init(t, device="cpu")
    for _ in range(3):
        x = rng.standard_normal(t.L).astype(np.float32)
        if not real:
            x = (x + 1j * rng.standard_normal(t.L)).astype(np.complex64)
        js, Fj = jfb.master_fft(j, js, jnp.asarray(x))
        ts, Ft = tfb.master_fft(t, ts, torch.from_numpy(x))
        Fj = np.asarray(Fj)
        assert Ft.dtype == torch.complex64 and Ft.shape == Fj.shape
        assert np.abs(Ft.numpy() - Fj).max() <= 1e-5 * np.abs(Fj).max()
        np.testing.assert_array_equal(ts["tail"].numpy(), np.asarray(js["tail"]))
        assert int(ts["jobnum"]) == int(js["jobnum"])


@pytest.mark.parametrize("real_master", [True, False])
def test_tile_params_identical(real_master):
    s = _setup(real_master, C=64)
    rt, tl, sl = tfb.build_tile_params(s["resp"], s["shifts"], real_master, s["master_N"])
    np.testing.assert_array_equal(rt, s["rt"])
    np.testing.assert_array_equal(tl, s["tl"])
    np.testing.assert_array_equal(sl, s["sl"])
    assert tfb.tile_plan(s["n_bins"]) == jfb.tile_plan(s["n_bins"])
    np.testing.assert_array_equal(tfb.tiled_idft_matrix(s["n_bins"], s["olen"], s["S"]), s["E"])
    resp_t = t_design(300, 240, 50 / 12e3, 3e3 / 12e3, 11.0, real_master, 3_240_000)
    np.testing.assert_array_equal(resp_t, j_design(300, 240, 50 / 12e3, 3e3 / 12e3, 11.0,
                                                   real_master, 3_240_000))


@pytest.mark.parametrize("real_master", [True, False])
def test_twin_matches_jax_tiled(real_master):
    s = _setup(real_master)
    want = np.asarray(jax.jit(
        lambda F: jfb.tiled_channelize(F, jnp.asarray(s["rt"]), jnp.asarray(s["tl"]),
                                       jnp.asarray(s["sl"]), jnp.asarray(s["shifts"]), s["E"],
                                       s["n_bins"], s["olen"], real_master, s["master_N"])
    )(jnp.asarray(s["F"])))
    got = _twin(s, real_master).numpy()
    assert np.max(np.abs(got - want)) < 3e-5 * np.abs(want).max()


@pytest.mark.parametrize("real_master", [True, False])
def test_twin_matches_pallas_interpret(real_master):
    """The plain version against the TPU kernel itself, run in interpret mode."""
    s = _setup(real_master)
    T = 128
    ntiles = s["S"] // T
    nrows = -(-s["m_bins"] // T)
    row0, span = plan_runs(s["tl"], ntiles, nrows)
    off = (s["tl"] - np.repeat(row0, _CB)).astype(np.int32)[:, None]
    sgn = np.where(real_master & (s["shifts"] < 0), -1.0, 1.0).astype(np.float32)[:, None]
    olen_pad = -(-s["olen"] // 128) * 128
    Epad = np.zeros((s["S"], olen_pad), np.complex64)
    Epad[:, : s["olen"]] = s["E"]
    rr, ri = build_ramp(s["sl"], s["n_bins"], s["olen"], olen_pad)
    want = np.asarray(pallas_channelize(
        jnp.asarray(s["F"]), jnp.asarray(s["rt"].real.astype(np.float32)),
        jnp.asarray(s["rt"].imag.astype(np.float32)), jnp.asarray(off), jnp.asarray(sgn),
        jnp.asarray(rr), jnp.asarray(ri), jnp.asarray(row0),
        jnp.asarray(Epad.real), jnp.asarray(Epad.imag),
        ntiles=ntiles, span=span, olen=s["olen"], nrows=nrows, interpret=True))
    got = _twin(s, real_master).numpy()
    assert np.max(np.abs(got - want)) < 3e-5 * np.abs(want).max()


@pytest.mark.parametrize("real_master", [True, False])
def test_wrapper_runs_plain_version_on_cpu(real_master):
    """On CPU tensors the kernel's wrapper is its plain version, and counts
    no launch."""
    s = _setup(real_master, C=32)
    t = torch.from_numpy
    before = dict(tcc.launches)
    got = tcc.cuda_channelize(t(s["F"]), t(s["rt"]), t(s["tl"]), t(s["sl"]), t(s["shifts"]),
                              t(s["E"]), s["n_bins"], s["olen"], real_master, s["master_N"])
    assert torch.equal(got, _twin(s, real_master))
    assert tcc.launches == before


def test_tuning_arithmetic_exact():
    rng = np.random.default_rng(2)
    N, L, fs = 3_240_000, 2_592_000, 129_600_000.0
    for f in [0.0, 40.0, -40.0, 1e6 + 0.3, *rng.uniform(-0.5 * fs, 0.5 * fs, 300)]:
        assert tfb.compute_tuning(N, fs, f) == jfb.compute_tuning(N, fs, f)
        sh = jfb.compute_tuning(N, fs, f)[0]
        got, want = tfb.block_phase_adjust_q32(sh, L, N), jfb.block_phase_adjust_q32(sh, L, N)
        assert got.dtype == np.int32 and got == want


def test_fine_tune_matches_jax():
    rng = np.random.default_rng(3)
    C, n = 48, 160
    bb = (rng.standard_normal((C, n)) + 1j * rng.standard_normal((C, n))).astype(np.complex64)
    acc, inc, adj = (rng.integers(-2**31, 2**31, C, dtype=np.int64).astype(np.int32)
                     for _ in range(3))
    jb, jacc = jfb.fine_tune(jnp.asarray(bb), jnp.asarray(acc), jnp.asarray(inc), jnp.asarray(adj))
    t = torch.from_numpy
    tb, tacc = tfb.fine_tune(t(bb), t(acc), t(inc), t(adj))
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5 * np.abs(bb).max())
