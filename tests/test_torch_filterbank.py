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


def _padded(F: np.ndarray) -> torch.Tensor:
    """[B, m_bins] spectra in the engine's layout: rows padded with garbage
    to whole 128-bin tiles (no kernel or plain version may read the pad)."""
    ld = -(-F.shape[-1] // 128) * 128
    out = np.full(F.shape[:-1] + (ld,), np.complex64(1e6 + 1e6j))
    out[..., : F.shape[-1]] = F
    return torch.from_numpy(out)


@pytest.mark.parametrize("real", [True, False])
def test_master_fft_batched_matches_jax(real):
    """Three [3, L] blocks through a [3, M-1] tail: each row as JAX's batched
    master, tails and counter equal, spectra within 1e-5 of their peak."""
    j = jfb.MasterConfig.from_rate(1_024_000, real=real, fft="monolithic")
    t = tfb.MasterConfig.from_rate(1_024_000, real=real)
    rng = np.random.default_rng(4)
    js = {"tail": jnp.zeros((3, t.M - 1), jnp.float32 if real else jnp.complex64),
          "jobnum": jnp.zeros((), jnp.int32)}
    ts = tfb.master_init(t, device="cpu")
    ts["tail"] = ts["tail"].expand(3, -1).clone()
    for _ in range(3):
        x = rng.standard_normal((3, t.L)).astype(np.float32)
        if not real:
            x = (x + 1j * rng.standard_normal((3, t.L))).astype(np.complex64)
        js, Fj = jfb.master_fft(j, js, jnp.asarray(x))
        ts, Ft = tfb.master_fft(t, ts, torch.from_numpy(x))
        Fj = np.asarray(Fj)
        assert Ft.shape == Fj.shape == (3, t.bins)
        assert np.abs(Ft.numpy() - Fj).max() <= 1e-5 * np.abs(Fj).max()
        np.testing.assert_array_equal(ts["tail"].numpy(), np.asarray(js["tail"]))


def _odd_setup(real_master: bool, B: int = 3, C: int = 48, seed: int = 6, n_bins: int = 256,
               olen: int = 200):
    """B spectra of an odd real master (m_bins 32,769) or a complex one of
    whole tiles, C channels over all of them, shifts across the band edges."""
    rng = np.random.default_rng(seed)
    master_N = 65_536
    m_bins = master_N // 2 + 1 if real_master else master_N
    r = j_design(n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0, real_master=real_master,
                 master_points=master_N)
    resp = (r[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))).astype(np.complex64)
    lim = m_bins - 1 if real_master else master_N // 2
    shifts = rng.integers(-lim, lim, C).astype(np.int32)
    shifts[:4] = [0, 5, lim - 3, -lim + 2]  # slices clamped at DC, past Nyquist, wrapped
    inputs = (np.arange(C) % B).astype(np.int32)
    F = (rng.standard_normal((B, m_bins)) + 1j * rng.standard_normal((B, m_bins))).astype(np.complex64)
    return F, resp, shifts, inputs, master_N, olen


@pytest.mark.parametrize("real_master", [True, False])
def test_tiled_channelize_inputs_match_jax(real_master):
    """Kernel A's plain version with per-channel inputs, on the engine's
    padded [B, ld] spectra (odd real rows), against JAX's [B, m_bins] form;
    the wrapper on the CPU is the plain version."""
    F, resp, shifts, inputs, master_N, olen = _odd_setup(real_master)
    n_bins = resp.shape[-1]
    rt, tl, sl = jfb.build_tile_params(resp, shifts, real_master, master_N)
    E = jfb.tiled_idft_matrix(n_bins, olen, rt.shape[-1])
    want = np.asarray(jax.jit(lambda Fv: jfb.tiled_channelize(
        Fv, jnp.asarray(rt), jnp.asarray(tl), jnp.asarray(sl), jnp.asarray(shifts), E, n_bins,
        olen, real_master, master_N, inputs=inputs))(jnp.asarray(F)))
    t = torch.from_numpy
    args = (_padded(F), t(rt), t(tl), t(sl), t(shifts), t(E), n_bins, olen, real_master, master_N)
    got = tfb.tiled_channelize(*args, inputs=t(inputs))
    assert np.max(np.abs(got.numpy() - want)) < 3e-5 * np.abs(want).max()
    assert torch.equal(tcc.cuda_channelize(*args, inputs=t(inputs)), got)
    # each channel equals its input's own single-spectrum result
    for b in range(F.shape[0]):
        rows = inputs == b
        one = tfb.tiled_channelize(t(F[b]), t(rt[rows]), t(tl[rows]), t(sl[rows]),
                                   t(shifts[rows]), t(E), n_bins, olen, real_master, master_N)
        assert torch.equal(one, got[rows])


@pytest.mark.parametrize("isb", [False, True])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("real_master", [True, False])
def test_gather_and_channelize_match_jax(real_master, multi, isb):
    """gather_bins and channelize (finish_channelize, its ISB unpack
    included) on an odd real or a complex master, one spectrum or three
    with per-channel inputs, against JAX: the gather exactly, the baseband
    within 3e-5 of its peak."""
    F, resp, shifts, inputs, master_N, olen = _odd_setup(real_master, n_bins=300, olen=240)
    jin, tin = (inputs, torch.from_numpy(inputs)) if multi else (None, None)
    Fj = F if multi else F[0]
    Ft = _padded(F) if multi else torch.from_numpy(F[0])
    n_bins = resp.shape[-1]
    jg = np.asarray(jfb.gather_bins(jnp.asarray(Fj), jnp.asarray(shifts), n_bins, real_master,
                                    master_N, inputs=jin))
    tg = tfb.gather_bins(Ft, torch.from_numpy(shifts), n_bins, real_master, master_N, inputs=tin)
    np.testing.assert_array_equal(tg.numpy(), jg)
    want = np.asarray(jax.jit(lambda Fv: jfb.channelize(
        Fv, jnp.asarray(resp), jnp.asarray(shifts), olen, real_master, master_N, isb=isb,
        inputs=jin))(jnp.asarray(Fj)))
    got = tfb.channelize(Ft, torch.from_numpy(resp), torch.from_numpy(shifts), olen, real_master,
                         master_N, isb=isb, inputs=tin)
    assert got.shape == want.shape == (len(shifts), olen)
    assert np.max(np.abs(got.numpy() - want)) < 3e-5 * np.abs(want).max()
    fd = (jg * resp).astype(np.complex64)
    np.testing.assert_allclose(
        tfb.finish_channelize(torch.from_numpy(fd), olen, isb).numpy(),
        np.asarray(jfb.finish_channelize(jnp.asarray(fd), olen, isb)),
        rtol=0, atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("fs", [2_400_000, 192_000])
def test_odd_master_engine_matches_jax(fs):
    """Engines on complex masters that are not whole 128-bin tiles (an
    RTL-SDR's 2.4 Msps, N 60,000; a Funcube's 192 ksps, N 4,800): every
    group on the per-element channelizer and per-element noise windows,
    eight blocks against the JAX engine, each from JAX's state (audio
    within 5e-4 of its peak, status within 2e-4, flags exact)."""
    from torch_parity import step_against_jax
    from torch_scenes import odd_master_block, odd_master_groups

    import ka9q_radio_tpu.runtime as jrt
    import ka9q_radio_tpu_torch.runtime as trt

    je = jrt.Engine(samprate=fs, real=False, groups=odd_master_groups(jrt, fs), fft="monolithic")
    te = trt.Engine(samprate=fs, real=False, groups=odd_master_groups(trt, fs), device="cpu")
    assert te.master.N % 128 and not any(g.tiled for g in te.groups.values())
    rng = np.random.default_rng(fs % 1000 + 7)
    blocks = [odd_master_block(b, te.L, fs, rng) for b in range(8)]
    to, _ = step_against_jax(je, te, blocks)
    if fs == 2_400_000:  # the FM channel's tone, the USB channel's
        a = to["nbfm"]["audio"][1].numpy()
        f = np.fft.rfftfreq(a.size, 1 / 24_000)[np.argmax(np.abs(np.fft.rfft(a * np.hanning(a.size))))]
        assert abs(f - 1000.0) < 60.0
        a = to["usb"]["audio"][0].numpy()
        f = np.fft.rfftfreq(a.size, 1 / 12_000)[np.argmax(np.abs(np.fft.rfft(a * np.hanning(a.size))))]
        assert abs(f - 700.0) < 60.0
