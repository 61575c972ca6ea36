"""PyTorch port, ops/noise.py (the N0 kernel's plain version) against the JAX
package and an exact numpy order statistic, on the CPU."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.ops import noise as jnz
from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops import noise as tnz

torch.set_num_threads(2)


def _ladder(real_master: bool, seed: int = 3):
    """The N0 ladder of tests/test_pallas_channelize.py:249-285 (real), and
    its complex-master twin whose windows clamp at the band edges and wrap
    through DC."""
    rng = np.random.default_rng(seed)
    master_N = 262_144
    m_bins = master_N // 2 + 1 if real_master else master_N
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)
         ).astype(np.complex64) * rng.uniform(0.1, 10.0, m_bins)
    C = 256
    if real_master:
        shifts = np.linspace(2_000, 120_000, C).astype(np.int32)
        shifts[10] = -shifts[10]  # an inverted channel (|shift| window)
    else:
        shifts = np.linspace(-131_000, 131_000, C).astype(np.int32)
        shifts[7] = 100  # a window straddling DC
    return F.astype(np.complex64), shifts, master_N, m_bins


def test_constants_equal():
    assert tnz.noise_correction() == jnz.noise_correction()
    assert (tnz.NQ, tnz.N_CUTOFF, tnz.POWER_ALPHA, tnz.MIN_NOISE_BINS) == (
        jnz.NQ, jnz.N_CUTOFF, jnz.POWER_ALPHA, jnz.MIN_NOISE_BINS)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("nbins", [1024, 1000, 128])
def test_keys_equal_numpy_partition(ties, nbins):
    """Statistics i and i+1 from the 31-step bisection and the next-key rule
    equal np.partition of the int32 view, bit for bit; with heavy ties the
    (i+1)-th statistic comes from the tie rule."""
    rng = np.random.default_rng(nbins + ties)
    e = rng.exponential(1e-9, (64, nbins)).astype(np.float32)
    if ties:
        e = np.round(e / 2e-10).astype(np.float32) * np.float32(2e-10)
    i = int(np.floor(tnz.NQ * (nbins - 1)))
    _, keys = tnz.estimate_noise_keys(torch.from_numpy(e), 25_601, 2.048e6)
    want = np.partition(e.view(np.int32), [i, i + 1], axis=-1)[:, [i, i + 1]]
    np.testing.assert_array_equal(keys.numpy(), want)


@pytest.mark.parametrize("real_master", [True, False])
def test_windows_match_jax(real_master):
    """Gathered window energies: JAX's placement, and exactly a*a + b*b
    rounded twice (numpy); jitted JAX may contract that into one fused
    multiply-add, 1 ulp away."""
    F, shifts, master_N, m_bins = _ladder(real_master)
    want = np.asarray(jax.jit(lambda Fv: jnz.gather_noise_bins(
        Fv, jnp.asarray(shifts), 1024, real_master, master_N))(jnp.asarray(F)))
    got = tnz.gather_noise_bins(torch.from_numpy(F), torch.from_numpy(shifts), 1024,
                                real_master, master_N).numpy()
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    energy = F.real * F.real + F.imag * F.imag
    sh = shifts.astype(np.int64)
    if real_master:
        start = np.clip(np.abs(sh) - 512, 0, m_bins - 1024) // 128 * 128
        idx = start[:, None] + np.arange(1024)
    else:
        lo = np.clip(sh - 512, -(m_bins // 2), (m_bins - 1) // 2 - 1023)
        idx = (lo // 128 * 128)[:, None] + np.arange(1024)
    np.testing.assert_array_equal(got, energy[idx % m_bins])


@pytest.mark.parametrize("real_master", [True, False])
def test_n0_matches_jax(real_master):
    F, shifts, master_N, m_bins = _ladder(real_master)
    fs = 1.0e6
    want = np.asarray(jax.jit(lambda Fv: jnz.estimate_noise(
        jnz.gather_noise_bins(Fv, jnp.asarray(shifts), 1024, real_master, master_N),
        m_bins, fs))(jnp.asarray(F)))
    n0, keys = tcc.cuda_noise_est(torch.from_numpy(F), torch.from_numpy(shifts), 1024,
                                  real_master, master_N, fs)
    assert n0.dtype == torch.float32 and keys.dtype == torch.int32 and keys.shape == (256, 2)
    np.testing.assert_allclose(n0.numpy(), want, rtol=2e-5)
    np.testing.assert_allclose(tnz.estimate_noise(
        tnz.gather_noise_bins(torch.from_numpy(F), torch.from_numpy(shifts), 1024,
                              real_master, master_N), m_bins, fs).numpy(), want, rtol=2e-5)



def _window_index(shifts: np.ndarray, nbins: int, real_master: bool, master_N: int):
    """numpy: each channel's window bins, radio.c:1845-1872 as the JAX package
    places them (tile-aligned where the master allows, else per-element)."""
    m_bins = master_N // 2 + 1 if real_master else master_N
    sh = shifts.astype(np.int64)
    if tnz.noise_window_fits(nbins, real_master, master_N):
        W = -(-nbins // 128) * 128
        if real_master:
            start = np.clip(np.abs(sh) - W // 2, 0, m_bins - W) // 128 * 128
        else:
            lo = np.clip(sh - W // 2, -(m_bins // 2), (m_bins - 1) // 2 - (W - 1))
            start = lo // 128 * 128
        return (start[:, None] + np.arange(W)) % m_bins
    k = np.arange(nbins)
    if real_master:
        lo = np.clip(np.abs(sh) - nbins // 2, 0, max(m_bins - nbins, 0))
        return np.clip(lo[:, None] + k, 0, m_bins - 1)
    lo = np.minimum(np.maximum(sh - nbins // 2, -(m_bins // 2)), (m_bins - 1) // 2 - (nbins - 1))
    return np.mod(lo[:, None] + k, m_bins)


# (real master, master N, window bins): per-element windows of an RTL-SDR's
# 2.4 Msps master (60,000 bins), a Funcube's 192 ksps (4,800), a window
# longer than its small complex or real master, and one of 700 bins (not
# whole tiles) on a real master too small for its tile-aligned window
PER_ELEMENT = [(False, 60_000, 1000), (False, 4_800, 1000), (False, 300, 1000),
               (True, 1_800, 1000), (True, 1_200, 700)]


@pytest.mark.parametrize("real_master,master_N,nbins", PER_ELEMENT)
def test_per_element_windows_match_jax(real_master, master_N, nbins):
    """Small or odd masters take per-element windows, nbins long at any
    start (wrapped through DC, or clamped inside a real master): the port's
    energies are JAX's (to the 1-ulp FMA of jitted JAX) and exactly a*a + b*b
    of numpy's placement; the keys equal np.partition of those energies,
    and N0 is JAX's within rtol 2e-5."""
    rng = np.random.default_rng(master_N + nbins)
    m_bins = master_N // 2 + 1 if real_master else master_N
    F = ((rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins))
         * rng.uniform(0.1, 10.0, m_bins)).astype(np.complex64)
    lim = m_bins - 1 if real_master else master_N // 2
    shifts = np.concatenate([np.linspace(-lim, lim, 61), [0, 1, -1, 7]]).astype(np.int32)
    assert not tnz.noise_window_fits(nbins, real_master, master_N)
    want = np.asarray(jax.jit(lambda Fv: jnz.gather_noise_bins(
        Fv, jnp.asarray(shifts), nbins, real_master, master_N))(jnp.asarray(F)))
    got = tnz.gather_noise_bins(torch.from_numpy(F), torch.from_numpy(shifts), nbins,
                                real_master, master_N).numpy()
    assert got.shape == (shifts.size, nbins)
    np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
    np.testing.assert_array_equal(got, (F.real * F.real + F.imag * F.imag)[
        _window_index(shifts, nbins, real_master, master_N)])
    i = int(np.floor(tnz.NQ * (nbins - 1)))
    fs = 2.4e6
    n0, keys = tcc.cuda_noise_est(torch.from_numpy(F), torch.from_numpy(shifts), nbins,
                                  real_master, master_N, fs)
    np.testing.assert_array_equal(
        keys.numpy(), np.partition(got.view(np.int32), [i, i + 1], axis=-1)[:, [i, i + 1]])
    np.testing.assert_allclose(n0.numpy(), np.asarray(jnz.estimate_noise(
        jnp.asarray(want), m_bins, fs)), rtol=2e-5)


@pytest.mark.parametrize("real_master,master_N,nbins", [
    (True, 65_538, 1024), (False, 65_536, 1000), (False, 60_000, 1000), (True, 1_800, 1000)])
def test_windows_with_inputs_match_jax(real_master, master_N, nbins):
    """Windows of channels on three inputs, in either placement (an odd real
    master, tile-aligned; complex whole tiles, tile-aligned; per-element),
    read from the engine's padded [B, ld] spectra: the energies of the
    channel's own input, as JAX's [B, m_bins] form gives them, and N0
    within rtol 2e-5."""
    rng = np.random.default_rng(nbins + 3)
    B, C = 3, 30
    m_bins = master_N // 2 + 1 if real_master else master_N
    F = (rng.standard_normal((B, m_bins)) + 1j * rng.standard_normal((B, m_bins))).astype(np.complex64)
    lim = m_bins - 1 if real_master else master_N // 2
    shifts = rng.integers(-lim, lim, C).astype(np.int32)
    shifts[:3] = [lim - 1, 0, -lim + 1]
    inputs = (np.arange(C) % B).astype(np.int32)
    ld = -(-m_bins // 128) * 128
    Fp = np.full((B, ld), np.complex64(3e3), np.complex64)  # the pad must never be read
    Fp[:, :m_bins] = F
    want = np.asarray(jax.jit(lambda Fv: jnz.gather_noise_bins(
        Fv, jnp.asarray(shifts), nbins, real_master, master_N, inputs=inputs))(jnp.asarray(F)))
    t = torch.from_numpy
    got = tnz.gather_noise_bins(t(Fp), t(shifts), nbins, real_master, master_N, inputs=t(inputs))
    np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0)
    idx = _window_index(shifts, nbins, real_master, master_N)
    np.testing.assert_array_equal(got.numpy(), (F.real * F.real + F.imag * F.imag)[inputs[:, None], idx])
    n0, _ = tcc.cuda_noise_est(t(Fp), t(shifts), nbins, real_master, master_N, 1e6, inputs=t(inputs))
    np.testing.assert_allclose(n0.numpy(), np.asarray(jnz.estimate_noise(
        jnp.asarray(want), m_bins, 1e6)), rtol=2e-5)
