"""The arithmetic of the port's two CUDA kernels, emulated in plain PyTorch and
numpy on the CPU, against the JAX package and exact order statistics.

Kernel A (csrc/channelize.cu) folds the tile frame S -> n, because the IDFT
constant is periodic in its row with period n, and runs the product as one
real GEMM of split TF32 parts. Kernel B (csrc/noise_est.cu) bisects from the
window's own key range and counts on keys sorted per lane. Neither kernel
runs here; these tests hold the
design's arithmetic, and tests/test_torch_cuda.py holds the kernels on the
card.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.ops import filterbank as jfb
from ka9q_radio_tpu.ops.filter_design import design_bandpass_response as j_design
from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from ka9q_radio_tpu_torch.ops import noise as tnz

torch.set_num_threads(2)

# (n_bins, olen): rx888's 12 kHz channels (S = 512), a frame more than
# twice the slice (S = 256 > 2n), and an odd n
GEOMETRIES = [(300, 240), (100, 80), (301, 241)]


@pytest.mark.parametrize("n_bins,olen", GEOMETRIES)
def test_idft_rows_periodic(n_bins, olen):
    """Rows j and j + n of the tile-frame IDFT constant are bit-equal."""
    S = tfb.tile_plan(n_bins) * 128
    E = tfb.tiled_idft_matrix(n_bins, olen, S)
    assert S > n_bins
    np.testing.assert_array_equal(E[n_bins:], E[: S - n_bins])


def test_round_tf32_is_rna():
    """Round to nearest, ties away from zero, 13 low bits cleared."""
    bits = np.array([0x3F801000, 0xBF801000, 0x3F800FFF, 0x3F803000, 0x00000000,
                     0x3FFFF000], np.uint32)
    want = np.array([0x3F802000, 0xBF802000, 0x3F800000, 0x3F804000, 0x00000000,
                     0x40000000], np.uint32)
    got = tcc.round_tf32(torch.from_numpy(bits.view(np.float32))).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)


def _unpack_operand(op: torch.Tensor, n_bins: int, olen: int):
    """channelize_operand's chunk order back to [Kp, Np] hi and lo, the
    rows of Re x first (fold bins 0 .. n_pad - 1), then those of Im x."""
    n_pad = tcc.fold_pad(n_bins)
    Kp, Np = 2 * n_pad, 2 * (-(-olen // 32) * 32)
    T = op.reshape(Np // 64, Kp // 32, 4, 2, 2, 4, 2, 8, 4)  # ct ch s half hl grp kh r q
    T = T.permute(1, 2, 6, 8, 0, 3, 5, 7, 4).reshape(Kp, Np, 2)
    # each 32-row chunk holds 16 fold bins' Re rows, then their Im rows
    T = T.reshape(n_pad // 16, 2, 16, Np, 2).transpose(0, 1).reshape(Kp, Np, 2)
    return T[..., 0], T[..., 1]


def emulate_kernel_a(F, rt, tl, sl, shifts, E, n_bins, olen, real_master, master_N,
                     split: bool = True):
    """Kernel A's arithmetic in plain PyTorch: gather x, fold S -> n, the
    real-block GEMM [Xr | Xi] . B in three TF32 products (rna rounding, FP32
    sums), conj, ramp. split=False keeps only the hi * hi product (one TF32
    pass)."""
    T = 128
    C, S = rt.shape
    m_bins = master_N // 2 + 1 if real_master else master_N
    lo = tl.to(torch.int64)[:, None] + torch.arange(S // T)[None, :]
    if real_master:
        rows = torch.nn.functional.pad(F, (0, (-m_bins) % T)).reshape(-1, T)
        lo = lo.clamp(0, rows.shape[0] - 1)
    else:
        rows = F.reshape(-1, T)
        lo = torch.remainder(lo, rows.shape[0])
    x = rows[lo].reshape(C, S) * rt
    xf = torch.zeros((C, n_bins), dtype=torch.complex64)
    for j0 in range(0, S, n_bins):
        xf[:, : min(n_bins, S - j0)] += x[:, j0: j0 + n_bins]
    n_pad = tcc.fold_pad(n_bins)
    X = torch.zeros((C, 2 * n_pad), dtype=torch.float32)
    X[:, :n_bins], X[:, n_pad: n_pad + n_bins] = xf.real, xf.imag
    b_hi, b_lo = _unpack_operand(tcc.channelize_operand(E, n_bins, olen), n_bins, olen)
    a_hi = tcc.round_tf32(X)
    a_lo = tcc.round_tf32(X - a_hi)
    Y = a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi if split else a_hi @ b_hi
    Y = torch.complex(Y[:, 0::2], Y[:, 1::2])[:, :olen]
    if real_master:
        Y = torch.where((shifts < 0)[:, None], Y.conj(), Y)
    t_abs = torch.arange(n_bins - olen, n_bins, dtype=torch.int64)[None, :]
    ph = torch.remainder(sl.to(torch.int64)[:, None] * t_abs, n_bins).to(torch.float32)
    ang = ph * float(np.float32(2.0 * np.pi / n_bins))
    return Y * torch.complex(torch.cos(ang), torch.sin(ang))


def _jax_case(n_bins, olen, real_master):
    """C = 64 channels of one design over a shift ladder, inputs from a
    numpy seed, and JAX's tiled_channelize (the S-term product) of them."""
    rng = np.random.default_rng(n_bins + real_master)
    C, master_N = 64, 262_144
    m_bins = master_N // 2 + 1 if real_master else master_N
    r = j_design(n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0, real_master, master_N)
    resp = (r[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))).astype(np.complex64)
    shifts = (np.linspace(-60_000, 120_000, C) if real_master
              else np.linspace(-130_000, 130_000, C)).astype(np.int32)
    rt, tl, sl = jfb.build_tile_params(resp, shifts, real_master, master_N)
    E = jfb.tiled_idft_matrix(n_bins, olen, rt.shape[-1])
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    want = np.asarray(jax.jit(
        lambda Fv: jfb.tiled_channelize(Fv, jnp.asarray(rt), jnp.asarray(tl), jnp.asarray(sl),
                                        jnp.asarray(shifts), E, n_bins, olen, real_master,
                                        master_N))(jnp.asarray(F)))
    t = torch.from_numpy
    return (t(F), t(rt), t(tl), t(sl), t(shifts), t(E), n_bins, olen, real_master,
            master_N), want


@pytest.mark.parametrize("real_master", [True, False])
@pytest.mark.parametrize("n_bins,olen", GEOMETRIES)
def test_kernel_a_arithmetic_matches_jax(n_bins, olen, real_master):
    """The fold + split-TF32 real-block GEMM against JAX's tiled_channelize
    (the S-term complex product), within 3e-5 * scale, C = 64."""
    args, want = _jax_case(n_bins, olen, real_master)
    got = emulate_kernel_a(*args).numpy()
    assert np.abs(want).max() > 0
    assert np.max(np.abs(got - want)) < 3e-5 * np.abs(want).max()


@pytest.mark.parametrize("real_master", [True, False])
def test_one_tf32_pass_misses_the_bound(real_master):
    """Why the split: one TF32 product keeps 11 significant bits and lands
    outside 3e-5 * scale at the rx888 geometry."""
    args, want = _jax_case(300, 240, real_master)
    got = emulate_kernel_a(*args, split=False).numpy()
    assert np.max(np.abs(got - want)) > 3e-5 * np.abs(want).max()


def test_operand_is_split_real_block():
    """hi + lo of the operand rebuild [[Er, Ei], [-Ei, Er]] of E[:n] to
    about FP32, zero in the padding; hi and lo are TF32 values."""
    n_bins, olen = 300, 240
    E = torch.from_numpy(tfb.tiled_idft_matrix(n_bins, olen, 512))
    hi, lo = _unpack_operand(tcc.channelize_operand(E, n_bins, olen), n_bins, olen)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    B = (hi.double() + lo.double()).reshape(608, 256, 2)
    e = E[:n_bins].to(torch.complex128)
    want = torch.zeros((608, 256, 2), dtype=torch.float64)
    want[:300, :240, 0], want[:300, :240, 1] = e.real, e.imag
    want[304:604, :240, 0], want[304:604, :240, 1] = -e.imag, e.real
    assert float((B - want).abs().max()) <= 2.0 ** -21 * float(e.abs().max())


@pytest.mark.parametrize("n_bins,olen", [(300, 240), (100, 80), (1400, 40)])
def test_x_placement_matches_operand_rows(n_bins, olen):
    """The kernel writes fold bin k's Re x to K row 32 (k // 16) + k % 16 of
    its X tile and Im x 16 rows on (the same rows whichever K segment holds
    them, since segments are whole chunks): against the operand's rows as
    stored, that product equals the [Re x | Im x] product with the operand's
    real-block form (n = 1400 needs two segments)."""
    n_pad = tcc.fold_pad(n_bins)
    Kp, Np = 2 * n_pad, 2 * (-(-olen // 32) * 32)
    S = tfb.tile_plan(n_bins) * 128
    E = torch.from_numpy(tfb.tiled_idft_matrix(n_bins, olen, S))
    op = tcc.channelize_operand(E, n_bins, olen)
    stored = op.reshape(Np // 64, Kp // 32, 4, 2, 2, 4, 2, 8, 4)
    stored = stored.permute(1, 2, 6, 8, 0, 3, 5, 7, 4).reshape(Kp, Np, 2)[..., 0].double()
    rng = np.random.default_rng(n_bins)
    xf = torch.from_numpy(rng.standard_normal((3, n_pad)) + 1j * rng.standard_normal((3, n_pad)))
    k = torch.arange(n_pad)
    X = torch.zeros((3, Kp), dtype=torch.float64)
    X[:, 32 * (k // 16) + k % 16], X[:, 32 * (k // 16) + 16 + k % 16] = xf.real, xf.imag
    hi, _ = _unpack_operand(op, n_bins, olen)
    want = torch.cat([xf.real, xf.imag], -1) @ hi.double()
    torch.testing.assert_close(X @ stored, want, rtol=1e-12, atol=1e-12)


def select_mirror(keys: np.ndarray, i: int):
    """Kernel B's integer steps, per row: bisect [max(min, 0), max(max, lo)]
    for the smallest v with count(keys <= v) >= i + 1, then the i+1 rule.
    Returns (statistic i, statistic i + 1, bisection steps)."""
    out, steps = [], 0
    for row in keys.astype(np.int64):
        lo = max(int(row.min()), 0)
        hi = max(int(row.max()), lo)
        n = 0
        while lo < hi:
            mid = lo + ((hi - lo) >> 1)
            if int((row <= mid).sum()) >= i + 1:
                hi = mid
            else:
                lo = mid + 1
            n += 1
        above = row[row > lo]
        v1 = lo if int((row <= lo).sum()) >= i + 2 else int(above.min())
        out.append((lo, v1))
        steps = max(steps, n)
    return np.asarray(out, np.int32), steps


@pytest.mark.parametrize("W", [128, 1024, 4096])
def test_kernel_b_selection_matches_partition(W):
    """The range-start bisection equals np.partition bit for bit, with
    ties, zeros, a window of equal energies and an all-zero window, and
    never takes more than the plain version's 31 steps."""
    rng = np.random.default_rng(W)
    e = rng.exponential(1e-9, (12, W)).astype(np.float32)
    e[1] = np.round(e[1] / 2e-10).astype(np.float32) * np.float32(2e-10)  # ties
    e[2, : W // 2] = 0.0  # zeros past statistic i
    e[3, : W // 20] = 0.0  # zeros below it
    e[4] = np.float32(3.5e-9)  # equal energies
    e[5] = 0.0  # all zero
    e[6, 7] = np.inf
    i = int(np.floor(tnz.NQ * (W - 1)))
    got, steps = select_mirror(e.view(np.int32), i)
    want = np.partition(e.view(np.int32), [i, i + 1], axis=-1)[:, [i, i + 1]]
    np.testing.assert_array_equal(got, want)
    _, plain = tnz.estimate_noise_keys(torch.from_numpy(e), 25_601, 2.048e6)
    np.testing.assert_array_equal(plain.numpy(), want)
    assert steps <= 31


def bitonic_layers(a: list, K: int = 2, J: int = 1) -> None:
    """Kernel B's per-lane sort, layer by layer as its template recursion
    unrolls it: compare-exchange i with i ^ J, ascending where i & K is 0."""
    for i in range(len(a)):
        l = i ^ J
        if l > i:
            x, y = a[i], a[l]
            a[i], a[l] = (min(x, y), max(x, y)) if i & K == 0 else (max(x, y), min(x, y))
    if J > 1:
        bitonic_layers(a, K, J // 2)
    elif K < len(a):
        bitonic_layers(a, 2 * K, K)


def count_window(w: list, v: int) -> int:
    """Kernel B's per-lane count on sorted keys: halve the window, keeping
    the upper half where the lower half's last key is <= v."""
    h, p = len(w) // 2, 0
    while h >= 1:
        up = w[h - 1] <= v
        p += h if up else 0
        w = w[h: 2 * h] if up else w[:h]
        h //= 2
    return p + (1 if w[0] <= v else 0)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 64])
def test_kernel_b_sorted_count(n):
    """The per-lane bitonic sort sorts, and the window count equals
    #{keys <= v}, with ties, zeros and the kIntMax slots past a window."""
    rng = np.random.default_rng(n)
    for trial in range(300):
        keys = rng.integers(0, 40 if trial % 2 else 2**31 - 1, n).tolist()
        if trial % 3 == 0:
            keys[n // 2:] = [2**31 - 1] * (n - n // 2)  # slots past the window
        a = list(keys)
        bitonic_layers(a)
        assert a == sorted(keys)
        for v in (-1, 0, int(rng.integers(0, 41)), int(np.median(keys)), 2**31 - 2):
            assert count_window(a, v) == sum(k <= v for k in keys)
