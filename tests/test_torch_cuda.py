"""PyTorch port on the card: each CUDA kernel against its plain version, and
the small slice on CUDA against the same slice on the CPU.

These need an NVIDIA GPU with the CUDA toolkit (the kernels build with nvcc
at first use); elsewhere they skip. On such a host:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops import filterbank as tfb
from ka9q_radio_tpu_torch.ops import noise as tnz
from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ladder(real_master: bool, C: int = 256, seed: int = 0, n_bins: int = 256, olen: int = 200):
    rng = np.random.default_rng(seed)
    master_N = 65_536
    m_bins = master_N // 2 + 1 if real_master else master_N
    r = design_bandpass_response(n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0, real_master, master_N)
    resp = (r[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))).astype(np.complex64)
    shifts = (np.linspace(-8000, 20_000, C) if real_master
              else np.linspace(-30_000, 30_000, C)).astype(np.int32)
    rt, tl, sl = tfb.build_tile_params(resp, shifts, real_master, master_N)
    E = tfb.tiled_idft_matrix(n_bins, olen, rt.shape[-1])
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    return (F, rt, tl, sl, shifts, E), (n_bins, olen, real_master, master_N)


@pytest.mark.parametrize("real_master", [True, False])
def test_channelize_kernel_matches_plain(cuda, real_master):
    arrays, geo = _ladder(real_master)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    op = tcc.channelize_operand(args[5], geo[0], geo[1])
    n = tcc.launches["channelize"]
    got = tcc.cuda_channelize(*args, *geo, E_op=op)
    want = tfb.tiled_channelize(*args, *geo)
    torch.cuda.synchronize()
    assert tcc.launches["channelize"] == n + 1
    assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())


@pytest.mark.parametrize("real_master", [True, False])
def test_noise_kernel_matches_plain(cuda, real_master):
    (F, _, _, _, shifts, _), (_, _, _, master_N) = _ladder(real_master)
    F, shifts = torch.as_tensor(F, device=cuda), torch.as_tensor(shifts, device=cuda)
    n0_k, keys_k = tcc.cuda_noise_est(F, shifts, 1000, real_master, master_N, 1e6)
    m_bins = master_N // 2 + 1 if real_master else master_N
    n0_t, keys_t = tnz.estimate_noise_keys(
        tnz.gather_noise_bins(F, shifts, 1000, real_master, master_N), m_bins, 1e6)
    torch.cuda.synchronize()
    assert torch.equal(keys_k, keys_t)
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)


@pytest.mark.parametrize("real_master", [True, False])
@pytest.mark.parametrize("n_bins,olen,C", [(100, 80, 256), (301, 241, 256), (300, 240, 257),
                                            (600, 480, 100), (1200, 960, 40), (1400, 1120, 40),
                                            (2100, 1680, 24)])
def test_channelize_kernel_geometries(cuda, real_master, n_bins, olen, C):
    """A frame more than twice the slice (S = 256 > 2 n: the fold adds three
    terms), an odd n, C = 257 (no multiple of any row tile), slices wide
    enough that a CTA holds 32 and 16 channels, and slices too wide for a
    whole 16-row X tile (n > 1296: the kernel takes it in two K segments),
    up to about the widest the engine puts on this path; two launches give
    the same bits."""
    arrays, geo = _ladder(real_master, C=C, seed=n_bins, n_bins=n_bins, olen=olen)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    op = tcc.channelize_operand(args[5], n_bins, olen)
    got = tcc.cuda_channelize(*args, *geo, E_op=op)
    again = tcc.cuda_channelize(*args, *geo, E_op=op)
    want = tfb.tiled_channelize(*args, *geo)
    torch.cuda.synchronize()
    assert got.shape == (C, olen) and torch.equal(got, again)
    assert float((got - want).abs().max()) < 3e-5 * float(want.abs().max())


@pytest.mark.parametrize("W", [128, 1024, 4096])
def test_noise_kernel_windows(cuda, W):
    """W = 128 (registers, 4 keys a lane), 1024 (32) and 4096 (shared
    memory), C = 257, with an all-zero window, a window of equal energies
    and one of heavy ties: keys exact, N0 within rtol 2e-5."""
    rng = np.random.default_rng(W)
    master_N = 131_072
    m_bins = master_N // 2 + 1
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    F[: 2 * W] = 0.0  # channel 0's window
    F[8 * W: 10 * W] = np.complex64(0.3 + 0.4j)  # channel 1's
    F[12 * W: 14 * W] = np.round(F[12 * W: 14 * W] * 4) / 4  # ties
    shifts = np.linspace(W, m_bins - W, 257).astype(np.int32)
    shifts[:3] = [W // 2, 9 * W, -13 * W]
    F, shifts = torch.as_tensor(F, device=cuda), torch.as_tensor(shifts, device=cuda)
    n0_k, keys_k = tcc.cuda_noise_est(F, shifts, W, True, master_N, 1e6)
    energies = tnz.gather_noise_bins(F, shifts, W, True, master_N)
    n0_t, keys_t = tnz.estimate_noise_keys(energies, m_bins, 1e6)
    torch.cuda.synchronize()
    assert int(energies[0].count_nonzero()) == 0 and bool((energies[1] == energies[1, 0]).all())
    assert torch.equal(keys_k, keys_t)
    assert float(n0_k[0]) == 0.0
    torch.testing.assert_close(n0_k, n0_t, rtol=2e-5, atol=0)


def test_wrappers_refuse_bad_tensors(cuda):
    arrays, geo = _ladder(True, C=8)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    args[1] = args[1].T.contiguous().T  # a non-contiguous response table
    with pytest.raises(ValueError, match="contiguous"):
        tcc.cuda_channelize(*args, *geo)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    args[2] = args[2].long()
    with pytest.raises(TypeError, match="dtype"):
        tcc.cuda_channelize(*args, *geo)
    args = [torch.as_tensor(a, device=cuda) for a in arrays]
    with pytest.raises(ValueError, match="E_op"):  # the kernel's operand is the caller's
        tcc.cuda_channelize(*args, *geo)


def test_small_slice_on_card_matches_cpu(cuda):
    """The small slice of test_torch_engine on the card (kernels) and on the
    CPU (plain versions), six blocks from the same start."""
    import ka9q_radio_tpu_torch.runtime as trt

    fs = 2_048_000
    freqs = np.linspace(0.05 * fs, 0.45 * fs, 64)

    def groups():
        return [trt.GroupSpec(name="hf", demod="linear", samprate=8_000, snr_squelch=True,
                              channels=tuple(trt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                                             for f in freqs)),
                trt.GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0,
                              bin_count=32, channels=(trt.ChannelSpec(freq=5e5),))]

    eg, ec = trt.Engine(fs, groups(), device=cuda), trt.Engine(fs, groups(), device="cpu")
    sg, pg, sc, pc = eg.init_state(), eg.init_params(), ec.init_state(), ec.init_params()
    rng = np.random.default_rng(5)
    tcc.reset_launches()
    for b in range(6):
        t = np.arange(b * eg.L, (b + 1) * eg.L) / fs
        x = (0.01 * rng.standard_normal(eg.L) + 0.2 * np.cos(2 * np.pi * (freqs[9] + 700) * t)
             ).astype(np.float32)
        sg, og = eg.step(sg, pg, torch.as_tensor(x, device=cuda))
        sc, oc = ec.step(sc, pc, torch.from_numpy(x))
        a_g, a_c = og["hf"]["audio"].cpu(), oc["hf"]["audio"]
        assert float((a_g - a_c).abs().max()) < 5e-4 * float(a_c.abs().max())
    assert tcc.launches == {"channelize": 6, "noise_est": 3}
