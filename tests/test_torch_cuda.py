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


def _ladder(real_master: bool, C: int = 256, seed: int = 0):
    rng = np.random.default_rng(seed)
    master_N = 65_536
    m_bins = master_N // 2 + 1 if real_master else master_N
    n_bins, olen = 256, 200
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
    n = tcc.launches["channelize"]
    got = tcc.cuda_channelize(*args, *geo)
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
