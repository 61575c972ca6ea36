"""The port's signal generator against the JAX package's. With noise off the
blocks agree within 1e-6 of the amplitude over 4 blocks (carrier, FM and AM,
real and complex). The noise streams are different draws (torch.Generator
against JAX's PRNG), so with noise on only the power is compared, within
2%."""
import numpy as np
import jax
import pytest
import torch

from ka9q_radio_tpu.runtime import source as jsrc
from ka9q_radio_tpu_torch.runtime import source as tsrc

FS, L = 1_024_000.0, 20_480
# The first torch.cos/torch.sin of a process (MKL's vector math on the CPU)
# split over two OpenMP threads can come back inaccurate in the second
# thread's half when the host is loaded; one call on one thread first keeps
# every later call exact.
torch.cos(torch.zeros(1)), torch.sin(torch.zeros(1))


def _cfgs(mod, real, **kw):
    return mod.SigGenConfig(samprate=FS, real=real, carrier_hz=201_345.6, amplitude=0.1, **kw)


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("mod", [{}, {"fm_deviation_hz": 3000.0}, {"am_depth": 0.3}],
                         ids=["carrier", "fm", "am"])
def test_siggen_noiseless_matches_jax(real, mod):
    jc, tc = _cfgs(jsrc, real, **mod), _cfgs(tsrc, real, **mod)
    js, ts = jsrc.siggen_init(jc), tsrc.siggen_init(tc, device="cpu")
    step = jax.jit(lambda s: jsrc.siggen_block(jc, s, L))
    for _ in range(4):
        if "fm_deviation_hz" in mod:
            # FM sums per-sample phase steps rounded from float cosines, which
            # the two libraries round 1 ulp apart: each block starts from
            # JAX's carrier phase word, so that drift cannot accumulate
            ts["phase"] = torch.from_numpy(np.array(js["phase"]))
        js, jb = step(js)
        ts, tb = tsrc.siggen_block(tc, ts, L)
        jb = np.asarray(jb)
        assert tb.dtype == (torch.float32 if real else torch.complex64)
        assert np.abs(tb.numpy() - jb).max() <= 1e-6 * tc.amplitude
        np.testing.assert_array_equal(ts["tone_phase"].numpy(), np.asarray(js["tone_phase"]))
        dq = ts["phase"].numpy().astype(np.int64) - np.asarray(js["phase"]).astype(np.int64)
        if "fm_deviation_hz" in mod:
            assert abs(int(dq[0])) <= 4096, dq  # within 2^-20 rev after one block
        else:
            assert dq[0] == 0


@pytest.mark.parametrize("real", [True, False])
def test_siggen_noise_power(real):
    """Noise density N0 = 1e-12/Hz on a -20 dBFS carrier: the block power of
    each package is within 2% of the other's and of the calibrated value."""
    jc, tc = (_cfgs(m, real, noise_n0=1e-12) for m in (jsrc, tsrc))
    js, ts = jsrc.siggen_init(jc), tsrc.siggen_init(tc, device="cpu")
    want = 0.1 ** 2 * (0.5 if real else 1.0) + 1e-12 * (FS / 2 if real else FS)
    jp = tp = 0.0
    for _ in range(4):
        js, jb = jsrc.siggen_block(jc, js, L)
        ts, tb = tsrc.siggen_block(tc, ts, L)
        jp += float(np.mean(np.abs(np.asarray(jb)) ** 2)) / 4
        tp += float(torch.mean(tb.abs() ** 2)) / 4
    assert abs(tp / jp - 1) < 0.02 and abs(tp / want - 1) < 0.02
    # the stream is reproducible from its seed and differs between seeds
    a = tsrc.siggen_block(tc, tsrc.siggen_init(tc, seed=3, device="cpu"), L)[1]
    b = tsrc.siggen_block(tc, tsrc.siggen_init(tc, seed=3, device="cpu"), L)[1]
    c = tsrc.siggen_block(tc, tsrc.siggen_init(tc, seed=4, device="cpu"), L)[1]
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("real", [True, False])
def test_multi_tone_matches_jax(real):
    rng = np.random.default_rng(8)
    freqs = rng.uniform(1e4, 4e5, 16)
    amps = rng.uniform(0.01, 0.05, 16).astype(np.float32)
    js = {"phase": jax.numpy.zeros(16, jax.numpy.int32), "key": jax.random.PRNGKey(0)}
    ts = {"phase": torch.zeros(16, dtype=torch.int32)}
    for _ in range(3):
        js, jb = jsrc.multi_tone_block(js, freqs, amps, FS, L, real=real)
        ts, tb = tsrc.multi_tone_block(ts, freqs, amps, FS, L, real=real)
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-6 * amps.sum()
        np.testing.assert_array_equal(ts["phase"].numpy(), np.asarray(js["phase"]))


def test_siggen_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsrc.siggen_init(_cfgs(tsrc, True))
