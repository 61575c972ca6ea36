"""PyTorch port, ops/osc.py: Q32 phase words bit-exact against the JAX package."""
import numpy as np
import jax.numpy as jnp
import torch

from ka9q_radio_tpu.ops import osc as josc
from ka9q_radio_tpu_torch.ops import osc as tosc

torch.set_num_threads(2)

_I32 = np.iinfo(np.int32)


def _words(seed: int, n: int) -> np.ndarray:
    """Random int32 phase words plus the wrap-around extremes."""
    rng = np.random.default_rng(seed)
    w = rng.integers(_I32.min, _I32.max, n, dtype=np.int64, endpoint=True)
    w[:4] = [_I32.min, _I32.max, -1, 0]
    return w.astype(np.int32)


def test_rev_to_q32_exact():
    rng = np.random.default_rng(0)
    revs = [0.0, 0.25, -0.25, 0.5, -0.5, 1e-9, 2.0**-33, 0.123456789, -3.75,
            12345.678, *rng.uniform(-1e4, 1e4, 200)]
    for r in revs:
        got, want = tosc.rev_to_q32(r), josc.rev_to_q32(r)
        assert got.dtype == np.int32 and got == want, r


def test_wrap_i32_matches_int32_overflow():
    """The port's explicit int64 -> int32 fold equals JAX's int32 wrap."""
    acc, inc = _words(1, 256), _words(2, 256)
    steps = np.arange(97, dtype=np.int32)
    want = np.asarray(jnp.asarray(acc)[:, None] + jnp.asarray(inc)[:, None] * jnp.asarray(steps))
    got = tosc.wrap_i32(torch.from_numpy(acc).long()[:, None]
                        + torch.from_numpy(inc).long()[:, None] * torch.from_numpy(steps).long())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_phase_ramp_q32_words_and_phasors():
    acc, inc = _words(3, 64), _words(4, 64)
    n = 257
    j_ramp, j_acc = josc.phase_ramp_q32(jnp.asarray(acc), jnp.asarray(inc), n)
    t_ramp, t_acc = tosc.phase_ramp_q32(torch.from_numpy(acc), torch.from_numpy(inc), n)
    assert t_acc.dtype == torch.int32
    np.testing.assert_array_equal(t_acc.numpy(), np.asarray(j_acc))
    # phasors from equal words: f32 cos/sin of the same angle (1-ulp libm spread)
    np.testing.assert_allclose(t_ramp.numpy(), np.asarray(j_ramp), rtol=0, atol=2e-6)


def test_q32_to_rev_and_cis_exact_words():
    q = _words(5, 1000)
    np.testing.assert_array_equal(tosc.q32_to_rev(torch.from_numpy(q)).numpy(),
                                  np.asarray(josc.q32_to_rev(q)))
    np.testing.assert_allclose(tosc.cis_q32(torch.from_numpy(q)).numpy(),
                               np.asarray(josc.cis_q32(q)), rtol=0, atol=2e-6)


def test_pll_init_keys_and_dtypes():
    j = josc.pll_init((7,))
    t = tosc.pll_init((7,), device="cpu")
    assert sorted(j) == sorted(t)
    for k in j:
        assert np.asarray(j[k]).dtype == t[k].numpy().dtype and tuple(t[k].shape) == (7,)
        assert not t[k].any()
