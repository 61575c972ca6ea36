"""PyTorch port, the sharded Engine (mesh=...) against the single-device engine
and against the JAX package's sharded engine: the cases of
tests/test_sharded_engine.py, and the parallel/master.py transforms and
gathers against JAX's at a small N. JAX runs on the 8 virtual CPU devices of
tests/conftest.py, the port on a mesh of ["cpu"] * 8 with the plain versions
of its kernels.

Tolerances: the sharded-engine bounds of tests/test_sharded_engine.py
(audio 2e-3 absolute, N0 and baseband power rtol 1e-3) wherever the two
sides use different FFT factorizations (the six-step master against one
dense transform); the same transform on both sides is held tighter."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.parallel import make_mesh as jmesh
from ka9q_radio_tpu.parallel import shard_engine_tree as jshard
from ka9q_radio_tpu_torch.parallel import Sharded, make_mesh
from ka9q_radio_tpu_torch.parallel.selftest import params_ptrs
from ka9q_radio_tpu_torch.runtime import params_from_jax

torch.set_num_threads(2)

FS = 128_000  # L=2560, M=641, N=3200=2^7*5^2 -> 8-way split 40x80
D = 8


def _groups(rt, real: bool):
    span = FS / 2 * 0.8
    fm_lo = 1000.0 if real else -span
    fm_freqs = np.linspace(fm_lo, span, 8)
    lin_freqs = np.linspace(2000.0 if real else -span * 0.9, span * 0.9, 8)
    return [
        rt.GroupSpec(name="nbfm", demod="fm", samprate=8000,
                     channels=tuple(rt.ChannelSpec(freq=float(f), low=-3000, high=3000)
                                    for f in fm_freqs)),
        rt.GroupSpec(name="usb", demod="linear", samprate=8000, filter2=1,
                     channels=tuple(rt.ChannelSpec(freq=float(f), low=50, high=2700)
                                    for f in lin_freqs)),
    ]


def _blocks(L, real: bool, n=4, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n * L) / FS
    if real:
        x = (0.05 * rng.standard_normal(n * L)
             + 0.5 * np.cos(2 * np.pi * 20_000 * t)).astype(np.float32)
    else:
        x = (0.05 * (rng.standard_normal(n * L) + 1j * rng.standard_normal(n * L))
             + 0.5 * np.exp(2j * np.pi * 20_000 * t)).astype(np.complex64)
    return x.reshape(n, L)


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    return jmesh(jax.devices()[:D])


def _run_jax(je, jax_mesh, blocks, params=None):
    st = jshard(je, jax_mesh, jax.jit(je.init_state)())
    p = jshard(je, jax_mesh, je.init_params() if params is None else params)
    step = jax.jit(je.step)
    for b in blocks:
        st, out = step(st, p, jnp.asarray(b))
    return jax.device_get(out)


def _run(eng, blocks, params=None):
    st = eng.init_state()
    p = eng.init_params() if params is None else params
    for b in blocks:
        st, out = eng.step(st, p, torch.from_numpy(np.ascontiguousarray(b)))
    return st, out


def _close(a, b, names=("nbfm", "usb"), n0_rtol=1e-3):
    for g in names:
        assert np.max(np.abs(np.asarray(a[g]["audio"]) - np.asarray(b[g]["audio"]))) < 2e-3, g
        np.testing.assert_allclose(np.asarray(a[g]["info"]["n0"]), np.asarray(b[g]["info"]["n0"]),
                                   rtol=n0_rtol)
        np.testing.assert_allclose(np.asarray(a[g]["info"]["baseband_power"]),
                                   np.asarray(b[g]["info"]["baseband_power"]),
                                   rtol=1e-3, atol=1e-12)


@pytest.mark.parametrize("real", [True, False])
def test_sharded_equals_single(real, jax_mesh):
    """The sharded engine (distributed master, spur notch on the digit rows,
    kernels A and B per shard) against the port's single-device engine, and
    against JAX's sharded engine given the same params (params_from_jax
    placed over the port's mesh)."""
    spurs = [20_000.0]
    ref = trt.Engine(samprate=FS, groups=_groups(trt, real), real=real, spurs=spurs, device="cpu")
    sh = trt.Engine(samprate=FS, groups=_groups(trt, real), real=real, spurs=spurs,
                    mesh=make_mesh(["cpu"] * D))
    je = jrt.Engine(samprate=FS, groups=_groups(jrt, real), real=real, spurs=spurs,
                    mesh=jax_mesh)
    assert (sh.digit.n1, sh.digit.n2) == (je.digit.n1, je.digit.n2) == (40, 80)
    assert sh.digit_cols == je.digit_cols
    blocks = _blocks(ref.L, real)
    _, out_r = _run(ref, blocks)
    st_s, out_s = _run(sh, blocks, params_from_jax(jax.device_get(je.init_params()), engine=sh))
    _close(out_r, out_s)
    _close(_run_jax(je, jax_mesh, blocks), out_s)
    # the carried tail keeps the column layout of JAX's [(N-L)/n2, n2]
    assert sh.digit_cols and tuple(st_s["master"]["tail"].shape) == (8, 80)
    assert st_s["master"]["tail"].dim == -1


def test_sharded_retune_in_place():
    """A retune and a new filter on the sharded engine write the owning
    shard's row in place: the same engine, the same tensors (data
    pointers), and the outputs follow the single-device engine's."""
    ref = trt.Engine(samprate=FS, groups=_groups(trt, False), real=False, device="cpu")
    sh = trt.Engine(samprate=FS, groups=_groups(trt, False), real=False,
                    mesh=make_mesh(["cpu"] * D))
    b = _blocks(sh.L, False, n=1)[0]
    sr, pr = ref.init_state(), ref.init_params()
    ss, ps = sh.init_state(), sh.init_params()
    for _ in range(2):
        sr, _ = ref.step(sr, pr, torch.from_numpy(b))
        ss, _ = sh.step(ss, ps, torch.from_numpy(b))
    eng, ptrs, shifts = sh, params_ptrs(ps), ps["nbfm"]["shifts"]
    for e, p in ((ref, pr), (sh, ps)):
        assert e.retune(p, "nbfm", 3, 12_345.0) is p
        assert e.set_edges(p, "usb", 2, 100.0, 2400.0) is p
    assert sh is eng and params_ptrs(ps) == ptrs and ps["nbfm"]["shifts"] is shifts
    # the owning shard (channel 3 of 8 on 8 shards: shard 3, row 0) took the row
    assert int(ps["nbfm"]["shifts"].shards[3][0]) == int(sh.groups["nbfm"].host["shifts"][3])
    sr, out_r = ref.step(sr, pr, torch.from_numpy(b))
    ss, out_s = sh.step(ss, ps, torch.from_numpy(b))
    assert np.isfinite(out_s["nbfm"]["audio"].numpy()).all()
    _close(out_r, out_s)


def test_sharded_beam(jax_mesh):
    """Beamforming groups read DigitSpectrum.gather_beam (the per-element
    combine of each bin and its mirror, on the digit rows): against the
    single-device engine and JAX's sharded engine."""
    span = FS / 2 * 0.8
    freqs = np.linspace(-span, span, 8)

    def groups(rt):
        return [rt.GroupSpec(name="beam", demod="linear", samprate=8000, beam=True,
                             a_weight=0.8 + 0.1j, b_weight=0.2 - 0.3j,
                             channels=tuple(rt.ChannelSpec(freq=float(f), low=-3000, high=3000)
                                            for f in freqs))]

    ref = trt.Engine(samprate=FS, groups=groups(trt), real=False, device="cpu")
    sh = trt.Engine(samprate=FS, groups=groups(trt), real=False, mesh=make_mesh(["cpu"] * D))
    je = jrt.Engine(samprate=FS, groups=groups(jrt), real=False, mesh=jax_mesh)
    assert not sh.groups["beam"].tiled
    blocks = _blocks(ref.L, False, n=2)
    _, out_r = _run(ref, blocks)
    _, out_s = _run(sh, blocks)
    a_s = out_s["beam"]["audio"].numpy()
    assert np.max(np.abs(out_r["beam"]["audio"].numpy() - a_s)) < 2e-3
    assert np.max(np.abs(np.asarray(_run_jax(je, jax_mesh, blocks)["beam"]["audio"]) - a_s)) < 2e-3


def test_sharded_rejects_odd_channel_count():
    groups = [trt.GroupSpec(name="g", demod="fm", samprate=8000,
                            channels=tuple(trt.ChannelSpec(freq=1000.0 * i) for i in range(1, 4)))]
    with pytest.raises(ValueError, match="not divisible"):
        trt.Engine(samprate=FS, groups=groups, real=False, mesh=make_mesh(["cpu"] * D))


def test_flagship_geometry_parity(jax_mesh):
    """The flagship geometry (N = 3,240,000, the rof3240000 transform) on 8
    shards: the 1800 x 1800 split and the column-layout tail of 360 rows,
    as JAX's engine plans them (built, not stepped, at full size on the
    CPU); then the parity drive (sharded == single over 10 blocks with a
    retune at block 3 and a table grow at block 6, selftest.py's bounds) at
    the dryrun's fallback rate, 2.048 Msps."""
    from ka9q_radio_tpu_torch.parallel.selftest import (FALLBACK_FS, FLAGSHIP_FS,
                                                        _flagship_groups, flagship_parity)

    mesh = make_mesh(["cpu"] * D)
    te = trt.Engine(samprate=FLAGSHIP_FS, real=True, mesh=mesh,
                    groups=_flagship_groups(FLAGSHIP_FS, 8, 8))
    je = jrt.Engine(samprate=FLAGSHIP_FS, real=True, mesh=jax_mesh, groups=[
        jrt.GroupSpec(name="hf", demod="linear", samprate=12_000,
                      channels=tuple(jrt.ChannelSpec(freq=1e6 * (k + 1)) for k in range(8)))])
    assert te.master.N == je.master.N == 3_240_000
    assert (te.digit.n1, te.digit.n2) == (je.digit.n1, je.digit.n2) == (1800, 1800)
    assert te.digit_cols and je.digit_cols
    assert (te.master.L // 1800, (te.master.N - te.master.L) // 1800) == (1440, 360)
    tail = te.init_state()["master"]["tail"]
    assert tuple(tail.shape) == (360, 1800) and tail.dim == -1
    assert all(tuple(s.shape) == (360, 225) for s in tail.shards)
    res = flagship_parity(mesh, nblocks=10, n_hf=200, FS=FALLBACK_FS)
    assert res["C_hf"] == 200 + D and res["audio_err_over_bound"] <= 1.0  # grown by D at block 6


def test_sharded_chan_kernel_parity(monkeypatch, jax_mesh):
    """Kernels A and B under the sharded master: each shard runs them (their
    plain versions here) on its local C/D rows of the all-gathered
    natural-order spectrum, the same as the single-device engine's rows on
    the same spectrum; audio and N0 match the single-device engine and JAX's
    sharded engine with its Pallas kernels (interpret mode; the JAX test's
    bounds: audio 2e-2 of the peak, N0 rtol 2e-4), also after a far
    retune."""
    FSK = 2_048_000
    C = 1024  # 8 shards of 128 channels
    freqs = np.linspace(0.05 * FSK, 0.45 * FSK, C)

    def mk(rt):
        return [rt.GroupSpec(name="hf", demod="linear", samprate=8_000,
                             channels=tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=2_700.0)
                                            for f in freqs))]

    em = trt.Engine(samprate=FSK, real=True, groups=mk(trt), mesh=make_mesh(["cpu"] * D))
    ed = trt.Engine(samprate=FSK, real=True, groups=mk(trt), device="cpu")
    monkeypatch.setenv("KA9Q_CHAN_KERNEL", "force")
    je = jrt.Engine(samprate=FSK, real=True, groups=mk(jrt), mesh=jax_mesh)
    monkeypatch.delenv("KA9Q_CHAN_KERNEL")
    assert je.groups["hf"].chan_kernel and em.groups["hf"].tiled

    # per shard, on one spectrum: shard d's rows are the single engine's rows
    rng = np.random.default_rng(5)
    F = torch.from_numpy((rng.standard_normal(em.master.bins)
                          + 1j * rng.standard_normal(em.master.bins)).astype(np.complex64))
    gm, gd, pm = em.groups["hf"], ed.groups["hf"], em.init_params()["hf"]
    whole = gd._channelize(ed.init_params()["hf"], F)
    n0 = gd._noise_est(ed.init_params()["hf"], F)
    from ka9q_radio_tpu_torch.parallel.sharding import local_tree
    for d in range(D):
        lp = local_tree(pm, d)
        rows = slice(d * C // D, (d + 1) * C // D)
        assert torch.equal(gm._channelize(lp, F, d), whole[rows])
        assert torch.equal(gm._noise_est(lp, F, d), n0[rows])

    t = np.arange(4 * em.L) / FSK
    x = (0.01 * rng.standard_normal(4 * em.L)
         + 0.3 * np.cos(2 * np.pi * (freqs[C // 3] + 700.0) * t)).astype(np.float32)
    blocks = x.reshape(4, em.L)
    sm, pm = em.init_state(), em.init_params()
    sd, pd = ed.init_state(), ed.init_params()
    for i in range(4):
        sm, om = em.step(sm, pm, torch.from_numpy(blocks[i]))
        sd, od = ed.step(sd, pd, torch.from_numpy(blocks[i]))
    oj = _run_jax(je, jax_mesh, blocks)
    am, ad = om["hf"]["audio"].numpy(), od["hf"]["audio"].numpy()
    for other in (ad, np.asarray(oj["hf"]["audio"])):
        assert np.abs(am - other).max() < 2e-2 * max(np.abs(other).max(), 1e-9)
    nm = om["hf"]["info"]["n0"].numpy()
    np.testing.assert_allclose(nm, od["hf"]["info"]["n0"].numpy(), rtol=2e-4)
    np.testing.assert_allclose(nm, np.asarray(oj["hf"]["info"]["n0"]), rtol=2e-4)

    # a far retune (JAX's kernel disarms there; the port's kernels read any
    # layout) still matches
    em.retune(pm, "hf", 10, 1_000_000.0)
    ed.retune(pd, "hf", 10, 1_000_000.0)
    sm, om = em.step(sm, pm, torch.from_numpy(blocks[0]))
    sd, od = ed.step(sd, pd, torch.from_numpy(blocks[0]))
    am, ad = om["hf"]["audio"].numpy(), od["hf"]["audio"].numpy()
    assert np.abs(am - ad).max() < 2e-2 * max(np.abs(ad).max(), 1e-9)


def _lazy_groups(rt, C, freqs):
    return [
        rt.GroupSpec(name="usb", demod="linear", samprate=8_000,
                     channels=tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=2_700.0)
                                    for f in freqs)),
        rt.GroupSpec(name="sweep", demod="spectrum", samprate=8_000, bin_bw=50.0, bin_count=32,
                     channels=tuple(rt.ChannelSpec(freq=float(f)) for f in freqs)),
    ]


def test_sharded_lazy_spectrum_gate():
    """A narrowband spectrum group under the sharded master: disarmed it
    yields zero bins, re-armed it accumulates, and the linear group is the
    same either way."""
    C = 16
    freqs = np.linspace(0.1 * FS, 0.4 * FS, C)
    em = trt.Engine(samprate=FS, real=True, groups=_lazy_groups(trt, C, freqs),
                    mesh=make_mesh(["cpu"] * D))
    ed = trt.Engine(samprate=FS, real=True, groups=_lazy_groups(trt, C, freqs), device="cpu")
    assert not em.groups["sweep"].spectrum_wide
    blocks = _blocks(em.L, real=True)
    sm, pm = em.init_state(), em.init_params()
    sd, pd = ed.init_state(), ed.init_params()
    em.set_armed(pm, "sweep", False)
    for i in range(2):
        sm, om = em.step(sm, pm, torch.from_numpy(blocks[i]))
        sd, od = ed.step(sd, pd, torch.from_numpy(blocks[i]))
    assert np.abs(om["sweep"]["info"]["bin_data"].numpy()).max() == 0.0
    assert np.abs(om["usb"]["audio"].numpy() - od["usb"]["audio"].numpy()).max() < 2e-3
    em.set_armed(pm, "sweep", True)
    for i in range(2, 4):
        sm, om = em.step(sm, pm, torch.from_numpy(blocks[i]))
    assert np.abs(om["sweep"]["info"]["bin_data"].numpy()).max() > 0.0


def test_sharded_big_spectrum_group_runs():
    """The ADVICE.md case: under a mesh, a narrowband spectrum group of
    10,000 channels (the JAX kernel gate's threshold, engine.py:380) runs
    through kernel A on each shard's 1,250 rows and matches the
    single-device engine's bins (selftest.py's sweep bound: rtol 2e-2, for
    the two FFT factorizations)."""
    C = 10_000
    freqs = np.linspace(0.05 * FS, 0.45 * FS, C)
    groups = lambda: [trt.GroupSpec(name="sweep", demod="spectrum", samprate=8_000,  # noqa: E731
                                    bin_bw=50.0, bin_count=32,
                                    channels=tuple(trt.ChannelSpec(freq=float(f)) for f in freqs))]
    em = trt.Engine(samprate=FS, real=True, groups=groups(), mesh=make_mesh(["cpu"] * D))
    ed = trt.Engine(samprate=FS, real=True, groups=groups(), device="cpu")
    g = em.groups["sweep"]
    assert g.tiled and g.tile_E is not None and not g.spectrum_wide
    blocks = _blocks(em.L, real=True, n=3)
    _, om = _run(em, blocks)
    _, od = _run(ed, blocks)
    bm, bd = om["sweep"]["info"]["bin_data"].numpy(), od["sweep"]["info"]["bin_data"].numpy()
    assert bm.shape == bd.shape == (C, 32) and np.abs(bd).max() > 0
    np.testing.assert_allclose(bm, bd, rtol=2e-2, atol=1e-12)


@pytest.mark.parametrize("real", [True, False])
def test_digit_master_and_spectrum_match_jax(real, jax_mesh):
    """DigitMaster (fft, fft_natural with and without cols_in, take, notch)
    and DigitSpectrum's gathers against JAX's on 8 devices at N = 3,200, on
    the same numpy input; both run the same six-step factorization, so the
    spectra agree to 1e-5 of their peak and the gathers to the same."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ka9q_radio_tpu.parallel.master import DigitMaster as JDM
    from ka9q_radio_tpu.parallel.master import DigitSpectrum as JDS
    from ka9q_radio_tpu_torch.parallel.master import DigitMaster, DigitSpectrum

    N = 3200
    mesh = make_mesh(["cpu"] * D)
    dm = DigitMaster.plan(mesh, "c", N, real=real)
    jdm = JDM.plan(jax_mesh, "c", N, real=real, mxu=False)
    assert (dm.n1, dm.n2, dm.n2_kept, dm.kept_pad, dm.nat_bins) == \
        (jdm.n1, jdm.n2, jdm.n2_kept, jdm.kept_pad, jdm.nat_bins)
    with pytest.raises(ValueError, match="mxu"):
        DigitMaster.plan(mesh, "c", N, mxu=True)
    with pytest.raises(ValueError, match="bf16"):
        DigitMaster.plan(mesh, "c", N, precision="bf16")
    with pytest.raises(ValueError, match="no split"):
        DigitMaster.plan(make_mesh(["cpu"] * 16), "c", 3_240_000)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(N) if real else
         rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(
        np.float32 if real else np.complex64)
    jx = jnp.asarray(x)
    scale = np.abs(np.fft.fft(x)).max()

    def near(a, b):
        assert np.abs(np.asarray(a) - np.asarray(b)).max() < 1e-5 * scale

    zd = dm.fft(torch.from_numpy(x))
    jzd = jax.jit(jdm.fft)(jx.astype(jnp.complex64))
    near(zd.full().numpy(), jzd)
    near(dm.fft_natural(torch.from_numpy(x)).full().numpy(), jax.jit(jdm.fft_natural)(jx))
    x2 = x.reshape(dm.n1, dm.n2)
    jx2 = jax.device_put(jnp.asarray(x2), NamedSharding(jax_mesh, P(None, "c")))
    near(dm.fft_natural(torch.from_numpy(x2), cols_in=True).full().numpy(),
         jax.jit(lambda v: jdm.fft_natural(v, cols_in=True))(jx2))
    m_bins = N // 2 + 1 if real else N
    idx = rng.integers(0, m_bins, (16, 12))
    near(dm.take(zd, torch.from_numpy(idx)).full().numpy(),
         jax.jit(jdm.take)(jzd, jnp.asarray(idx)))
    spurs = np.array([0, 7, 100, 555])
    track = (rng.standard_normal(4) + 1j * rng.standard_normal(4)).astype(np.complex64)
    dm.notch(zd, spurs, torch.from_numpy(track))
    jzd = jax.jit(lambda z, t: jdm.notch(z, spurs, t))(jzd, jnp.asarray(track))
    near(zd.full().numpy(), jzd)
    spec, jspec = DigitSpectrum(dm, zd, real), JDS(jdm, jzd, real)
    shifts = (rng.integers(-m_bins // 2 + 200, m_bins // 2 - 200, 16) if not real else
              rng.integers(-m_bins + 200, m_bins - 200, 16)).astype(np.int32)
    ts = torch.from_numpy(shifts)
    near(spec.gather(ts, 200).full().numpy(), jax.jit(lambda s: jspec.gather(s, 200))(shifts))
    got = spec.gather_noise(ts, 300).full().numpy()
    want = np.asarray(jax.jit(lambda s: jspec.gather_noise(s, 300))(shifts))
    assert np.abs(got - want).max() < 1e-5 * scale * scale
    if not real:
        al = (rng.standard_normal(16) + 1j * rng.standard_normal(16)).astype(np.complex64)
        be = (rng.standard_normal(16) + 1j * rng.standard_normal(16)).astype(np.complex64)
        near(spec.gather_beam(ts, 64, torch.from_numpy(al), torch.from_numpy(be)).full().numpy(),
             jax.jit(lambda s, a, b: jspec.gather_beam(s, 64, a, b))(shifts, al, be))


def test_sharded_multi_input(jax_mesh):
    """Two front ends on the sharded engine: the distributed master batches
    over the [B] axis, a tiled group spanning both inputs reads its rows
    (kernels A and B with input offsets on each shard), a beamforming group
    on input 1 reads the digit rows through DigitSpectrum with its input;
    against the single-device engine of two inputs and JAX's sharded one."""
    from torch_scenes import multi_blocks

    span = 0.4 * 1_024_000

    def groups(rt):
        lin = tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0, input=b)
                    for b in range(2) for f in np.linspace(-span, span, 4))
        beam = tuple(rt.ChannelSpec(freq=float(f), low=-3000.0, high=3000.0)
                     for f in np.linspace(-span, span, 8))
        return [rt.GroupSpec(name="lin", demod="linear", samprate=16_000, channels=lin),
                rt.GroupSpec(name="beam", demod="linear", samprate=16_000, beam=True, input=1,
                             a_weight=0.8 + 0.1j, b_weight=0.2 - 0.3j, channels=beam)]

    kw = dict(samprate=1_024_000, real=False, n_inputs=2, spurs=[100e3])
    ref = trt.Engine(groups=groups(trt), device="cpu", **kw)
    sh = trt.Engine(groups=groups(trt), mesh=make_mesh(["cpu"] * D), **kw)
    je = jrt.Engine(groups=groups(jrt), mesh=jax_mesh, **kw)
    assert sh.groups["lin"].tiled and not sh.groups["beam"].tiled
    blocks = multi_blocks(4, 2, ref.L, seed=9)
    _, out_r = _run(ref, blocks)
    st, out_s = _run(sh, blocks)
    out_j = _run_jax(je, jax_mesh, blocks)
    for g in ("lin", "beam"):
        for other in (out_r[g]["audio"], out_j[g]["audio"]):
            assert np.max(np.abs(np.asarray(other) - out_s[g]["audio"].numpy())) < 2e-3, g
        np.testing.assert_allclose(out_s[g]["info"]["n0"].numpy(),
                                   np.asarray(out_r[g]["info"]["n0"]), rtol=1e-3)
    assert tuple(st["master"]["tail"].shape)[0] == 2
    assert tuple(out_s["_frontend"]["if_power"].shape) == (2,)
