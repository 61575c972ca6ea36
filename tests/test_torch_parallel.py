"""PyTorch port, the mesh and the distributed FFT (ka9q_radio_tpu_torch/parallel)
against the JAX package: the cases of tests/test_parallel.py. JAX runs on
the 8 virtual CPU devices of tests/conftest.py; the port on a mesh of
["cpu"] * D, the plain versions of its kernels on each shard."""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.parallel import make_mesh as jmesh
from ka9q_radio_tpu.parallel import shard_engine_tree as jshard
from ka9q_radio_tpu.parallel.fft import distributed_fft as jdfft
from ka9q_radio_tpu.parallel.fft import plan_split as jplan
from ka9q_radio_tpu_torch.parallel import Mesh, Sharded, make_mesh, shard_engine_tree
from ka9q_radio_tpu_torch.parallel import sharding as tsh
from ka9q_radio_tpu_torch.parallel.fft import distributed_fft, plan_split

torch.set_num_threads(2)

FLAGSHIP_N = 3_240_000


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return jmesh(jax.devices()[:8])


@pytest.mark.parametrize("N", [768_000, FLAGSHIP_N, 51_200, 4096])
def test_plan_split(N):
    """The split of every mesh size 1..12 equals JAX's (host integers), and
    raises where JAX's raises."""
    for D in range(1, 13):
        try:
            want = jplan(N, D)
        except ValueError:
            with pytest.raises(ValueError, match="no split"):
                plan_split(N, D)
            continue
        got = plan_split(N, D)
        assert got == want and got[0] % D == 0 and got[1] % D == 0, D
    if N == 768_000:
        n1, n2 = plan_split(N, 8)
        assert 0.1 < n1 / n2 < 10.0


@pytest.mark.parametrize("N", [4096, 76_800])
def test_distributed_fft_matches_dense(jax_mesh, N):
    """The six-step transform on 8 shards against the dense FFT (the JAX
    test's relative 2e-4) and against JAX's distributed_fft."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(np.complex64)
    want = np.fft.fft(x)
    got = distributed_fft(torch.from_numpy(x), make_mesh(["cpu"] * 8))
    assert isinstance(got, Sharded) and len(got.shards) == 8
    got = got.full().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-4
    xd = jax.device_put(jnp.asarray(x), NamedSharding(jax_mesh, P("c")))
    jgot = np.asarray(jax.jit(lambda v: jdfft(v, jax_mesh))(xd))
    assert np.linalg.norm(got - jgot) / np.linalg.norm(jgot) < 2e-4


def test_collectives_match_their_jax_namesakes():
    """all_to_all / all_gather / psum_scatter / psum / ppermute on lists of
    shards give what the tiled JAX collectives give, on a mesh of 4."""
    mesh = make_mesh(["cpu"] * 4)
    rng = np.random.default_rng(1)
    xs = [torch.from_numpy(rng.standard_normal((8, 12)).astype(np.float32)) for _ in range(4)]
    glob = np.stack([x.numpy() for x in xs])  # [D, 8, 12]
    out = tsh.all_to_all(xs, mesh, split_dim=1, concat_dim=0)
    for d in range(4):  # device d: column block d of every shard, stacked in shard order
        np.testing.assert_array_equal(out[d].numpy(),
                                      np.concatenate([g[:, 3 * d:3 * d + 3] for g in glob]))
    for g in tsh.all_gather(xs, mesh, dim=0):
        np.testing.assert_array_equal(g.numpy(), glob.reshape(32, 12))
    ps = tsh.psum_scatter(xs, mesh, 0)
    for d in range(4):
        np.testing.assert_allclose(ps[d].numpy(), glob.sum(0)[2 * d:2 * d + 2], rtol=1e-6)
    np.testing.assert_allclose(tsh.psum(xs, mesh)[3].numpy(), glob.sum(0), rtol=1e-6)
    pp = tsh.ppermute(xs, mesh, [(i, (i + 1) % 4) for i in range(4)])
    for d in range(4):
        np.testing.assert_array_equal(pp[d].numpy(), glob[(d - 1) % 4])


def test_mesh_and_placement():
    """make_mesh takes the caller's devices; shards of one device share a
    replicated tensor and own their split rows; a split value's global view
    and in-place row writes address the owning shard."""
    mesh = make_mesh(["cpu"] * 4)
    assert isinstance(mesh, Mesh) and mesh.size == 4 and mesh.shape == {"c": 4}
    t = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    s = Sharded.split(t, mesh, 0)
    assert [tuple(x.shape) for x in s.shards] == [(2, 3)] * 4
    assert len({x.data_ptr() for x in s.shards} | {t.data_ptr()}) == 5
    s.write_row(5, torch.tensor([-1.0, -2.0, -3.0]))
    assert s.shards[2][1].tolist() == [-1.0, -2.0, -3.0] and tuple(s.shape) == (8, 3)
    r = Sharded.replicate(t, mesh)
    assert len(r.unique()) == 1 and r.full() is t
    r.write_row(0, 7.0)
    assert float(t[0, 0]) == 7.0
    np.testing.assert_array_equal(s.cpu().numpy()[5], [-1, -2, -3])


def _fm_engine(rt, **kw):
    FS = 512_000
    freqs = np.linspace(-180_000, 180_000, 16)
    return rt.Engine(samprate=FS, real=False, groups=[rt.GroupSpec(
        name="fm", demod="fm", samprate=16_000,
        channels=tuple(rt.ChannelSpec(freq=float(f), low=-8000.0, high=8000.0)
                       for f in freqs))], **kw), freqs, FS


def _fm_blocks(L, fs, f0, n, seed=0):
    """A 3 kHz-deviation FM carrier at f0 (a 1 kHz tone) in -120 dB/Hz noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n * L) / fs
    ph = 2 * np.pi * f0 * t + 3.0 * np.sin(2 * np.pi * 1000.0 * t)
    x = 0.05 * np.exp(1j * ph) + np.sqrt(1e-12 * fs / 2) * (
        rng.standard_normal(n * L) + 1j * rng.standard_normal(n * L))
    return x.astype(np.complex64).reshape(n, L)


def test_channel_sharding_equivalence(jax_mesh):
    """Splitting the channel axis must not change the numbers: the port's
    sharded engine (8 shards) against its single-device engine and against
    JAX's engine on sharded trees, on one FM scene. Audio to 1e-4/1e-5 and
    fm_snr to 1e-3 (the JAX test's bounds) between the two sharded runs of
    the same transform; the six-step master against the one dense transform
    differs by FFT rounding, held at the sharded-engine bound (audio 2e-3,
    tests/test_sharded_engine.py)."""
    te, freqs, FS = _fm_engine(trt, device="cpu")
    tm, _, _ = _fm_engine(trt, mesh=make_mesh(["cpu"] * 8))
    je, _, _ = _fm_engine(jrt, fft="monolithic")
    blocks = _fm_blocks(te.L, FS, freqs[5], 8)
    ss, ps = te.init_state(), te.init_params()
    sm, pm = tm.init_state(), tm.init_params()
    js, jp = jshard(je, jax_mesh, je.init_state()), jshard(je, jax_mesh, je.init_params())
    step = jax.jit(je.step)
    for b in blocks:
        ss, os_ = te.step(ss, ps, torch.from_numpy(b))
        sm, om = tm.step(sm, pm, torch.from_numpy(b))
        js, oj = step(js, jp, jax.device_put(jnp.asarray(b), NamedSharding(jax_mesh, P())))
    oj = jax.device_get(oj["fm"])
    np.testing.assert_allclose(os_["fm"]["audio"].numpy(), oj["audio"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(os_["fm"]["info"]["fm_snr"].numpy(), oj["info"]["fm_snr"],
                               rtol=1e-3)
    assert np.abs(om["fm"]["audio"].numpy() - oj["audio"]).max() < 2e-3
    np.testing.assert_allclose(om["fm"]["info"]["fm_snr"].numpy(), oj["info"]["fm_snr"],
                               rtol=1e-3)
    assert isinstance(sm["groups"]["fm"]["dc"]["n0"], Sharded)
    assert all(tuple(s.shape) == (2,) for s in sm["groups"]["fm"]["dc"]["n0"].shards)


def test_shard_engine_tree_policy():
    """engine_sharding_tree's rule: leaves led by their group's C split,
    the column-layout master tail splits over its columns, the rest
    replicate; shard_engine_tree keeps a leaf already so placed."""
    mesh = make_mesh(["cpu"] * 8)
    tm, _, _ = _fm_engine(trt, mesh=mesh)
    st = tm.init_state()
    assert st["master"]["tail"].dim == (-1 if tm.digit_cols else None)
    assert st["groups"]["fm"]["dc"]["acc_q32"].dim == 0
    assert st["groups"]["fm"]["dc"]["warmup"].dim is None
    again = shard_engine_tree(tm, mesh, st)
    assert again["groups"]["fm"]["dc"]["n0"] is st["groups"]["fm"]["dc"]["n0"]
    p = tm.init_params()
    assert p["fm"]["responses"].dim == 0 and p["fm"]["resp_tiles"].shards[0].shape[0] == 2


def test_graft_dryrun():
    """The twin of __graft_entry__.dryrun_multichip at a small geometry: on
    16 shards the flagship N does not split, so it prints the FALLBACK
    geometry line, runs the parity drive (retune, grow) and the
    time-sharded pass."""
    from ka9q_radio_tpu_torch.parallel.selftest import dryrun_multichip

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = dryrun_multichip(16, ["cpu"] * 16, n_hf=96)
    text = buf.getvalue()
    assert "dryrun geometry: FALLBACK FS=2,048,000 N=51,200 split=160x320 D=16" in text
    assert "pass 1 OK" in text and "pass 2 OK" in text
    assert res["geometry"] == "FALLBACK" and res["C_hf"] == 112
