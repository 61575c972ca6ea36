"""PyTorch port, time-axis sharding (parallel/timeshard.py, Engine(time_shards=D)
and its step_time) and the daemon's `mesh = yes`, against the sequential
single-device engine and against the JAX package: the cases of
tests/test_timeshard.py and tests/test_timeshard_engine.py. JAX runs on the 8
virtual CPU devices of tests/conftest.py, the port on a mesh of
["cpu"] * D; the daemons on a caller's CPU mesh (Radiod(mesh=...))."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.config import load_config as jload
from ka9q_radio_tpu.ops.filterbank import MasterConfig as JMasterConfig
from ka9q_radio_tpu.parallel import make_mesh as jmesh
from ka9q_radio_tpu.parallel.timeshard import batch_master_fft as jbatch
from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
from ka9q_radio_tpu_torch.config import load_config as tload
from ka9q_radio_tpu_torch.net.status import StatusType as T
from ka9q_radio_tpu_torch.net.status import encode_status
from ka9q_radio_tpu_torch.ops.filterbank import MasterConfig, master_fft, master_init
from ka9q_radio_tpu_torch.parallel import Sharded, make_mesh
from ka9q_radio_tpu_torch.parallel.selftest import params_ptrs
from ka9q_radio_tpu_torch.parallel.sharding import full_tree
from ka9q_radio_tpu_torch.parallel.timeshard import batch_master_fft
from ka9q_radio_tpu_torch.runtime.radiod import Radiod as TRadiod
from test_torch_radiod import assert_same_sent

torch.set_num_threads(2)

FS = 1_024_000
D = 8


@pytest.fixture(scope="module")
def jax_mesh():
    if len(jax.devices()) < D:
        pytest.skip("needs 8 virtual devices")
    return jmesh(jax.devices()[:D])


@pytest.mark.parametrize("real", [True, False])
def test_batch_equals_sequential(real, jax_mesh):
    """D master FFTs at once, the (M-1) halo passed shard to shard, equal D
    sequential master_fft steps bit for bit, and the carried tail is the
    stream's last M-1 samples exactly (atol 0); the spectra equal JAX's
    batch_master_fft's to 1e-6 of their peak (the JAX test's bound)."""
    cfg = MasterConfig.from_rate(128_000, real=real)
    mesh = make_mesh(["cpu"] * D)
    rng = np.random.default_rng(0)
    nb = 3
    x = rng.standard_normal((nb * D, cfg.L))
    if not real:
        x = x + 1j * rng.standard_normal((nb * D, cfg.L))
    x = x.astype(np.float32 if real else np.complex64)
    st = master_init(cfg)
    seq = []
    for b in x:
        st, F = master_fft(cfg, st, torch.from_numpy(b))
        seq.append(F)
    tail = master_init(cfg)["tail"]
    jcfg = JMasterConfig.from_rate(128_000, real=real)
    jtail = jnp.zeros(cfg.M - 1, jnp.float32 if real else jnp.complex64)
    jfn = jax.jit(lambda t, blks: jbatch(jcfg, t, blks, jax_mesh))
    got, jgot = [], []
    for k in range(nb):
        tail, F = batch_master_fft(cfg, tail, torch.from_numpy(x[k * D:(k + 1) * D]), mesh)
        assert isinstance(F, Sharded) and len(F.shards) == D and tail.dim is None
        got.append(F.full())
        jtail, jF = jfn(jtail, jnp.asarray(x[k * D:(k + 1) * D]))
        jgot.append(np.asarray(jF))
    got = torch.cat(got)
    assert torch.equal(got, torch.stack(seq))
    np.testing.assert_array_equal(tail.full().numpy(), x[-1][cfg.L - (cfg.M - 1):])
    jgot = np.concatenate(jgot)
    assert np.max(np.abs(got.numpy() - jgot)) / np.max(np.abs(jgot)) < 1e-6


def _groups(rt):
    lin = tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                for f in np.linspace(-400e3, 400e3, 6))
    fm = tuple(rt.ChannelSpec(freq=float(f), low=-8000.0, high=8000.0)
               for f in np.linspace(-300e3, 300e3, 4))
    return [
        rt.GroupSpec(name="usb", demod="linear", samprate=16_000, snr_squelch=True, channels=lin),
        rt.GroupSpec(name="nbfm", demod="fm", samprate=16_000, channels=fm),
        # a filter2 cascade carries tail2 across the blocks
        rt.GroupSpec(name="sharp", demod="linear", samprate=16_000, filter2=1, channels=lin[:2]),
    ]


def _blocks(L, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, L, 2)).astype(np.float32) * 1e-2
    # carriers, so that squelch, AGC and the PLL state move
    t = (np.arange(n * L).reshape(n, L)) / FS
    x[..., 0] += 0.05 * np.cos(2 * np.pi * 100e3 * t).astype(np.float32)
    x[..., 1] += 0.05 * np.sin(2 * np.pi * 100e3 * t).astype(np.float32)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def _state_mismatches(st, ss) -> list:
    """Paths where two state trees differ beyond rtol 2e-5 / atol 2e-6."""
    bad = []

    def walk(a, b, path):
        if isinstance(b, dict):
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
            return
        a, b = np.asarray(a), np.asarray(b)
        if not np.allclose(a, b, rtol=2e-5, atol=2e-6):
            bad.append(path)

    walk({k: v for k, v in st.items() if k != "host"},
         {k: v for k, v in ss.items() if k != "host"}, "")
    return bad


def test_time_sharded_equals_sequential(jax_mesh):
    """step_time over D = 8 shards (batched masters with the halo, spur
    trackers carried across the blocks, A and B on every block's device,
    the demodulator tails block after block) equals D sequential step()
    calls (audio rtol 2e-5 / atol 2e-6, N0 1e-5, IF power 1e-5, and the
    whole carried state), and JAX's step_time at the same bounds."""
    mesh = make_mesh(["cpu"] * D)
    et = trt.Engine(samprate=FS, real=False, groups=_groups(trt), mesh=mesh, time_shards=D,
                    spurs=[100e3])
    es = trt.Engine(samprate=FS, real=False, groups=_groups(trt), spurs=[100e3], device="cpu")
    je = jrt.Engine(samprate=FS, real=False, groups=_groups(jrt), mesh=jax_mesh, time_shards=D,
                    spurs=[100e3])
    assert et.groups["usb"].tiled == es.groups["usb"].tiled
    blocks = _blocks(es.L, 2 * D)
    st, ss = et.init_state(), es.init_state()
    pt, ps = et.init_params(), es.init_params()
    js, jp = jax.jit(je.init_state)(), je.init_params()
    jstep = jax.jit(je.step_time)
    shard = NamedSharding(jax_mesh, P("c", None))
    for batch in range(2):
        bt = blocks[batch * D:(batch + 1) * D]
        st, out_t = et.step_time(st, pt, torch.from_numpy(bt))
        js, out_j = jstep(js, jp, jax.device_put(jnp.asarray(bt), shard))
        out_j = jax.device_get(out_j)
        outs_s = []
        for d in range(D):
            ss, o = es.step(ss, ps, torch.from_numpy(blocks[batch * D + d]))
            outs_s.append(o)
        for g in ("usb", "nbfm", "sharp"):
            a_t = out_t[g]["audio"].numpy()
            np.testing.assert_allclose(a_t, out_j[g]["audio"], rtol=2e-5, atol=2e-6, err_msg=g)
            for d in range(D):
                np.testing.assert_allclose(a_t[d], outs_s[d][g]["audio"].numpy(), rtol=2e-5,
                                           atol=2e-6, err_msg=f"{g} block {d} batch {batch}")
            np.testing.assert_allclose(out_t[g]["info"]["n0"][-1].numpy(),
                                       outs_s[-1][g]["info"]["n0"].numpy(), rtol=1e-5)
        np.testing.assert_allclose(
            out_t["_frontend"]["if_power"].numpy()[:, 0],
            np.array([float(o["_frontend"]["if_power"][0]) for o in outs_s]), rtol=1e-5)
        assert tuple(out_t["_frontend"]["if_power"].shape) == (D, 1)
    assert st["host"] == ss["host"]
    assert not _state_mismatches(full_tree(st, "cpu"), ss)


def test_time_sharded_retune_in_place():
    """A retune on the time-sharded engine writes every replica's row in
    place (the same tensors), and its next dispatch equals the sequential
    engine retuned alike."""
    mesh = make_mesh(["cpu"] * D)
    et = trt.Engine(samprate=FS, real=False, groups=_groups(trt), mesh=mesh, time_shards=D)
    es = trt.Engine(samprate=FS, real=False, groups=_groups(trt), device="cpu")
    blk = _blocks(et.L, D)
    st, ss = et.init_state(), es.init_state()
    pt, ps = et.init_params(), es.init_params()
    st, _ = et.step_time(st, pt, torch.from_numpy(blk))
    for b in blk:
        ss, _ = es.step(ss, ps, torch.from_numpy(b))
    ptrs = params_ptrs(pt)
    assert et.retune(pt, "usb", 1, 222_000.0) is pt and params_ptrs(pt) == ptrs
    es.retune(ps, "usb", 1, 222_000.0)
    st, out_t = et.step_time(st, pt, torch.from_numpy(blk))
    for d, b in enumerate(blk):
        ss, o = es.step(ss, ps, torch.from_numpy(b))
        np.testing.assert_allclose(out_t["usb"]["audio"][d].numpy(), o["usb"]["audio"].numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_time_shards_validation():
    mesh = make_mesh(["cpu"] * 4)
    with pytest.raises(ValueError, match="time_shards"):
        trt.Engine(samprate=FS, real=False, groups=_groups(trt), mesh=mesh, time_shards=8)
    with pytest.raises(ValueError, match="mesh"):
        trt.Engine(samprate=FS, real=False, groups=_groups(trt), time_shards=8, device="cpu")
    eng = trt.Engine(samprate=FS, real=False, groups=_groups(trt), mesh=mesh, time_shards=4)
    with pytest.raises(ValueError, match="step_time"):
        eng.step(eng.init_state(), eng.init_params(), torch.zeros(eng.L, dtype=torch.complex64))
    plain = trt.Engine(samprate=FS, real=False, groups=_groups(trt), device="cpu")
    with pytest.raises(ValueError, match="time_shards"):
        plain.step_time(plain.init_state(), plain.init_params(),
                        torch.zeros((4, plain.L), dtype=torch.complex64))


def test_time_sharded_multi_input_equals_sequential(jax_mesh):
    """time_shards x n_inputs: the halo exchange and the masters batch over
    the [B] input axis; step_time([D, B, L]) equals D steps of [B, L] and
    JAX's step_time, and the carried tails match per input."""
    B = 2

    def g(rt):
        lin0 = tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0, input=0)
                     for f in np.linspace(-400e3, 400e3, 3))
        lin1 = tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0, input=1)
                     for f in np.linspace(-350e3, 350e3, 3))
        return [rt.GroupSpec(name="usb", demod="linear", samprate=16_000, snr_squelch=True,
                             channels=lin0 + lin1)]

    mesh = make_mesh(["cpu"] * D)
    et = trt.Engine(samprate=FS, real=False, groups=g(trt), mesh=mesh, time_shards=D, n_inputs=B)
    es = trt.Engine(samprate=FS, real=False, groups=g(trt), n_inputs=B, device="cpu")
    je = jrt.Engine(samprate=FS, real=False, groups=g(jrt), mesh=jax_mesh, time_shards=D,
                    n_inputs=B)
    both = np.stack([_blocks(es.L, 2 * D, seed=3), _blocks(es.L, 2 * D, seed=7) * 0.5], axis=1)
    st, ss = et.init_state(), es.init_state()
    pt, ps = et.init_params(), es.init_params()
    js, jp = jax.jit(je.init_state)(), je.init_params()
    jstep = jax.jit(je.step_time)
    shard = NamedSharding(jax_mesh, P("c", None, None))
    for batch in range(2):
        bt = both[batch * D:(batch + 1) * D]
        st, out_t = et.step_time(st, pt, torch.from_numpy(bt))
        js, out_j = jstep(js, jp, jax.device_put(jnp.asarray(bt), shard))
        a_t = out_t["usb"]["audio"].numpy()
        np.testing.assert_allclose(a_t, np.asarray(out_j["usb"]["audio"]), rtol=2e-5, atol=2e-6)
        for d in range(D):
            ss, o = es.step(ss, ps, torch.from_numpy(both[batch * D + d]))
            np.testing.assert_allclose(a_t[d], o["usb"]["audio"].numpy(), rtol=2e-5, atol=2e-6,
                                       err_msg=f"block {d} batch {batch}")
            np.testing.assert_allclose(out_t["_frontend"]["if_power"][d].numpy(),
                                       o["_frontend"]["if_power"].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(st["master"]["tail"].full().numpy(),
                                  ss["master"]["tail"].numpy())


DAEMON = """
[global]
hardware = gen
{opts}status = 127.0.0.1
data = 127.0.0.1
update = 1

[gen]
device = sig_gen
samprate = 1m024
complex = yes
carrier = 100k
amplitude = -20
noise = -80

[am]
demod = am
samprate = 16k
low = -5k
high = 5k
freq = "100k 110k 120k 130k 140k 150k 160k 170k"
"""


def _daemon_blocks(n, L, rng):
    t = np.arange(n * L).reshape(n, L) / FS
    x = 0.1 * np.exp(2j * np.pi * 100e3 * t) + 1e-3 * (
        rng.standard_normal((n, L)) + 1j * rng.standard_normal((n, L)))
    return x.astype(np.complex64)


def test_radiod_time_shards_on_a_mesh():
    """`mesh = yes` + `time-shards` on a caller's CPU mesh of 8: D = 8
    blocks a dispatch through Engine.step_time, the same packets as JAX's
    time-sharded daemon (on its 8 devices) and as the port's plain daemon
    fed the blocks one by one; a retune command writes rows in place."""
    conf = DAEMON.format(opts="mesh = yes\ntime-shards = yes\n")
    td = TRadiod(tload(conf), use_network=False, mesh=make_mesh(["cpu"] * D))
    jd = JRadiod(jload(conf), use_network=False)
    tp = TRadiod(tload(DAEMON.format(opts="")), use_network=False, device="cpu")
    assert td._time_shards == jd._time_shards == D and td.step == td.engine.step_time
    rng = np.random.default_rng(4)
    blocks = _daemon_blocks(2 * D, td.engine.L, rng)
    for k in range(2):
        td.step_block(block=blocks[k * D:(k + 1) * D])
        jd.step_block(block=blocks[k * D:(k + 1) * D])
    for b in blocks:
        tp.step_block(block=b)
    assert td.blocks == jd.blocks == tp.blocks == 2 * D
    assert_same_sent(jd._sent, td._sent)
    assert_same_sent(tp._sent, td._sent)
    ptrs, eng = params_ptrs(td.params), td.engine
    td.handle_packet(encode_status({T.OUTPUT_SSRC: 100, T.RADIO_FREQUENCY: 120_000.0}, cmd=True))
    td.step_block(block=blocks[:D])
    assert td.engine is eng and params_ptrs(td.params) == ptrs


def test_radiod_mesh_yes_channel_sharded(tmp_path):
    """`mesh = yes` without time-shards on a caller's CPU mesh of 8: the
    channel-sharded engine (distributed master, 8 am channels one a shard),
    the same packets as JAX's `mesh = yes` daemon on its 8 devices; a
    dynamic create rounds the new group up to a multiple of 8 slots in both
    daemons (the rebuild re-places state and params over the mesh), and a
    checkpoint round-trips the sharded state."""
    conf = DAEMON.format(opts="mesh = yes\n")
    td = TRadiod(tload(conf), use_network=False, mesh=make_mesh(["cpu"] * D))
    jd = JRadiod(jload(conf), use_network=False)
    assert td.engine.digit is not None and td._time_shards == 0
    rng = np.random.default_rng(6)
    for b in _daemon_blocks(4, td.engine.L, rng):
        td.step_block(block=b)
        jd.step_block(block=b)
    pkt = encode_status({T.OUTPUT_SSRC: 7777, T.COMMAND_TAG: 8, T.PRESET: "usb",
                         T.RADIO_FREQUENCY: 150_000.0}, cmd=True)
    for rd in (td, jd):
        rd.handle_packet(pkt)
        rd._finish_restock(wait=True)
    g = td.chans[7777].group
    assert td.engine.groups[g].C % D == 0 and td.engine.groups[g].C == jd.engine.groups[g].C
    assert isinstance(td.params[g]["shifts"], Sharded)
    for b in _daemon_blocks(3, td.engine.L, rng):
        td.step_block(block=b)
        jd.step_block(block=b)
    assert_same_sent(jd._sent, td._sent)
    path = str(tmp_path / "ck.npz")
    td.save_checkpoint(path)
    before = full_tree({k: v for k, v in td.state.items() if k != "host"}, "cpu")
    for leaf in td.state["groups"][g]["dc"].values():
        leaf.copy_(torch.zeros(tuple(leaf.shape), dtype=leaf.dtype))
    assert td.load_checkpoint(path)
    assert not _state_mismatches(full_tree(td.state, "cpu"), before)
