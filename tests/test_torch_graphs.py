"""PyTorch port, the compiled dispatch (runtime/graphs.py) on the CPU.

GraphStep runs each dispatch as one CUDA graph replay on the card; here it
is checked without a card:
  (a) one key, one launch sequence: the ops a dispatch records (shapes and
      non-tensor arguments, each kernel wrapper as one opaque launch) are
      the same for every dispatch of one graph key, across the warm-up, the
      N0 cadence, a spectrum group's armed flag and time shards; and no op
      reads a device value back or copies host data in;
  (b) every params writer keeps every leaf's address;
  (c) the static-buffer body (emulate=True: state copied in, stepped and
      written back in place, outputs overwritten in place) equals the eager
      step bit for bit, and the JAX engine within the parity tests' bounds;
  (d) a big group's lazily fetched info keeps its dispatch's values after
      the next dispatch overwrites the graph's outputs;
  (e) on a mesh of one process (make_mesh(["cpu"] * D)): (a), (b) and (c)
      for the channel-sharded Engine.step and for step_time, the static
      state written once a distinct tensor, the JAX sharded engine on the
      conftest's virtual devices; a mesh over processes is refused, and one
      over distinct cards dispatches eagerly, counted.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu_torch.models import fm as tfm
from ka9q_radio_tpu_torch.models import linear as tlin
from ka9q_radio_tpu_torch.ops.iir import first_order_scan
from ka9q_radio_tpu_torch.runtime import engine as teng
from ka9q_radio_tpu_torch.runtime.graphs import GraphStep, stack_tree
from torch_parity import assert_outputs_close, assert_same_tree, tree_np
from torch_scenes import CFS, demod_block, demod_groups, multi_blocks, multi_chans

torch.set_num_threads(2)

FS = 2_048_000  # the small rx888's real master
HF = np.linspace(0.05 * FS, 0.45 * FS, 8)


def _sweep(rt, freqs):
    """A wide spectrum group (bin_bw 1 kHz, above the 200 Hz crossover)."""
    return rt.GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0,
                        bin_count=32, channels=tuple(rt.ChannelSpec(freq=float(f)) for f in freqs))


def _ssb(rt, name, freqs, **kw):
    return rt.GroupSpec(name=name, demod="linear", samprate=8_000, snr_squelch=True,
                        channels=tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                                       for f in freqs), **kw)


def _real_block(b: int, L: int, rng) -> np.ndarray:
    t = np.arange(b * L, (b + 1) * L) / FS
    x = 0.01 * rng.standard_normal(L)
    for i, f in enumerate(HF[::2]):
        x += (0.05 + 0.05 * i) * np.cos(2 * np.pi * (f + 700.0) * t)
    return x.astype(np.float32)


def _cplx_block(b: int, L: int, rng) -> np.ndarray:
    t = np.arange(b * L, (b + 1) * L) / CFS
    x = 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    x += 0.1 * np.exp(1j * (2 * np.pi * -100e3 * t + 2.5 * np.sin(2 * np.pi * 1000 * t)))
    return x.astype(np.complex64)


SPUR = 0.3 * FS  # a notched spur: the mesh step's tracker and digit-row notch


def _engine(config: str, rt=trt, **kw):
    """Small engines of each kind: (engine, block maker (b, rng) -> one
    block, time shards). "rx888_meshD": the rx888 engine with a spur on
    make_mesh(["cpu"] * D), channel-sharded; "rx888_meshD_ts": time-sharded
    over the D devices; "survey": NBFM beside a narrowband spectrum (rbw
    under the crossover: FFTs of its baseband, two frames a block, a frame
    warm-up of two blocks)."""
    ch = rt.ChannelSpec
    if config.startswith("rx888_mesh"):
        from ka9q_radio_tpu_torch.parallel import make_mesh

        D = int(config[len("rx888_mesh"):].split("_")[0])
        ts = config.endswith("_ts")
        eng, make, _ = _engine("rx888", rt, mesh=make_mesh(["cpu"] * D), spurs=[SPUR],
                               time_shards=D if ts else 0, **kw)
        return eng, make, D if ts else 0
    if config in ("rx888", "rx888_ts3"):
        eng = rt.Engine(samprate=FS, real=True, groups=[_ssb(rt, "hf", HF),
                                                        _sweep(rt, np.linspace(0.1, 0.4, 4) * FS)],
                        **kw)
        return eng, lambda b, rng: _real_block(b, eng.L, rng), 3 if config == "rx888_ts3" else 0
    if config == "two_inputs":
        eng = rt.Engine(samprate=CFS, real=False, n_inputs=2, groups=[
            rt.GroupSpec(name="usb", demod="linear", samprate=12_000, snr_squelch=True,
                         channels=multi_chans(rt, 2))], **kw)
        blocks = multi_blocks(32, 2, eng.L, seed=3)
        return eng, lambda b, rng: blocks[b], 0
    groups = {
        "nbfm": [rt.GroupSpec(name="nbfm", demod="fm", samprate=24_000, channels=tuple(
            ch(freq=float(f), low=-8000.0, high=8000.0) for f in np.linspace(-400e3, 400e3, 8)))],
        "wfm": [rt.GroupSpec(name="wfm", demod="wfm", samprate=384_000, channels=(
            ch(freq=-250e3, low=-100e3, high=100e3), ch(freq=250e3, low=-100e3, high=100e3)))],
        # the 2 m daemon's kinds: NBFM with CTCSS (the Goertzel kernel), SAM
        # (the PLL kernel)
        "2m": [g for g in demod_groups(rt) if g.name in ("fm", "sam")],
        "survey": [rt.GroupSpec(name="nbfm", demod="fm", samprate=24_000, channels=tuple(
            ch(freq=float(f), low=-8000.0, high=8000.0) for f in (-300e3, 300e3))),
            rt.GroupSpec(name="survey", demod="spectrum", samprate=12_000, bin_bw=100.0,
                         bin_count=64, fft_avg=4, channels=(ch(freq=100e3),))],
    }[config]
    eng = rt.Engine(samprate=CFS, real=False, groups=groups, **kw)
    return eng, lambda b, rng: _cplx_block(b, eng.L, rng), 0


def _dispatch(eng, st, p, blk, D: int):
    """One eager dispatch: a step, D of them stacked, or a time-sharded
    mesh engine's step_time."""
    if eng.time_shards:
        return eng.step_time(st, p, blk)
    if not D:
        return eng.step(st, p, blk)
    outs = []
    for d in range(D):
        st, o = eng.step(st, p, blk[d])
        outs.append(o)
    return st, stack_tree(outs)


def _blocks(make, b: int, D: int, rng) -> torch.Tensor:
    if not D:
        return torch.from_numpy(np.ascontiguousarray(make(b, rng)))
    return torch.from_numpy(np.stack([make(b * D + d, rng) for d in range(D)]))


# -- (a) one key, one launch sequence ---------------------------------------
def _desc(x):
    if torch.is_tensor(x):
        return ("T", str(x.dtype), tuple(x.shape))
    if isinstance(x, (list, tuple)):
        return tuple(_desc(v) for v in x)
    if isinstance(x, dict):
        return tuple((k, _desc(v)) for k, v in x.items())
    return repr(x)


class _Ops(TorchDispatchMode):
    """Each op's name, argument shapes and non-tensor arguments; the kernel
    wrappers are recorded as one launch each (their CPU insides are the
    plain versions, which the card does not run)."""

    def __init__(self):
        super().__init__()
        self.ops, self.paused = [], 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not self.paused:
            self.ops.append((str(func), _desc(args), _desc(kwargs or {})))
        return func(*args, **(kwargs or {}))


# ops that read a device value back to the host, or copy host data in: they
# would break a capture (or freeze a host value into it)
_FORBIDDEN = {"aten._local_scalar_dense.default", "aten.item.default", "aten.nonzero.default",
              "aten.masked_select.default", "aten.lift_fresh.default",
              "aten.lift_fresh_copy.default"}


def _kernels_opaque(monkeypatch, rec: _Ops) -> None:
    for mod, name in ((teng, "cuda_channelize"), (teng, "cuda_noise_est"),
                      (tlin, "cuda_pll_scan"), (tfm, "cuda_goertzel_block")):
        def opaque(*a, _fn=getattr(mod, name), _name=name, **k):
            rec.ops.append((f"kernel:{_name}", _desc(a), _desc(k)))
            rec.paused += 1
            try:
                return _fn(*a, **k)
            finally:
                rec.paused -= 1

        monkeypatch.setattr(mod, name, opaque)


@pytest.mark.parametrize("config", ["rx888", "nbfm", "wfm", "two_inputs", "2m", "rx888_ts3",
                                    "rx888_mesh2", "rx888_mesh3_ts", "survey"])
def test_one_key_one_launch_sequence(monkeypatch, config):
    """Dispatches from block 0 (the master's warm-up), through the N0
    cadence (noise_every 4), a retune, and for the rx888 and survey engines
    the spectrum group (the wide sweep; the narrowband survey, after its
    frame warm-up ran eagerly) disarmed for two dispatches; with time
    shards D 3, whose dispatches run through four cadence patterns
    (test_static_body_equals_eager_steps disarms the sweep there). On a
    mesh: the channel-sharded step (the corner turns, the all-gather, A and
    B once a shard) and step_time. Every two dispatches of one graph key
    record the same ops; at least three keys occur, and each but the
    warm-up's repeats."""
    eng, make, D = _engine(config, device="cpu")
    rec = _Ops()
    _kernels_opaque(monkeypatch, rec)
    gs = GraphStep(eng, D)
    p, st = eng.init_params(), eng.init_state()
    first = next(iter(eng.groups))
    seen: dict = {}
    repeats = eager = 0
    rng = np.random.default_rng(2)
    for b in range(12 if not D else 9):
        if b == 5:
            g = eng.groups[first]
            eng.retune(p, first, 0, float(g.spec.channels[0].freq) + 1000.0)
        if not D and b in (6, 8):
            for name, g in eng.groups.items():
                if g.spec.demod == "spectrum":
                    eng.set_armed(p, name, b == 8)
        key, why = gs.key(st["host"])
        blk = _blocks(make, b, D, rng)
        rec.ops = []
        with rec:
            st, _ = _dispatch(eng, st, p, blk, D)
        bad = {op for op, *_ in rec.ops if op in _FORBIDDEN}
        assert not bad, (config, b, bad)
        for op, args, _ in rec.ops:
            if op.startswith(("aten.index.", "aten.index_put")):
                assert "'torch.bool'" not in repr(args), (config, b, op)
        if key is None:
            assert why and "spectrum warm-up" in why, why
            eager += 1
            continue
        if key in seen:
            assert rec.ops == seen[key], (config, b, key)
            repeats += 1
        else:
            seen[key] = rec.ops
    assert len(seen) >= 3 and repeats >= len(seen) - 1, (config, sorted(seen), repeats)
    if config == "survey":  # the narrowband spectrum's frame warm-up and its i letter
        assert eager == 2 and {".i", "Ni"} & set(seen), (eager, sorted(seen))


def test_a_host_scalar_in_a_launch_changes_the_key(monkeypatch):
    """The sweep's first fft_avg frames weigh each frame by 1/(n+1) from
    the host's frame count: two dispatches in that warm-up record different
    scalars, and GraphStep runs them eagerly (no key), naming the reason."""
    eng, make, _ = _engine("rx888", device="cpu")
    geo = eng.groups["sweep"].wide_geo
    rec = _Ops()
    _kernels_opaque(monkeypatch, rec)
    gs = GraphStep(eng)
    p, st = eng.init_params(), eng.init_state()
    rng = np.random.default_rng(3)
    got = []
    for frames in (0, 3):
        st["host"]["groups"]["sweep"]["frames"] = frames
        key, why = gs.key(st["host"])
        assert key is None and why.startswith("sweep: spectrum warm-up")
        rec.ops = []
        with rec:
            eng.step(st, p, _blocks(make, 0, 0, rng))
        got.append(rec.ops)
    assert geo.fft_avg > 3 and got[0] != got[1]


# the keys of the first dispatches of two shipped deployments, as literals:
# the flagship (one USB group, 8 blocks a dispatch; its raster cut to 8
# channels, which the key does not read) and the station (four groups, one
# block a dispatch); N0 every 4th block, the master's warm-up 2 blocks
FIRST_KEYS = {
    "rx888-wspr": ["W/W/././N/././.", "N/./././N/././.", "N/./././N/././.",
                   "N/./././N/././."],
    "hf-generic": ["WWWW", "WWWW", "....", "....", "NNNN", "....", "....", "....", "NNNN",
                   "....", "....", "...."],
}


@pytest.mark.parametrize("name", sorted(FIRST_KEYS))
def test_first_keys_of_the_shipped_deployments(name):
    """examples/radiod@<name>.conf's daemon (its rtp front end a sig_gen):
    the keys of its first dispatches, each dispatch's host mirrors advanced
    as a replay advances them, are the pinned ones."""
    import re
    from pathlib import Path

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    text = (Path(__file__).resolve().parents[1] / "examples" / f"radiod@{name}.conf").read_text()
    text = re.sub(r"(?m)^device\s*=\s*rtp\b.*$", "device = sig_gen", text)
    text = re.sub(r"(?m)^(stream|encoding)\s*=.*$", "", text)
    text = re.sub(r"(?m)^raster\s*=.*$", "raster = 2m6 2m6145 1k815", text)
    rd = Radiod(load_config(text), use_network=False, device="cpu")
    gs, host, keys = rd._stepper, rd.state["host"], []
    for _ in FIRST_KEYS[name]:
        key, why = gs.key(host)
        assert why is None, why
        keys.append(key)
        host = gs._advance(host)
    assert keys == FIRST_KEYS[name]


# -- (b) writers keep addresses ----------------------------------------------
def _leaf_ptrs(p) -> dict:
    from ka9q_radio_tpu_torch.runtime.graphs import _flatten

    return {path: v.data_ptr() for path, v in _flatten(p) if torch.is_tensor(v)}


def _all_groups(rt, extra: int = 0):
    """Every demodulator and a wide sweep on the complex master; `extra`
    more FM channels (a rebuilt table)."""
    gs = [g for g in demod_groups(rt) if g.name != "spec"] + [_sweep(rt, [-200e3, 200e3])]
    return [dataclasses.replace(g, channels=g.channels + tuple(
        dataclasses.replace(g.channels[-1], freq=g.channels[-1].freq + 30e3 * (i + 1))
        for i in range(extra))) if g.name == "fm" else g for g in gs]


def test_writers_keep_param_addresses():
    """retune, set_edges (with filter2's stage), set_demod, set_armed and,
    on a rebuilt table, adopt_host_params write rows into the tensors the
    graphs read: every params leaf keeps its address, and the rows change."""
    eng = trt.Engine(samprate=CFS, real=False, groups=_all_groups(trt), device="cpu")
    p = eng.init_params()
    ptrs = _leaf_ptrs(p)
    shifts = p["fm"]["shifts"].clone()
    eng.retune(p, "fm", 0, 101e3)
    eng.set_edges(p, "cwu", 0, -300.0, 300.0, None, 6.0)
    eng.set_edges(p, "sam", 0, -4000.0, 4000.0)
    assert eng.groups["sam"].set_demod(p["sam"], 0, "pll_loop_bw", 20.0)
    eng.set_armed(p, "sweep", False)
    assert float(p["sweep"]["armed"]) == 0.0
    eng.set_armed(p, "sweep", True)
    assert _leaf_ptrs(p) == ptrs
    assert int(p["fm"]["shifts"][0]) != int(shifts[0]) and float(p["sam"]["demod"]["pll_loop_bw"][0]) == 20.0
    new = trt.Engine(samprate=CFS, real=False, groups=_all_groups(trt, extra=2), device="cpu")
    p2 = new.init_params()
    ptrs2 = _leaf_ptrs(p2)
    p3 = new.adopt_host_params(eng)
    assert _leaf_ptrs(p3) == ptrs2
    for key in ("shifts", "resp_tiles", "tile_lo"):
        torch.testing.assert_close(p3["fm"][key][:2], p["fm"][key], rtol=0, atol=0)
    torch.testing.assert_close(p3["cwu"]["responses2"], p["cwu"]["responses2"], rtol=0, atol=0)
    assert float(p3["sam"]["demod"]["pll_loop_bw"][0]) == 20.0


def test_graph_step_refuses_a_replaced_params_leaf():
    """A params leaf swapped for another tensor after the first dispatch
    raises, naming the leaf: the graphs read params by address."""
    eng, make, _ = _engine("rx888", device="cpu")
    gs = GraphStep(eng, emulate=True)
    p, st = eng.init_params(), eng.init_state()
    rng = np.random.default_rng(4)
    for b in range(2):  # block 0 runs eagerly (the sweep's warm-up)
        st, _ = gs(st, p, _blocks(make, b, 0, rng))
    p["hf"]["inc_q32"] = p["hf"]["inc_q32"].clone()
    with pytest.raises(ValueError, match="hf/inc_q32"):
        gs(st, p, _blocks(make, 2, 0, rng))


# -- (c) the static-buffer body ----------------------------------------------
@pytest.mark.parametrize("D", [0, 3])
def test_static_body_equals_eager_steps(D):
    """12 blocks (4 dispatches of 3 with time shards) with a retune and the
    sweep disarmed and re-armed: the emulated graph dispatch's outputs,
    carried state and host mirrors equal the eager steps' bit for bit, and
    graph_stats() accounts for every dispatch (replays, and eager blocks
    named by their reason)."""
    eng, make, _ = _engine("rx888", device="cpu")
    gs = GraphStep(eng, D, emulate=True)
    p = eng.init_params()
    se, sg = eng.init_state(), eng.init_state()
    rng = np.random.default_rng(5)
    n = 12 // max(D, 1)
    for b in range(n):
        if b == n // 3:
            eng.retune(p, "hf", 2, float(HF[2]) - 400.0)
        if b in (n // 2, n // 2 + 1):
            eng.set_armed(p, "sweep", b != n // 2)
        blk = _blocks(make, b, D, rng)
        se, oe = _dispatch(eng, se, p, blk, D)
        sg, og = gs(sg, p, blk)
        assert sg["host"] == se["host"], b
        assert_same_tree(tree_np(og), tree_np(oe))
        assert_same_tree(tree_np({k: v for k, v in sg.items() if k != "host"}),
                         tree_np({k: v for k, v in se.items() if k != "host"}))
    stats = gs.graph_stats()
    eager = sum(stats["eager_blocks"].values())
    assert stats["dispatch"] == "emulated" and stats["replays"] >= n - 2
    assert stats["replays"] * max(D, 1) + eager == 12
    assert set(stats["eager_blocks"]) <= {"sweep: spectrum warm-up (frame weights 1/(n+1))"}
    assert sum(g["replays"] for g in stats["graphs"].values()) == stats["replays"]


def test_static_body_matches_jax_engine():
    """Every demodulator and a wide sweep on the complex master through the
    emulated graph dispatch, each block from the JAX engine's state (copied
    into the static state) and from the same params: a retune before block
    5 and the sweep disarmed for blocks 7-8. Outputs within the bounds of
    the parity tests (torch_parity.assert_outputs_close: audio 5e-4 of its
    peak, info rtol 2e-4, flags and counters exact) from block 2."""
    je = jrt.Engine(samprate=CFS, real=False, groups=_all_groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=CFS, real=False, groups=_all_groups(trt), device="cpu")
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    gs = GraphStep(te, emulate=True)
    step = jax.jit(je.step)
    rng = np.random.default_rng(13)
    for b in range(12):
        if b == 5:
            jp = je.retune(jp, "fm", 1, -148e3)
            tp = te.retune(tp, "fm", 1, -148e3)
        if b in (7, 9):
            on = b == 9
            jp = {**jp, "sweep": {**jp["sweep"], "armed": jnp.float32(1.0 if on else 0.0)}}
            te.set_armed(tp, "sweep", on)
        x = demod_block(b, te.L, rng)
        ts = trt.state_from_jax(jax.device_get(js), device="cpu")
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = gs(ts, tp, torch.from_numpy(x))
        if b >= 2:
            assert_outputs_close(to, jax.device_get(jo), where=f"block {b}")
    stats = gs.graph_stats()
    assert stats["replays"] >= 9 and stats["state_copies_in"] >= 8, stats


# -- (d) lazily fetched info survives the next dispatch ----------------------
BIG_CONF = """
[global]
hardware = gen
status = 127.0.0.1
data = 127.0.0.1
big-group = 4
{opts}
[gen]
device = sig_gen
samprate = 1m024
complex = yes
carrier = 100k
amplitude = -20
noise = -70

[usb]
mode = usb
samprate = 12k
freq = 100k0 110k0 120k0 130k0 140k0 150k0
"""


@pytest.mark.parametrize("opts", ["", "time-shards = 2\n"])
def test_lazy_info_keeps_its_dispatch(opts):
    """A big group's _LazyGroupInfo, made by _fetch_out from one dispatch's
    outputs, returns that dispatch's values after a later dispatch of the
    same graph key has overwritten the outputs in place (emulated replay;
    one block and two blocks a dispatch)."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod, _LazyGroupInfo

    rd = Radiod(load_config(BIG_CONF.format(opts=opts)), use_network=False, device="cpu")
    rd.step = rd._stepper = GraphStep(rd.engine, rd._time_shards, emulate=True)
    keys, outs, vals, lazies = [], [], [], []
    for _ in range(4):
        keys.append(rd._stepper.key(rd.state["host"])[0])
        rd.source_state, blk = rd._siggen(rd.source_state)
        rd.state, out = rd.step(rd.state, rd.params, rd._to_device(blk))
        lazies.append(rd._fetch_out(out)["usb"]["info"])
        outs.append(out["usb"]["info"])
        vals.append({k: v.clone() for k, v in out["usb"]["info"].items()})
    # the first dispatch whose key a later one repeats: the later one
    # overwrote its outputs in place
    i, j = next((i, j) for i in range(4) for j in range(i + 1, 4) if keys[i] == keys[j])
    lazy = lazies[i]
    assert isinstance(lazy, _LazyGroupInfo)
    assert outs[i]["baseband_power"] is outs[j]["baseband_power"]
    assert not torch.equal(vals[i]["baseband_power"], vals[j]["baseband_power"])
    for k, v in vals[i].items():
        np.testing.assert_array_equal(lazy[k], v.numpy(), err_msg=k)


# -- what the graphs stand on --------------------------------------------------
def test_first_order_scan_fills_numbers_on_the_device():
    """A Python number for c or y0 becomes a tensor by a fill on d's device
    (no host data copied in, which a capture refuses), with the values of
    the tensor arguments."""
    d = torch.from_numpy(np.random.default_rng(6).standard_normal((3, 37)).astype(np.float32))
    rec = _Ops()
    with rec:
        got = first_order_scan(0.75, d, 0.5)
    assert not {op for op, *_ in rec.ops if op in _FORBIDDEN}
    want = first_order_scan(torch.full_like(d, 0.75), d, torch.full((3,), 0.5))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_graph_step_on_the_cpu_is_the_eager_step():
    """Without emulate, on a CPU engine GraphStep is Engine.step (or the D
    loop): the same outputs, nothing captured, graph_stats says eager."""
    eng, make, _ = _engine("rx888", device="cpu")
    gs = GraphStep(eng, 2)
    p = eng.init_params()
    rng = np.random.default_rng(7)
    blk = _blocks(make, 0, 2, rng)
    s1, o1 = gs(eng.init_state(), p, blk)
    s2, o2 = _dispatch(eng, eng.init_state(), p, blk, 2)
    assert_same_tree(tree_np(o1), tree_np(o2))
    assert gs.prepare(s1, p) == 0 and not gs.graphs
    assert gs.graph_stats()["dispatch"] == "eager"


def test_graph_step_refuses_a_mesh_engine():
    """A mesh over processes dispatches eagerly (its collectives cross the
    host through torch.distributed), so GraphStep refuses it; a mesh of
    one process it takes."""
    from ka9q_radio_tpu_torch.parallel import Mesh, make_mesh

    two = Mesh(["cpu"] * 2, ranks=[0, 1], rank=0)
    assert two.multiproc
    eng = trt.Engine(samprate=FS, real=True, groups=[_ssb(trt, "hf", HF)], mesh=two)
    with pytest.raises(ValueError, match="collectives cross the host, which a CUDA graph "
                                         "cannot hold"):
        GraphStep(eng)
    one = trt.Engine(samprate=FS, real=True, groups=[_ssb(trt, "hf", HF)],
                     mesh=make_mesh(["cpu"] * 2))
    assert GraphStep(one, emulate=True).compiled


# -- (e) a mesh of one process ---------------------------------------------------
def _full_state(st) -> dict:
    from ka9q_radio_tpu_torch.parallel.sharding import full_tree

    return tree_np(full_tree({k: v for k, v in st.items() if k != "host"}))


@pytest.mark.parametrize("D,time_shards", [(2, False), (4, False), (4, True)])
def test_mesh_static_body_equals_eager_steps(D, time_shards):
    """The emulated graph dispatch of a one-process mesh engine against its
    eager step bit for bit (outputs, the carried state made whole, host
    mirrors): Engine.step's channel-sharded path at D 2 and 4 over 12
    blocks, step_time at D 4 over 6 dispatches of 4, through the master's
    warm-up, N0 due and not due, a retune and the sweep disarmed and
    re-armed (for step_time also over the warm-up, which the sweep's own
    warm-up would otherwise run eagerly). The static state keeps one
    tensor a replicated leaf (the shards of one device share it, written
    once), the step keeps every static leaf as placed (none copied inside
    the step, and the state is copied in only after an eager dispatch),
    and graph_stats() accounts for every block."""
    from ka9q_radio_tpu_torch.parallel import Sharded
    from ka9q_radio_tpu_torch.parallel.sharding import shard_engine_tree
    from ka9q_radio_tpu_torch.runtime.graphs import _flatten

    eng, make, Dd = _engine(f"rx888_mesh{D}{'_ts' if time_shards else ''}", device="cpu")
    gs = GraphStep(eng, Dd, emulate=True)
    p = eng.init_params()
    se, sg = eng.init_state(), eng.init_state()
    rng = np.random.default_rng(15)
    n = 6 if time_shards else 12
    # step_time's D blocks a dispatch: the sweep disarmed for the first
    # (the master's warm-up as a graph) and again for the fifth
    off = (0, 4) if time_shards else (n // 2,)
    copies, bound, prev_eager = 0, False, False
    for b in range(n):
        if b == n // 3:
            eng.retune(p, "hf", 2, float(HF[2]) - 400.0)
        if b in off or b - 1 in off:
            eng.set_armed(p, "sweep", b not in off)
        blk = _blocks(make, b, Dd, rng)
        # a graph dispatch copies the state in only after an eager one
        key, _ = gs.key(sg["host"])
        copies += key is not None and bound and prev_eager
        bound, prev_eager = bound or key is not None, key is None
        se, oe = _dispatch(eng, se, p, blk, Dd)
        sg, og = gs(sg, p, blk)
        assert sg["host"] == se["host"], b
        assert_same_tree(tree_np(og), tree_np(oe))
        assert_same_tree(_full_state(sg), _full_state(se))
    leaves = _flatten(sg, skip_host=True)
    assert all(isinstance(v, Sharded) for _, v in leaves)
    assert all(len(v.distinct()) == (1 if v.dim is None else D) for _, v in leaves)
    kept = dict(_flatten(shard_engine_tree(eng, eng.mesh, sg), skip_host=True))
    assert all(kept[path] is v for path, v in leaves)
    stats = gs.graph_stats()
    eager = sum(stats["eager_blocks"].values())
    assert stats["dispatch"] == "emulated" and stats["state_copies_in"] == copies
    assert stats["replays"] * max(Dd, 1) + eager == n * max(Dd, 1)
    assert stats["replays"] >= n - 2 and len(stats["graphs"]) >= 3
    assert set(stats["eager_blocks"]) <= {"sweep: spectrum warm-up (frame weights 1/(n+1))"}


def _mesh_groups(rt):
    """_all_groups with every group's channel count doubled (a second
    channel 30 kHz above its first), so that each splits over 2 shards."""
    return [dataclasses.replace(g, channels=g.channels + tuple(
        dataclasses.replace(c, freq=c.freq + 30e3) for c in g.channels))
        if len(g.channels) % 2 else g for g in _all_groups(rt)]


def test_writers_keep_param_addresses_on_a_mesh():
    """test_writers_keep_param_addresses on a mesh of 2, shard by shard:
    retune, set_edges (with filter2's stage), set_demod, set_armed and, on
    a rebuilt table, adopt_host_params write rows into the shard tensors
    the graphs read (every shard keeps its address) and the rows change;
    a shard swapped for another tensor after the first dispatch raises,
    naming the leaf."""
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel.selftest import params_ptrs

    mesh = make_mesh(["cpu"] * 2)
    eng = trt.Engine(samprate=CFS, real=False, groups=_mesh_groups(trt), mesh=mesh)
    p = eng.init_params()
    ptrs = params_ptrs(p)
    shifts = p["fm"]["shifts"].full().clone()
    eng.retune(p, "fm", 1, 101e3)  # the row of shard 1
    eng.set_edges(p, "cwu", 1, -300.0, 300.0, None, 6.0)
    eng.set_edges(p, "sam", 0, -4000.0, 4000.0)
    assert eng.groups["sam"].set_demod(p["sam"], 1, "pll_loop_bw", 20.0)
    eng.set_armed(p, "sweep", False)
    assert float(p["sweep"]["armed"].first) == 0.0
    eng.set_armed(p, "sweep", True)
    assert params_ptrs(p) == ptrs
    assert int(p["fm"]["shifts"].full()[1]) != int(shifts[1])
    assert int(p["fm"]["shifts"].full()[0]) == int(shifts[0])
    assert float(p["sam"]["demod"]["pll_loop_bw"].shards[1][0]) == 20.0
    new = trt.Engine(samprate=CFS, real=False, groups=_mesh_groups(trt), mesh=mesh)
    p2 = new.init_params()
    ptrs2 = params_ptrs(p2)
    p3 = new.adopt_host_params(eng)
    assert params_ptrs(p3) == ptrs2
    for key in ("shifts", "resp_tiles", "tile_lo"):
        torch.testing.assert_close(p3["fm"][key].full(), p["fm"][key].full(), rtol=0, atol=0)
    torch.testing.assert_close(p3["cwu"]["responses2"].full(), p["cwu"]["responses2"].full(),
                               rtol=0, atol=0)
    gs = GraphStep(eng, emulate=True)
    st = eng.init_state()
    rng = np.random.default_rng(16)
    for b in range(2):  # block 0 runs eagerly (the sweep's warm-up)
        st, _ = gs(st, p, torch.from_numpy(demod_block(b, eng.L, rng)))
    p["fm"]["inc_q32"].shards[1] = p["fm"]["inc_q32"].shards[1].clone()
    with pytest.raises(ValueError, match="fm/inc_q32"):
        gs(st, p, torch.from_numpy(demod_block(2, eng.L, rng)))


def test_mesh_static_body_matches_jax_engine():
    """The emulated mesh body against the JAX sharded engine on 4 of the
    conftest's virtual CPU devices, the port on make_mesh(["cpu"] * 4):
    test_torch_sharded_engine's groups (8 NBFM, 8 USB with filter2) and
    spur, each block from JAX's state placed over the port's mesh (copied
    into the static state) and from the same params, a retune before
    block 4; within test_torch_sharded_engine's bounds (audio 2e-3, N0 and
    baseband power rtol 1e-3)."""
    from ka9q_radio_tpu.parallel import make_mesh as jmesh
    from ka9q_radio_tpu.parallel import shard_engine_tree as jshard
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from test_torch_sharded_engine import FS as SFS, _blocks as sblocks, _close, _groups

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jm = jmesh(jax.devices()[:4])
    je = jrt.Engine(samprate=SFS, real=True, groups=_groups(jrt, True), spurs=[20_000.0], mesh=jm)
    te = trt.Engine(samprate=SFS, real=True, groups=_groups(trt, True), spurs=[20_000.0],
                    mesh=make_mesh(["cpu"] * 4))
    jp = jshard(je, jm, je.init_params())
    js = jshard(je, jm, jax.jit(je.init_state)())
    tp = trt.params_from_jax(jax.device_get(je.init_params()), engine=te)
    gs = GraphStep(te, emulate=True)
    step = jax.jit(je.step)
    for b, x in enumerate(sblocks(te.L, True, n=8, seed=17)):
        if b == 4:
            jp = jshard(je, jm, je.retune(jax.device_get(jp), "usb", 3, 31_000.0))
            te.retune(tp, "usb", 3, 31_000.0)
        ts = trt.state_from_jax(jax.device_get(js), engine=te)
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = gs(ts, tp, torch.from_numpy(x))
        if b >= 2:
            _close(jax.device_get(jo), to)
    stats = gs.graph_stats()
    assert stats["replays"] == 8 and stats["state_copies_in"] >= 7, stats


def test_graph_step_keeps_a_mesh_over_distinct_cards_eager(monkeypatch, capsys):
    """A one-process mesh whose shards lie on two cards dispatches eagerly:
    said on stderr when the GraphStep is made, each block counted in
    graph_stats()["eager_blocks"] under a reason that names it, and nothing
    captured. (The engine is a stand-in, so the test needs no card.)"""
    from types import SimpleNamespace

    from ka9q_radio_tpu_torch.parallel import make_mesh

    mesh = make_mesh(["cuda:0", "cuda:1"])
    eng = SimpleNamespace(mesh=mesh, time_shards=0, device=torch.device("cuda", 0))
    gs = GraphStep(eng)
    assert "distinct cards" in capsys.readouterr().err
    ran = []
    monkeypatch.setattr(gs, "eager", lambda st, p, blk: ran.append(blk) or (st, {}))
    for b in range(3):
        gs({"host": {}}, {}, b)
    stats = gs.graph_stats()
    assert ran == [0, 1, 2] and not gs.compiled and stats["dispatch"] == "eager"
    assert stats["replays"] == 0 and not stats["graphs"]
    assert stats["eager_blocks"] == {
        "mesh over distinct cards (one capture across cards is unverified)": 3}


def test_gc_held_while_captures_run():
    """GraphStep's captures hold off Python's cyclic GC (a collection inside
    a capture may free a dropped graph, its pool or pinned host memory, and
    that invalidates the capture): off inside, nested or overlapping holds
    keep it off until the last ends, then it is as it was before the first."""
    import gc
    import threading

    from ka9q_radio_tpu_torch.runtime.graphs import _gc_held

    was = gc.isenabled()
    try:
        for before in (True, False):
            (gc.enable if before else gc.disable)()
            with _gc_held():
                assert not gc.isenabled()
                inner_started, release = threading.Event(), threading.Event()

                def other():
                    with _gc_held():
                        inner_started.set()
                        release.wait(5)

                t = threading.Thread(target=other)
                t.start()
                assert inner_started.wait(5)
            assert not gc.isenabled()  # the other thread's hold still runs
            release.set()
            t.join(5)
            assert gc.isenabled() == before
    finally:
        (gc.enable if was else gc.disable)()
