"""PyTorch port, the whole slice: Engine.step against the JAX engine on the
CPU, the carry-over of params and state, retunes in place, the CUDA default
and the import guard."""
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu_torch.models import linear as tlin
from ka9q_radio_tpu_torch.ops import agc as tagc
from test_torch_models import agc_margins, agc_on_edge, assert_agc_held
from torch_parity import assert_outputs_close
from torch_parity import assert_same_tree as _assert_same_tree
from torch_parity import tree_np as _tree_np
from torch_scenes import CFS, demod_block, demod_groups, stereo_phase

torch.set_num_threads(2)

FS = 2_048_000
FREQS = np.linspace(0.05 * FS, 0.45 * FS, 64)
SWEEP = np.linspace(0.1 * FS, 0.4 * FS, 4)
ROOT = Path(__file__).resolve().parents[1]


def _groups(rt):
    """A small rx888: 64 SSB channels at 8 kHz with SNR squelch on a real
    2.048 Msps master, plus a 4-channel wide sweep."""
    return [
        rt.GroupSpec(name="hf", demod="linear", samprate=8_000, snr_squelch=True,
                     channels=tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                                    for f in FREQS)),
        rt.GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0,
                     bin_count=32, channels=tuple(rt.ChannelSpec(freq=float(f)) for f in SWEEP)),
    ]


def _block(b: int, L: int, rng) -> np.ndarray:
    """Carriers 700 Hz above every 8th channel's dial, over white noise."""
    t = np.arange(b * L, (b + 1) * L) / FS
    x = 0.01 * rng.standard_normal(L)
    for i, f in enumerate(FREQS[::8]):
        x += (0.05 + 0.05 * i) * np.cos(2 * np.pi * (f + 700.0) * t)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def engines():
    je = jrt.Engine(samprate=FS, real=True, groups=_groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=FS, real=True, groups=_groups(trt), device="cpu")
    return je, te


def test_init_params_and_state_equal_jax(engines):
    """The port builds the JAX engine's params and state, key by key, value
    for value."""
    je, te = engines
    _assert_same_tree(_tree_np(te.init_params()), jax.device_get(je.init_params()))
    ts = te.init_state()
    assert ts.pop("host") == {"jobnum": 0, "groups": {"hf": {"warmup": 2, "frames": 0},
                                                      "sweep": {"warmup": 2, "frames": 0}}}
    _assert_same_tree(_tree_np(ts), jax.device_get(je.init_state()))


def test_slice_matches_jax_engine(monkeypatch):
    """Six blocks (two warm-up, the N0 cadence at block 4) with a retune
    before block 3, both engines from the same carried-over params and
    state. Bounds: audio 5e-4 of its peak, N0 rtol 2e-4, sweep rtol 2e-4.

    The two master FFT libraries round differently, so a window bin lying
    within ~1e-7 of the 1.5 q cut can fall on the other side of it, a
    ~0.5% step in that channel's N0; this seed's scene has no such bin (the
    estimator itself is held exact on equal energies in test_torch_noise).

    The AGC's decisions can sit on their thresholds by construction (a
    steady N0 between cadence blocks after a noise ramp, a steady carrier
    after a strong ramp): each block the port's AGC starts from JAX's AGC
    state, and its carried AGC state is held as in
    test_torch_models.test_linear_demod_matches_jax, from the margins of
    the baseband the port's AGC saw."""
    seen = {}

    def agc_spy(state, bb, bb_power, n0, **kw):
        seen["m"] = agc_margins(state["gain"].numpy(), bb.numpy(), bb_power.numpy(), n0.numpy(),
                                kw["headroom"].numpy(), kw["threshold"].numpy(),
                                kw["bandwidth"].numpy(), kw["blocktime"])
        seen["enable"] = kw["enable"].numpy()
        return tagc.agc_block(state, bb, bb_power, n0, **kw)

    monkeypatch.setattr(tlin, "agc_block", agc_spy)
    je = jrt.Engine(samprate=FS, real=True, groups=_groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=FS, real=True, groups=_groups(trt), device="cpu")
    g = te.groups["hf"]
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    ts = trt.state_from_jax(jax.device_get(js), device="cpu")
    step = jax.jit(je.step)
    rng = np.random.default_rng(11)
    for b in range(6):
        if b == 3:
            jp = je.retune(jp, "hf", 8, float(FREQS[8]) - 400.0)
            tp = te.retune(tp, "hf", 8, float(FREQS[8]) - 400.0)
            _assert_same_tree(_tree_np(tp), jax.device_get(jp))
        x = _block(b, te.L, rng)
        prev_agc = jax.device_get(js["groups"]["hf"]["demod"]["agc"])
        ts["groups"]["hf"]["demod"]["agc"] = {k: torch.from_numpy(np.array(v))
                                              for k, v in prev_agc.items()}
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(x))
        edge = agc_on_edge(seen["m"], seen["enable"])
        assert_agc_held(ts["groups"]["hf"]["demod"]["agc"], js["groups"]["hf"]["demod"]["agc"],
                        prev_agc["hangcount"], edge, seen["m"],
                        g.host["demod"]["hangtime_samples"], g.olen, g.spec.samprate,
                        rtol=2e-4)
        jo = jax.device_get(jo)
        ja, ta = jo["hf"]["audio"], to["hf"]["audio"].numpy()
        assert np.abs(ja).max() > 0.01
        assert np.abs(ta - ja).max() < 5e-4 * np.abs(ja).max(), b
        np.testing.assert_allclose(to["hf"]["info"]["n0"].numpy(), jo["hf"]["info"]["n0"],
                                   rtol=2e-4)
        np.testing.assert_array_equal(to["hf"]["info"]["squelch_state"].numpy(),
                                      jo["hf"]["info"]["squelch_state"])
        np.testing.assert_allclose(to["sweep"]["info"]["bin_data"].numpy(),
                                   jo["sweep"]["info"]["bin_data"], rtol=2e-4)
        np.testing.assert_allclose(to["_frontend"]["if_power"].numpy(),
                                   jo["_frontend"]["if_power"], rtol=1e-5)
    # carried state: phase words and counters exact, the rest to rounding
    assert ts.pop("host") == {"jobnum": 6, "groups": {"hf": {"warmup": 0, "frames": 0},
                                                      "sweep": {"warmup": 2, "frames": 6 * 20}}}
    js = jax.device_get(js)
    np.testing.assert_array_equal(ts["groups"]["hf"]["dc"]["acc_q32"].numpy(),
                                  js["groups"]["hf"]["dc"]["acc_q32"])
    np.testing.assert_array_equal(ts["master"]["tail"].numpy(), js["master"]["tail"])
    del ts["groups"]["hf"]["demod"]["agc"], js["groups"]["hf"]["demod"]["agc"]  # held above
    _assert_same_tree(_tree_np(ts), js, rtol=2e-4)
    # the retuned channel hears its carrier 400 Hz higher
    a = to["hf"]["audio"][8].numpy()
    f = np.fft.rfftfreq(a.size, 1 / 8_000)[np.argmax(np.abs(np.fft.rfft(a * np.hanning(a.size))))]
    assert abs(f - 1100.0) < 50.0


def test_carry_mid_run_matches_jax(engines):
    """State carried over after five JAX blocks (warm-up over, the sweep in
    its steady closed form, the block counter off the cadence) continues
    in the port as in JAX for four more blocks, the N0 cadence's block 8
    among them."""
    je, te = engines
    jp, js = je.init_params(), je.init_state()
    step = jax.jit(je.step)
    rng = np.random.default_rng(12)
    for b in range(5):
        js, _ = step(js, jp, jnp.asarray(_block(b, te.L, rng)))
    ts = trt.state_from_jax(jax.device_get(js), device="cpu")
    assert ts["host"] == {"jobnum": 5, "groups": {"hf": {"warmup": 0, "frames": 0},
                                                  "sweep": {"warmup": 2, "frames": 100}}}
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    for b in range(5, 9):
        x = _block(b, te.L, rng)
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(x))
        jo = jax.device_get(jo)
        ja = jo["hf"]["audio"]
        assert np.abs(to["hf"]["audio"].numpy() - ja).max() < 5e-4 * np.abs(ja).max()
        np.testing.assert_allclose(to["hf"]["info"]["n0"].numpy(), jo["hf"]["info"]["n0"],
                                   rtol=2e-4)
        np.testing.assert_allclose(to["sweep"]["info"]["bin_data"].numpy(),
                                   jo["sweep"]["info"]["bin_data"], rtol=2e-4)


def test_retune_writes_rows_in_place(engines):
    """A retune writes the channel's row into the existing tensors and
    leaves every other row and every tensor object as it was."""
    _, te = engines
    p = te.init_params()
    before = {k: (v.data_ptr(), v.clone()) for k, v in p["hf"].items() if torch.is_tensor(v)}
    out = te.retune(p, "hf", 5, float(FREQS[5]) + 12_345.0)
    assert out is p
    changed = set()
    for k, (ptr, old) in before.items():
        assert p["hf"][k].data_ptr() == ptr, k
        rows = torch.nonzero((p["hf"][k] != old).reshape(old.shape[0], -1).any(-1)).flatten()
        assert set(rows.tolist()) <= {5}, k
        if rows.numel():
            changed.add(k)
    assert {"shifts", "inc_q32", "resp_tiles", "tile_lo"} <= changed
    te.retune(p, "hf", 5, float(FREQS[5]))
    for k, (_, old) in before.items():
        assert torch.equal(p["hf"][k], old), k


def test_disarmed_sweep_costs_nothing(engines):
    je, te = engines
    p, s = te.init_params(), te.init_state()
    te.set_armed(p, "sweep", False)
    s2, out = te.step(s, p, torch.zeros(te.L))
    assert not out["sweep"]["info"]["bin_data"].any()
    assert s2["groups"]["sweep"] is s["groups"]["sweep"]
    te.set_armed(p, "sweep", True)


def test_engine_defaults_to_cuda():
    """Without `device` the engine runs on CUDA, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        trt.Engine(samprate=FS, real=True, groups=_groups(trt))


@pytest.mark.parametrize("kw", [dict(demod="fm"), dict(demod="wfm"), dict(demod="am"),
                                dict(demod="linear", filter2=1), dict(demod="spectrum",
                                                                      bin_bw=100.0)])
def test_each_group_kind_steps(kw):
    """Each group kind that earlier slices refused builds on the CPU and
    steps once, with finite output of its shape."""
    spec = trt.GroupSpec(name="g", samprate=8_000, channels=(trt.ChannelSpec(freq=3e5),), **kw)
    eng = trt.Engine(samprate=FS, real=True, groups=[spec], device="cpu")
    g = eng.groups["g"]
    st, out = eng.step(eng.init_state(), eng.init_params(),
                       torch.from_numpy(_block(0, eng.L, np.random.default_rng(0))))
    audio, info = out["g"]["audio"], out["g"]["info"]
    want = {"fm": (1, g.olen), "wfm": (1, 960, 2), "linear": (1, g.olen),
            "spectrum": (1, 0)}[g.spec.demod]
    assert tuple(audio.shape) == want and torch.isfinite(audio).all()
    if g.spec.demod == "spectrum":
        assert tuple(info["bin_data"].shape) == (1, 64)
        assert st["host"]["groups"]["g"]["frames"] == g.spectrum_geo.frames_per_block
    if g.f2_N:
        assert tuple(st["groups"]["g"]["dc"]["tail2"].shape) == (1, g.f2_M - 1)


def test_every_demod_matches_jax_engine():
    """Every demodulator through Engine.step on a complex master: params and
    state carried over from the JAX engine after two blocks (the master's
    turn-on), then four blocks, each of the port's started from JAX's state
    through state_from_jax. A filter2 redesign (set_edges with its own
    Kaiser beta) before the third. Bounds: audio 5e-4 of each group's peak
    (the AGC's strong-threshold edge moves a linear group's gain by ~1e-5,
    ROADMAP Queue 3), N0 and spectrum bins rtol 2e-4, flags and counters
    exact."""
    je = jrt.Engine(samprate=CFS, real=False, groups=demod_groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=CFS, real=False, groups=demod_groups(trt), device="cpu")
    assert te.groups["wfm"].tile_E is None and te.groups["cwu"].f2_N == 512
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    _assert_same_tree(_tree_np(te.init_params()), jax.device_get(jp))
    tinit = te.init_state()
    tinit.pop("host")
    _assert_same_tree(_tree_np(tinit), jax.device_get(js))
    step = jax.jit(je.step)
    rng = np.random.default_rng(13)
    for b in range(6):
        x = demod_block(b, te.L, rng)
        if b == 3:
            jp = je.set_edges(jp, "cwu", 0, -300.0, 300.0, None, 6.0)
            tp = te.set_edges(tp, "cwu", 0, -300.0, 300.0, None, 6.0)
            _assert_same_tree(_tree_np(tp), jax.device_get(jp))
        ts = trt.state_from_jax(jax.device_get(js), device="cpu")
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(x))
        if b < 2:
            continue
        jo = jax.device_get(jo)
        assert_outputs_close(to, jo, where=f"block {b}")
        assert bool(jo["wfm"]["info"]["stereo"][0]) and bool(to["wfm"]["info"]["stereo"][0])
    # the ISB channel: the tone above the dial in one column, below in the other
    a = to["isb"]["audio"][0].numpy()
    pw = [np.abs(np.fft.rfft(a[:, c] * np.hanning(a.shape[0]))) for c in (0, 1)]
    f = np.fft.rfftfreq(a.shape[0], 1 / 12_000)
    assert {round(f[np.argmax(pw[0])], -2), round(f[np.argmax(pw[1])], -2)} == {1000.0, 1500.0}
    ts = trt.state_from_jax(jax.device_get(js), device="cpu")
    assert ts["host"]["groups"]["spec"]["frames"] == 6 * te.groups["spec"].spectrum_geo.frames_per_block


def test_migrate_state_and_adopt_carry_new_demods():
    """A rebuilt channel table keeps each surviving group's leading rows of
    the filter2 tail and of the FM, WFM, PLL and narrowband spectrum state,
    and its commands' host params, the filter2 responses included."""
    def groups(n):
        return [g if g.name not in ("fm", "cwu") else
                dataclasses.replace(g, channels=g.channels + tuple(
                    dataclasses.replace(g.channels[-1], freq=g.channels[-1].freq + 30e3 * (i + 1))
                    for i in range(n)))
                for g in demod_groups(trt)]

    import dataclasses

    old = trt.Engine(samprate=CFS, real=False, groups=groups(0), device="cpu")
    p = old.init_params()
    old.set_edges(p, "cwu", 0, -250.0, 250.0, None, 5.0)
    st = old.init_state()
    rng = np.random.default_rng(14)
    for b in range(3):
        st, _ = old.step(st, p, torch.from_numpy(demod_block(b, old.L, rng)))
    new = trt.Engine(samprate=CFS, real=False, groups=groups(2), device="cpu")
    st2 = trt.migrate_state(st, new.init_state())
    fresh = new.init_state()
    assert st2["host"] == st["host"]
    for name, keys in (("cwu", ["dc/tail2", "demod/agc/gain"]),
                       ("fm", ["dc/acc_q32", "demod/phase_memory", "demod/goertzel/s0",
                               "demod/pl_count", "demod/tone_mute"]),
                       ("wfm", ["demod/tail", "demod/stereo_deemph"]),
                       ("sam", ["demod/pll/vco_phase", "demod/pll_lock_count"]),
                       ("spec", ["demod/carry", "demod/power", "demod/frames"])):
        for key in keys:
            o, n, f = st["groups"][name], st2["groups"][name], fresh["groups"][name]
            for part in key.split("/"):
                o, n, f = o[part], n[part], f[part]
            C = o.shape[0] if o.dim() else 0
            assert torch.equal(n[:C] if C else n, o), (name, key)
            if n.dim() and n.shape[0] > C:
                assert torch.equal(n[C:], f[C:]), (name, key)
    p2 = new.adopt_host_params(old)
    g_old, g_new = old.groups["cwu"], new.groups["cwu"]
    np.testing.assert_array_equal(g_new.host["responses2"][0], g_old.host["responses2"][0])
    np.testing.assert_array_equal(p2["cwu"]["responses2"][0].numpy(), g_old.host["responses2"][0])
    st3, out = new.step(st2, p2, torch.from_numpy(demod_block(3, new.L, rng)))
    assert all(torch.isfinite(o["audio"]).all() for n, o in out.items() if n != "_frontend")


@pytest.mark.parametrize("demod", ["iq", "wfm"])
def test_stereo_egress_compaction_matches_jax(demod):
    """Egress compaction of [C, N, 2] audio (I/Q stereo, WFM): four
    channels with SNR squelch, two carrying a signal (a tone 700 Hz above
    the dial; for WFM a stereo composite), into two slots; over eight
    blocks, each from JAX's state, the rows, egress_idx and egress_count as
    in the JAX engine (a third channel's closing tail holds a slot until
    block 5) and, from block 2, the audio within 5e-4 of its peak."""
    wide = demod == "wfm"
    f = [150e3, -250e3, 350e3, -400e3] if wide else [50e3, 60e3, 70e3, 80e3]

    def groups(rt):
        bw = 100e3 if wide else 5000.0
        return [rt.GroupSpec(name="g", demod=demod, samprate=384_000 if wide else 12_000,
                             snr_squelch=True, egress_slots=2, channels=tuple(
                                 rt.ChannelSpec(freq=x, low=-bw, high=bw) for x in f))]

    je = jrt.Engine(samprate=CFS, real=False, groups=groups(jrt), fft="monolithic")
    te = trt.Engine(samprate=CFS, real=False, groups=groups(trt), device="cpu")
    jp, js = je.init_params(), je.init_state()
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    step = jax.jit(je.step)
    rng = np.random.default_rng(15)
    for b in range(8):
        ts = trt.state_from_jax(jax.device_get(js), device="cpu")
        t = np.arange(b * te.L, (b + 1) * te.L) / CFS
        x = 1e-3 * (rng.standard_normal(te.L) + 1j * rng.standard_normal(te.L))
        for c in (1, 3):
            x += 0.1 * np.exp(1j * (2 * np.pi * f[c] * t + stereo_phase(t)) if wide
                              else 2j * np.pi * (f[c] + 700.0) * t)
        x = x.astype(np.complex64)
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(x))
        jo = jax.device_get(jo)["g"]
        ji, ti = jo["info"], to["g"]["info"]
        np.testing.assert_array_equal(ti["egress_idx"].numpy(), ji["egress_idx"])
        assert int(ti["egress_count"]) == int(ji["egress_count"])
        ja, ta = jo["audio"], to["g"]["audio"].numpy()
        assert ta.shape == ja.shape == (2, te.groups["g"].olen if not wide else 960, 2)
        if b >= 2:  # after the master's and the composite stage's turn-on
            assert np.abs(ta - ja).max() <= 5e-4 * max(np.abs(ja).max(), 1e-30), b
    np.testing.assert_array_equal(ti["egress_idx"].numpy(), [1, 3])


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX
    package, and no source of the port names them (nor chip_smoke.py, the
    port's churn soak and ingest bench, or its multi-process test worker)."""
    pkg = ROOT / "ka9q_radio_tpu_torch"
    mods = sorted("ka9q_radio_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
                  for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import runpy\nrunpy.run_path('tools/bench_ingest_torch.py', run_name='scan')\n"
            + "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
              " or n == 'ka9q_radio_tpu' or n.startswith('ka9q_radio_tpu.')]\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    imp = re.compile(r"^\s*(import|from)\s+(jax|ka9q_radio_tpu)(\.|\s|$)", re.M)
    tools = [ROOT / "tools" / "churn_soak_torch.py", ROOT / "tools" / "bench_ingest_torch.py"]
    for src in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py", *tools,
                ROOT / "tests" / "torch_multihost_worker.py"]:
        assert not imp.search(src.read_text()), src
