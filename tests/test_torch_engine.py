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


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _assert_same_tree(got, want, rtol=0.0, path=""):
    assert sorted(got) == sorted(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_same_tree(got[k], want[k], rtol, f"{path}/{k}")
            continue
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, f"{path}/{k}"
        if rtol == 0.0 or w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=f"{path}/{k}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=f"{path}/{k}")


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
def test_later_slices_raise(kw):
    spec = trt.GroupSpec(name="g", samprate=8_000, channels=(trt.ChannelSpec(freq=3e5),), **kw)
    with pytest.raises(NotImplementedError, match="later slice"):
        trt.Engine(samprate=FS, real=True, groups=[spec], device="cpu")


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the JAX
    package, and no source of the port names them."""
    pkg = ROOT / "ka9q_radio_tpu_torch"
    mods = sorted("ka9q_radio_tpu_torch." + ".".join(p.relative_to(pkg).with_suffix("").parts)
                  for p in pkg.rglob("*.py") if p.name != "__init__.py")
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
              " or n == 'ka9q_radio_tpu' or n.startswith('ka9q_radio_tpu.')]\n"
              "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    imp = re.compile(r"^\s*(import|from)\s+(jax|ka9q_radio_tpu)(\.|\s|$)", re.M)
    for src in [*pkg.rglob("*.py"), ROOT / "chip_smoke.py"]:
        assert not imp.search(src.read_text()), src
