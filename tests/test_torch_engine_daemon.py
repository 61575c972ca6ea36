"""The engine's daemon-side parts in the port against the JAX engine on the
CPU, at the bounds of test_torch_engine: squelch-gated egress compaction,
spur notches, set_edges (rows written in place), adopt_host_params and
migrate_state across a grow and a shrink of a group, and the JAX engine's
keywords."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.runtime.engine import migrate_state as jmigrate
from test_torch_engine import FREQS, FS, _block, _groups
from torch_parity import assert_same_tree as _assert_same_tree
from torch_parity import tree_np as _tree_np

torch.set_num_threads(2)


def _pair(groups_fn=_groups, **kw):
    je = jrt.Engine(samprate=FS, real=True, groups=groups_fn(jrt), fft="monolithic", **kw)
    te = trt.Engine(samprate=FS, real=True, groups=groups_fn(trt), device="cpu", **kw)
    return je, te


def _carried(je):
    jp, js = je.init_params(), je.init_state()
    return (jp, js, trt.params_from_jax(jax.device_get(jp), device="cpu"),
            trt.state_from_jax(jax.device_get(js), device="cpu"))


@pytest.mark.parametrize("slots", [4, 16])
def test_egress_compaction_matches_jax(slots):
    """8 carriers over 64 channels: with 16 slots every open channel gets a
    row; with 4 the extras are dropped and egress_count says so. The index
    vector and count are exact, the compacted audio within 5e-4 of its
    peak."""
    def groups(rt):
        g = _groups(rt)
        return [dataclasses.replace(g[0], egress_slots=slots), g[1]]

    je, te = _pair(groups)
    jp, js, tp, ts = _carried(je)
    step = jax.jit(je.step)
    rng = np.random.default_rng(21)
    overflow = False
    for b in range(6):
        x = _block(b, te.L, rng)
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(x))
        ji, ti = jax.device_get(jo["hf"]["info"]), to["hf"]["info"]
        np.testing.assert_array_equal(ti["send"].numpy(), ji["send"])
        np.testing.assert_array_equal(ti["egress_idx"].numpy(), ji["egress_idx"])
        assert ti["egress_idx"].dtype == torch.int32 and ti["egress_count"].shape == ()
        assert int(ti["egress_count"]) == int(ji["egress_count"]) == int(ji["send"].sum())
        ja, ta = np.asarray(jo["hf"]["audio"]), to["hf"]["audio"].numpy()
        assert ta.shape == ja.shape == (slots, te.groups["hf"].olen)
        assert np.abs(ta - ja).max() <= 5e-4 * max(np.abs(ja).max(), 1e-30)
        overflow |= int(ji["egress_count"]) > slots
        n = min(int(ji["egress_count"]), slots)
        idx = ti["egress_idx"].numpy()
        assert (np.diff(idx[:n]) > 0).all() and (idx[n:] == -1).all()
    assert overflow == (slots == 4)


def test_spur_notches_match_jax():
    """Two spurs on carriers of the scene (and DC): the tracked bin values
    and everything downstream match JAX over six blocks."""
    spurs = [float(FREQS[8]) + 700.0, float(FREQS[16]) + 700.0]
    je, te = _pair(spurs=spurs)
    np.testing.assert_array_equal(te.spur_bins, je.spur_bins)
    jp, js, tp, ts = _carried(je)
    assert ts["spurs"].dtype == torch.complex64 and ts["spurs"].shape == (3,)
    step = jax.jit(je.step)
    rng = np.random.default_rng(22)
    for b in range(6):
        x = _block(b, te.L, rng)
        js, jo = step(js, jp, jnp.asarray(x))
        ts, to = te.step(ts, tp, torch.from_numpy(x))
        jspur = np.asarray(js["spurs"])
        np.testing.assert_allclose(ts["spurs"].numpy(), jspur, rtol=2e-4,
                                   atol=1e-6 * np.abs(jspur).max())
        ja = np.asarray(jo["hf"]["audio"])
        assert np.abs(to["hf"]["audio"].numpy() - ja).max() < 5e-4 * np.abs(ja).max()
    # the trackers follow the carriers' bins (DC carries no signal here)
    assert (np.abs(ts["spurs"].numpy()[1:]) > 100 * abs(complex(ts["spurs"][0]))).all()


def test_set_edges_matches_jax_in_place():
    """set_edges redesigns one channel's filter: the port's params equal
    JAX's, the write lands in the existing tensors, on that row only."""
    je, te = _pair()
    jp, _, tp, _ = _carried(je)
    before = {k: (v.data_ptr(), v.clone()) for k, v in tp["hf"].items() if torch.is_tensor(v)}
    bw_before = tp["hf"]["demod"]["bandwidth"].clone()
    jp = je.set_edges(jp, "hf", 5, -2400.0, -300.0, kaiser_beta=7.0)
    out = te.set_edges(tp, "hf", 5, -2400.0, -300.0, kaiser_beta=7.0)
    assert out is tp
    _assert_same_tree(_tree_np(tp), jax.device_get(jp))
    for k, (ptr, old) in before.items():
        assert tp["hf"][k].data_ptr() == ptr, k
        rows = torch.nonzero((tp["hf"][k] != old).reshape(old.shape[0], -1).any(-1)).flatten()
        assert set(rows.tolist()) <= {5}, k
    changed = torch.nonzero(tp["hf"]["demod"]["bandwidth"] != bw_before).flatten().tolist()
    assert changed == [5] and float(tp["hf"]["demod"]["bandwidth"][5]) == 2100.0


@pytest.mark.parametrize("delta", [3, -2], ids=["grow", "shrink"])
def test_adopt_and_migrate_match_jax(delta):
    """A channel table rebuilt one group larger or smaller after three
    blocks: the new engine adopts the old one's tweaked host params (a
    retune, new edges, a demod write) and migrates the carried state, host
    mirrors included; both equal JAX's, and the next blocks match JAX's."""
    je, te = _pair()
    jp, js, tp, _ = _carried(je)
    step = jax.jit(je.step)
    rng = np.random.default_rng(23)
    for b in range(3):
        js, _ = step(js, jp, jnp.asarray(_block(b, te.L, rng)))
    # the state the rebuild carries: JAX's, so the comparison sees the
    # migration alone (the N0 flips of Queue 3 cannot enter)
    ts = trt.state_from_jax(jax.device_get(js), device="cpu")
    jp = je.retune(jp, "hf", 8, float(FREQS[8]) - 400.0)
    te.retune(tp, "hf", 8, float(FREQS[8]) - 400.0)
    jp = je.set_edges(jp, "hf", 9, -3000.0, -50.0)
    te.set_edges(tp, "hf", 9, -3000.0, -50.0)
    je.groups["hf"].host["demod"]["squelch_open"][3] = np.float32(1e30)
    te.groups["hf"].set_demod(tp["hf"], 3, "squelch_open", np.float32(1e30))

    def resized(rt):
        g = _groups(rt)
        ch = g[0].channels
        ch = ch + (ch[-1],) * delta if delta > 0 else ch[:delta]
        return [dataclasses.replace(g[0], channels=ch), g[1]]

    je2 = jrt.Engine(samprate=FS, real=True, groups=resized(jrt), fft="monolithic")
    te2 = trt.Engine(samprate=FS, real=True, groups=resized(trt), device="cpu")
    jp2 = je2.adopt_host_params(je)
    tp2 = te2.adopt_host_params(te)
    _assert_same_tree(_tree_np(tp2), jax.device_get(jp2))
    js2 = jmigrate(js, je2.init_state())
    ts2 = trt.migrate_state(ts, te2.init_state())
    assert ts2.pop("host") == {"jobnum": 3, "groups": {"hf": {"warmup": 0, "frames": 0},
                                                       "sweep": {"warmup": 2, "frames": 60}}}
    js2 = jax.device_get(js2)
    np.testing.assert_array_equal(ts2["master"]["tail"].numpy(), js2["master"]["tail"])
    _assert_same_tree(_tree_np(ts2), js2, rtol=2e-4)
    C2 = len(FREQS) + delta
    assert ts2["groups"]["hf"]["dc"]["n0"].shape == (C2,)
    ts2["host"] = {"jobnum": 3, "groups": {"hf": {"warmup": 0, "frames": 0},
                                           "sweep": {"warmup": 2, "frames": 60}}}
    step2 = jax.jit(je2.step)
    for b in range(3, 5):
        x = _block(b, te.L, rng)
        js2, jo = step2(js2, jp2, jnp.asarray(x))
        ts2, to = te2.step(ts2, tp2, torch.from_numpy(x))
        ja = np.asarray(jo["hf"]["audio"])
        assert np.abs(to["hf"]["audio"].numpy() - ja).max() < 5e-4 * np.abs(ja).max()
        np.testing.assert_array_equal(to["hf"]["info"]["squelch_state"].numpy(),
                                      np.asarray(jo["hf"]["info"]["squelch_state"]))


@pytest.mark.parametrize("kw", [dict(fft="auto"), dict(fft="monolithic"),
                                dict(fft_precision="exact"), dict(fft_precision="high")])
def test_jax_engine_keywords_accepted(kw):
    te = trt.Engine(samprate=FS, real=True, groups=_groups(trt), device="cpu", **kw)
    assert te.master.N > 0


@pytest.mark.parametrize("kw,exc,match", [
    (dict(fft="mxu"), ValueError, "TPU"), (dict(fft="split"), ValueError, "TPU"),
    (dict(fft_precision="bf16"), ValueError, "TPU"), (dict(use_matmul=True), ValueError, "TPU")])
def test_tpu_mechanisms_raise(kw, exc, match):
    with pytest.raises(exc, match=match):
        trt.Engine(samprate=FS, real=True, groups=_groups(trt), device="cpu", **kw)
