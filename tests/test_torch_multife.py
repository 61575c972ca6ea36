"""PyTorch port, several front ends on one engine (Engine(n_inputs=B), radiod
with several [hardware] sections), against the JAX package and against B
single-input engines on the CPU: the cases of tests/test_multife.py."""
import numpy as np
import jax
import pytest
import torch

import ka9q_radio_tpu.runtime as jrt
import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu.config import load_config as jload
from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
from ka9q_radio_tpu_torch.config import load_config as tload
from ka9q_radio_tpu_torch.net.status import StatusType as T
from ka9q_radio_tpu_torch.net.status import PacketType, decode_status, encode_status
from ka9q_radio_tpu_torch.runtime.radiod import Radiod as TRadiod
from test_torch_radiod import assert_same_sent
from torch_parity import step_against_jax
from torch_scenes import CFS, TWO_FE, multi_blocks, multi_chans, two_fe_blocks

torch.set_num_threads(2)


def _chans(rt, n: int = 4):
    return tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)
                 for f in np.linspace(-400e3, 400e3, n))


def _run(eng, blocks):
    s, p = eng.init_state(), eng.init_params()
    for x in blocks:
        s, out = eng.step(s, p, torch.from_numpy(np.ascontiguousarray(x)))
    return s, out


def _run_recording(eng, blocks):
    """_run, keeping each block's master spectra as eng's master FFT gave
    them (before the spur notch, which works on its own copy)."""
    spectra, master_step = [], eng.master_step

    def recording(mstate, block):
        mstate, F = master_step(mstate, block)
        spectra.append(F.clone())
        return mstate, F

    eng.master_step = recording
    try:
        s, out = _run(eng, blocks)
    finally:
        del eng.master_step
    return s, out, spectra


def _run_on(eng, blocks, spectra):
    """_run, with eng's master spectra replaced block by block by `spectra`:
    a single-input reference then sees the very transform the engine of
    several inputs computed. A batched CPU FFT ([B, N]) and B single ones
    differ by a few 1e-4 (absolute, on unit-variance input) with the batch
    and the thread count, which would move N0 by more than its 1e-5."""
    feed, master_step = iter(spectra), eng.master_step

    def fed(mstate, block):
        mstate, _ = master_step(mstate, block)
        return mstate, next(feed).clone()

    eng.master_step = fed
    try:
        return _run(eng, blocks)
    finally:
        del eng.master_step


def _assert_matches_single(out, name, rows, single_out, single_name):
    """A multi-input engine's rows against a single-input engine's group:
    audio rtol 2e-5 / atol 2e-6, N0 rtol 1e-5 (tests/test_multife.py's bounds)."""
    np.testing.assert_allclose(out[name]["audio"][rows].numpy(),
                               single_out[single_name]["audio"].numpy(), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(out[name]["info"]["n0"][rows].numpy(),
                               single_out[single_name]["info"]["n0"].numpy(), rtol=1e-5)


def test_multi_input_matches_single_and_jax():
    """A 3-input engine, one group per input, spur notches on every input:
    each group as a single-input engine fed its stream alone (and its row of
    the batched master spectrum), and the whole engine as JAX's, block by
    block; per-input IF power is [3]."""
    def groups(rt):
        return [rt.GroupSpec(name=f"lin{b}", demod="linear", samprate=16_000,
                             channels=_chans(rt), input=b) for b in range(3)]

    te = trt.Engine(samprate=CFS, real=False, groups=groups(trt), n_inputs=3, spurs=[100e3],
                    device="cpu")
    je = jrt.Engine(samprate=CFS, real=False, groups=groups(jrt), n_inputs=3, spurs=[100e3],
                    fft="monolithic")
    blocks = multi_blocks(6, 3, te.L, seed=1)
    st, out, spectra = _run_recording(te, blocks)
    assert tuple(st["master"]["tail"].shape) == (3, te.master.M - 1)
    assert tuple(st["spurs"].shape) == (3, len(te.spur_bins))
    assert tuple(out["_frontend"]["if_power"].shape) == (3,)
    for b in range(3):
        e1 = trt.Engine(samprate=CFS, real=False, spurs=[100e3], device="cpu", groups=[
            trt.GroupSpec(name=f"lin{b}", demod="linear", samprate=16_000, channels=_chans(trt))])
        _, o1 = _run_on(e1, blocks[:, b], [F[b, :e1.master.bins] for F in spectra])
        _assert_matches_single(out, f"lin{b}", slice(None), o1, f"lin{b}")
    step_against_jax(je, te, blocks)


@pytest.mark.parametrize("real", [False, True])
def test_one_group_spanning_inputs(real):
    """ONE group whose channels span three inputs (ChannelSpec.input): on a
    complex master (the per-input offset in the gathers), and on a real one
    (2.048 Msps: m_bins 25,601 is odd, so each input's row is padded to
    whole tiles for kernel A's and B's loads) with every input's twin of a
    carrier channel. Each input's rows equal a single-input engine's fed
    that input's row of the batched master spectrum; the whole engine equals
    JAX's; only the carrier's own input hears it."""
    B, per = 3, 4
    fs = 2_048_000 if real else CFS
    if real:
        freqs = np.linspace(0.05 * fs, 0.45 * fs, per)
        chans = lambda rt: tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0, input=b)  # noqa: E731
                                 for b in range(B) for f in freqs)
        single = lambda rt: tuple(rt.ChannelSpec(freq=float(f), low=50.0, high=3000.0)  # noqa: E731
                                  for f in freqs)
        rng = np.random.default_rng(3)
        L = trt.Engine(samprate=fs, groups=[], device="cpu").L
        t = np.arange(6 * L).reshape(6, 1, L) / fs
        blocks = 1e-3 * rng.standard_normal((6, B, L))
        blocks[:, :1] += 0.05 * np.cos(2 * np.pi * (freqs[0] + 700.0) * t)
        blocks = blocks.astype(np.float32)
    else:
        chans, single = (lambda rt: multi_chans(rt, B, per)), _chans
        blocks = multi_blocks(6, B, trt.Engine(samprate=fs, groups=[], device="cpu",
                                               real=False).L, seed=2)
    kw = dict(samprate=fs, real=real, n_inputs=B, spurs=[100e3])
    te = trt.Engine(groups=[trt.GroupSpec(name="g", demod="linear", samprate=16_000,
                                          channels=chans(trt))], device="cpu", **kw)
    je = jrt.Engine(groups=[jrt.GroupSpec(name="g", demod="linear", samprate=16_000,
                                          channels=chans(jrt))], fft="monolithic", **kw)
    g = te.groups["g"]
    assert g.tiled and list(g.inputs) == list(np.repeat(np.arange(B), per))
    assert te.ld % 128 == 0 and (not real or te.master.bins % 2 == 1)
    _, out, spectra = _run_recording(te, blocks)
    for b in range(B):
        e1 = trt.Engine(samprate=fs, real=real, spurs=[100e3], device="cpu", groups=[
            trt.GroupSpec(name="g", demod="linear", samprate=16_000, channels=single(trt))])
        _, o1 = _run_on(e1, blocks[:, b], [F[b, :e1.master.bins] for F in spectra])
        _assert_matches_single(out, "g", slice(b * per, (b + 1) * per), o1, "g")
    to, _ = step_against_jax(je, te, blocks)
    if real:
        bbp = to["g"]["info"]["baseband_power"].numpy()
        assert bbp[0] > 100 * bbp[per] and bbp[0] > 100 * bbp[2 * per]


def test_per_input_centers_and_retune():
    """Per-input front-end centres: the same dial maps to another IF on each
    stream, as in JAX; a retune uses its channel's own centre and writes the
    row in place."""
    def groups(rt):
        return [rt.GroupSpec(name=f"lin{b}", demod="linear", samprate=16_000, input=b,
                             channels=(rt.ChannelSpec(freq=7_100_000.0, low=50.0, high=3000.0),
                                       rt.ChannelSpec(freq=7_150_000.0, low=50.0, high=3000.0,
                                                      input=1 - b)))
                for b in range(2)]

    kw = dict(samprate=CFS, real=False, n_inputs=2, center=[7_000_000.0, 7_200_000.0])
    te = trt.Engine(groups=groups(trt), device="cpu", **kw)
    je = jrt.Engine(groups=groups(jrt), fft="monolithic", **kw)
    for name in ("lin0", "lin1"):
        for k in ("shifts", "inc_q32", "adj_q32", "tile_lo", "slope"):
            np.testing.assert_array_equal(te.groups[name].host[k], je.groups[name].host[k])
        np.testing.assert_array_equal(te.groups[name].center_of, je.groups[name].center_of)
    assert te.groups["lin0"].host["shifts"][0] > 0 > te.groups["lin1"].host["shifts"][0]
    assert te.center == 7_000_000.0 and te.groups["lin1"].center == 7_200_000.0
    p = te.init_params()
    ptr = p["lin1"]["shifts"].data_ptr()
    jp = je.retune(je.init_params(), "lin1", 1, 7_060_000.0)
    te.retune(p, "lin1", 1, 7_060_000.0)
    assert p["lin1"]["shifts"].data_ptr() == ptr
    for k in ("shifts", "inc_q32", "adj_q32", "tile_lo", "slope"):
        np.testing.assert_array_equal(p["lin1"][k].numpy(), np.asarray(jp["lin1"][k]))


def _bad(rt, case):
    ch = rt.ChannelSpec
    if case == "group input":
        return dict(n_inputs=2, groups=[rt.GroupSpec(name="x", demod="linear", samprate=16_000,
                                                     channels=(ch(freq=1e5),), input=2)])
    if case == "channel input":
        return dict(n_inputs=2, groups=[rt.GroupSpec(name="x", demod="linear", samprate=16_000,
                                                     channels=(ch(freq=1e5, input=3),))])
    if case == "no inputs":
        return dict(n_inputs=0, groups=[])
    if case == "centers":
        return dict(n_inputs=2, center=[1e6, 2e6, 3e6], groups=[])
    return dict(n_inputs=2, groups=[rt.GroupSpec(
        name="x", demod="spectrum", samprate=32_000, bin_bw=1000.0, bin_count=16,
        channels=(ch(freq=1e5), ch(freq=2e5, input=1)))])


@pytest.mark.parametrize("case,match", [
    ("group input", "group x: input 2 outside the engine's 2 front-end stream"),
    ("channel input", "group x: channel input 3 outside 2 stream"),
    ("no inputs", "n_inputs=0: need at least one input"),
    ("centers", "3 centers for 2 inputs"),
    ("wide spectrum", "wideband spectrum reads the raw A/D block")])
def test_input_validation(case, match):
    """Bad input bindings raise the JAX engine's ValueError in both."""
    for rt, kw in ((jrt, {"fft": "monolithic"}), (trt, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            rt.Engine(samprate=CFS, real=False, **kw, **_bad(rt, case))


def test_radiod_two_sig_gens():
    """The two-sig_gen daemon on its own generators: each carrier
    demodulates on its own stream, the status shows each input's IF power,
    and the numbered sub-lists stripe one section across both inputs."""
    rd = TRadiod(tload(TWO_FE.format(opts="")), use_network=False, device="cpu")
    assert rd.engine.n_inputs == 2 and rd.source_state is not None
    assert [g.input for g in rd.engine.specs] == [0, 1, 0]
    assert list(rd.engine.groups["usb"].inputs) == [0, 1]
    for _ in range(10):
        out = rd.step_block()
    pa = float(out["chan-a"]["info"]["baseband_power"][0])
    pb = float(out["chan-b"]["info"]["baseband_power"][0])
    assert pa > 1e-4 and pb > 1e-6 and pa > pb * 10
    assert rd.if_power_in.shape == (2,) and rd.if_power_in[0] > rd.if_power_in[1] * 10
    for ssrc, fe in ((100, 0), (200, 1)):
        st = decode_status(rd.encode_channel_status(rd.chans[ssrc]))[1]
        assert abs(st[T.IF_POWER] - 10 * np.log10(rd.if_power_in[fe])) < 1e-3


@pytest.mark.parametrize("opts", ["", "time-shards = 2"])
def test_two_input_daemon_matches_jax(opts):
    """The same [2, L] numpy blocks into the JAX daemon and the port's (with
    time-shards = 2 the port takes [2, 2, L] dispatches: the same packets):
    the same channel table, RTP within 1 LSB and the same status, but for
    each channel's front-end fields, held to its own input."""
    jr = JRadiod(jload(TWO_FE.format(opts="")), use_network=False)
    tr = TRadiod(tload(TWO_FE.format(opts=opts)), use_network=False, device="cpu")
    assert {s: (c.group, c.idx, c.freq) for s, c in tr.chans.items()} == \
        {s: (c.group, c.idx, c.freq) for s, c in jr.chans.items()}
    D = tr._time_shards or 1
    blocks = two_fe_blocks(12 // D, tr.engine.L, 5, lead=(D,) if D > 1 else ())
    marks = []
    for x in blocks:
        tr.step_block(block=x)
        for xb in (x if D > 1 else [x]):
            jr.step_block(block=xb)
            marks.append((len(jr._sent), jr.if_power_in.copy()))
    assert tr.blocks == jr.blocks == 12
    assert_same_sent(_own_input_status(jr, tr, marks), tr._sent)
    np.testing.assert_allclose(tr.if_power_in, jr.if_power_in, rtol=1e-5)


# the status fields that describe a channel's front end: the port reports
# the channel's own input, where the JAX daemon reports input 0's for all
_FE_FIELDS = (T.IF_POWER, T.FIRST_LO_FREQUENCY)


def _own_input_status(jr, tr, marks) -> list:
    """The JAX daemon's packets with each status packet's front-end fields
    set to the channel's own input: its IF power as the JAX daemon tracked
    it after the block that sent the packet (`marks`: the count of packets
    sent and a copy of if_power_in after each block), and its input's
    first LO. Every other field stays JAX's."""
    out, m = [], 0
    for n, (kind, pkt) in enumerate(jr._sent):
        while marks[m][0] <= n:
            m += 1
        if kind == "status":
            ptype, f, _ = decode_status(pkt)
            ch = tr.chans[f[T.OUTPUT_SSRC]]
            grp = tr.engine.groups[ch.group]
            i = int(grp.inputs[ch.idx])
            f[T.IF_POWER] = 10 * np.log10(max(float(marks[m][1][i]), 1e-30))
            f[T.FIRST_LO_FREQUENCY] = float(jr.engine.centers[i])
            pkt = encode_status(f, cmd=ptype == PacketType.CMD)
        out.append((kind, pkt))
    return out


def test_status_reports_each_channels_input():
    """Two inputs at different centres ([fe1] frequency = 100k): a channel
    on fe1 reports fe1's IF power (20 dB under fe0's) and fe1's first LO.
    The JAX daemon reports input 0's first LO for every channel, and the
    group's input's IF power, fe0's for the usb group's channel on fe1."""
    conf = TWO_FE.format(opts="").replace("[fe1]\n", "[fe1]\nfrequency = 100k\n")
    rd = TRadiod(tload(conf), use_network=False, device="cpu")
    jr = JRadiod(jload(conf), use_network=False)
    for _ in range(10):
        rd.step_block()
        jr.step_block()
    p0, p1 = (10 * np.log10(rd.if_power_in[i]) for i in (0, 1))
    assert p0 - p1 > 15.0  # fe0's carrier is 20 dB stronger
    usb = rd.engine.groups["usb"]
    on_fe1 = {200: 200e3, int(next(c.ssrc for c in rd.chans.values()
                                   if c.group == "usb" and usb.inputs[c.idx] == 1)): 151e3}
    for ssrc in (100, *on_fe1):
        ch = rd.chans[ssrc]
        i = int(rd.engine.groups[ch.group].inputs[ch.idx])
        assert (i == 1) == (ssrc in on_fe1)
        st = decode_status(rd.encode_channel_status(ch))[1]
        jst = decode_status(jr.encode_channel_status(jr.chans[ssrc]))[1]
        assert abs(st[T.IF_POWER] - (p1 if i else p0)) < 1e-3, (ssrc, st[T.IF_POWER])
        assert st[T.FIRST_LO_FREQUENCY] == (100e3 if i else 0.0)
        assert st[T.RADIO_FREQUENCY] == jst[T.RADIO_FREQUENCY]
        if i:  # the JAX daemon's fault, which the port does not copy: input 0's
            # first LO for every channel, and the group's input's IF power
            # for a channel bound to another input than its group's
            assert jst[T.FIRST_LO_FREQUENCY] == 0.0
            if ssrc != 200:
                assert abs(jst[T.IF_POWER] - p0) < 0.1


def test_time_shards_with_inputs_generate_blocks():
    """time-shards = 2 with two sig_gen inputs: the generator gives [2, 2, L]
    dispatches, and the daemon's outputs equal those of single steps from
    the same generator states."""
    r2, r3 = (TRadiod(tload(TWO_FE.format(opts="time-shards = 2")), use_network=False,
                      device="cpu") for _ in range(2))
    r1 = TRadiod(tload(TWO_FE.format(opts="")), use_network=False, device="cpu")
    assert tuple(r3._siggen(r3.source_state)[1].shape) == (2, 2, r3.engine.L)
    for _ in range(3):
        r2.step_block()
        r1.step_block()
        r1.step_block()
    assert r2.blocks == r1.blocks == 6
    assert [k for k, _ in r2._sent] == [k for k, _ in r1._sent]
    for (kind, a), (_, b) in zip(r2._sent, r1._sent):
        if kind == "data":
            assert a == b


def test_checkpoint_two_sig_gens(tmp_path):
    """A checkpoint carries both generators' states: the restored daemon's
    next block equals the original's."""
    conf = TWO_FE.format(opts="")
    rd = TRadiod(tload(conf), use_network=False, device="cpu")
    for _ in range(4):
        rd.step_block()
    path = str(tmp_path / "state.npz")
    rd.save_checkpoint(path)
    before = rd.step_block()
    rd2 = TRadiod(tload(conf), use_network=False, device="cpu")
    assert rd2.load_checkpoint(path)
    after = rd2.step_block()
    for name in ("chan-a", "chan-b", "usb"):
        np.testing.assert_array_equal(before[name]["audio"], after[name]["audio"])


def test_mixed_feeders_refused():
    """sig_gen and a file feeder in one daemon raise, as in JAX."""
    conf = TWO_FE.format(opts="").replace(
        "[fe1]\ndevice = sig_gen", "[fe1]\ndevice = file\npath = /nonexistent.raw\nformat = cf32le")
    for make in (lambda c: JRadiod(jload(c), use_network=False),
                 lambda c: TRadiod(tload(c), use_network=False, device="cpu")):
        with pytest.raises(NotImplementedError, match="cannot mix sig_gen"):
            make(conf)


def test_rebuild_carries_input_state():
    """A rebuilt table of a 2-input engine (two more channels on input 1)
    keeps the [2, M-1] master tails, the [2, spurs] trackers and the
    surviving rows' state, and its commands' host params."""
    def groups(rt, extra):
        chans = multi_chans(rt, 2) + tuple(rt.ChannelSpec(freq=f, low=50.0, high=3000.0, input=1)
                                           for f in (10e3, 20e3)[:extra])
        return [rt.GroupSpec(name="g", demod="linear", samprate=16_000, channels=chans)]

    old = trt.Engine(samprate=CFS, real=False, groups=groups(trt, 0), n_inputs=2, spurs=[1e5],
                     device="cpu")
    p = old.init_params()
    old.set_edges(p, "g", 5, -200.0, 2500.0)
    st = old.init_state()
    for x in multi_blocks(3, 2, old.L, seed=9):
        st, _ = old.step(st, p, torch.from_numpy(x))
    new = trt.Engine(samprate=CFS, real=False, groups=groups(trt, 2), n_inputs=2, spurs=[1e5],
                     device="cpu")
    st2 = trt.migrate_state(st, new.init_state())
    assert torch.equal(st2["master"]["tail"], st["master"]["tail"])
    assert torch.equal(st2["spurs"], st["spurs"])
    assert torch.equal(st2["groups"]["g"]["demod"]["agc"]["gain"][:8],
                       st["groups"]["g"]["demod"]["agc"]["gain"])
    p2 = new.adopt_host_params(old)
    np.testing.assert_array_equal(p2["g"]["responses"][5].numpy(), old.groups["g"].host["responses"][5])
    assert list(new.groups["g"].inputs) == [0] * 4 + [1] * 6
    _, out = new.step(st2, p2, torch.from_numpy(multi_blocks(1, 2, new.L, seed=10)[0]))
    assert out["g"]["audio"].shape[0] == 10 and torch.isfinite(out["g"]["audio"]).all()


def test_jax_state_carries_over():
    """state_from_jax and params_from_jax take a 2-input JAX engine's [2, M-1]
    tails and [2, spurs] trackers: the port continues from JAX's block 3
    as JAX does."""
    def groups(rt):
        return [rt.GroupSpec(name="g", demod="linear", samprate=16_000,
                             channels=multi_chans(rt, 2))]

    kw = dict(samprate=CFS, real=False, n_inputs=2, spurs=[1e5])
    je = jrt.Engine(groups=groups(jrt), fft="monolithic", **kw)
    te = trt.Engine(groups=groups(trt), device="cpu", **kw)
    blocks = multi_blocks(5, 2, te.L, seed=11)
    jp, js = je.init_params(), je.init_state()
    step = jax.jit(je.step)
    for x in blocks[:3]:
        js, _ = step(js, jp, x)
    ts = trt.state_from_jax(jax.device_get(js), device="cpu")
    assert tuple(ts["master"]["tail"].shape) == (2, te.master.M - 1) and ts["host"]["jobnum"] == 3
    tp = trt.params_from_jax(jax.device_get(jp), device="cpu")
    for x in blocks[3:]:
        js, jo = step(js, jp, x)
        ts, to = te.step(ts, tp, torch.from_numpy(x))
    jo = jax.device_get(jo)
    ja = jo["g"]["audio"]
    assert np.abs(to["g"]["audio"].numpy() - ja).max() <= 5e-4 * np.abs(ja).max()
    np.testing.assert_allclose(to["g"]["info"]["n0"].numpy(), jo["g"]["info"]["n0"], rtol=2e-4)
    np.testing.assert_allclose(ts["spurs"].numpy(), np.asarray(js["spurs"]), rtol=1e-4, atol=1e-9)


def test_config_per_sublist_hardware():
    """Numbered freq sub-lists bind to different front ends (hardware0..9):
    the port's engine binds the channels as JAX's does."""
    conf = """
[global]
hardware = fe0 fe1

[fe0]
device = sig_gen
samprate = 1m024
complex = yes

[fe1]
device = sig_gen
samprate = 1m024
complex = yes

[scan]
demod = linear
samprate = 16k
freq0 = 100k 110k
hardware0 = fe0
freq1 = 200k
hardware1 = fe1
"""
    jc, tc = jload(conf), tload(conf)
    assert [c.input for c in tc.groups[0].channels] == [0, 0, 1]
    te = trt.Engine(samprate=tc.samprate, real=tc.real, groups=tc.groups, n_inputs=tc.n_inputs,
                    device="cpu")
    je = jrt.Engine(samprate=jc.samprate, real=jc.real, groups=jc.groups, n_inputs=jc.n_inputs,
                    fft="monolithic")
    np.testing.assert_array_equal(te.groups["scan"].inputs, je.groups["scan"].inputs)
