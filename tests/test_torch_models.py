"""PyTorch port, ops/agc.py, models/linear.py's SSB path and the wide part
of models/spectrum.py against the JAX package on the CPU (the PLL, envelope
and stereo paths and the other demodulators: test_torch_demods.py)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ka9q_radio_tpu.models import linear as jlin
from ka9q_radio_tpu.models import spectrum as jspec
from ka9q_radio_tpu.ops import agc as jagc
from ka9q_radio_tpu_torch.models import linear as tlin
from ka9q_radio_tpu_torch.models import spectrum as tspec
from ka9q_radio_tpu_torch.ops import agc as tagc
from ka9q_radio_tpu_torch.ops import windows as twin

torch.set_num_threads(2)

RATE, BLOCKTIME, OLEN = 8_000, 0.02, 160


def _to_np(tree):
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    return tree.numpy() if torch.is_tensor(tree) else np.asarray(tree)


def _assert_tree_close(got, want, rtol, atol=0.0):
    got, want = _to_np(got), _to_np(jax.device_get(want))
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], rtol, atol)
        elif want[k].dtype.kind in "biu":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol, err_msg=k)


def _demod_params(C: int, rng) -> dict:
    """Per-channel linear params over every AGC and squelch branch."""
    return {
        "agc_enable": np.arange(C) % 5 != 0,
        "headroom": np.full(C, 10 ** (-15 / 20), np.float32),
        "hangtime_samples": np.full(C, int(1.1 * RATE), np.int32),
        "recovery_per_sample": np.full(C, 10 ** (20 / 20 / RATE), np.float32),
        "threshold": np.full(C, 10 ** (-15 / 20), np.float32),
        "bandwidth": rng.uniform(2000, 3000, C).astype(np.float32),
        "manual_gain": np.full(C, 10 ** (50 / 20), np.float32),
        "shift_inc_q32": np.where(np.arange(C) % 3 == 0, 12_345_678, 0).astype(np.int32),
        "squelch_open": np.full(C, 10 ** 0.8, np.float32),
        "squelch_close": np.full(C, 10 ** 0.7, np.float32),
        "squelch_tail": np.full(C, 1, np.int32),
        "snr_squelch_enable": np.arange(C) % 4 != 1,
        "pll_square": np.zeros(C, bool),
        "pll_loop_bw": np.full(C, 10.0, np.float32),
        "dc_tau": np.zeros(C, np.float32),
    }


def _blocks(C: int, nblocks: int, seed: int):
    """Baseband blocks whose levels span silence to overload, with bursts."""
    rng = np.random.default_rng(seed)
    amp = np.logspace(-6, 0.5, C)[:, None]
    out = []
    for b in range(nblocks):
        x = amp * (rng.standard_normal((C, OLEN)) + 1j * rng.standard_normal((C, OLEN)))
        if b == 2:
            x[::7, 40:60] *= 100.0  # 2 ms peaks
        out.append(x.astype(np.complex64))
    n0 = (amp[:, 0] ** 2 / 4000.0).astype(np.float32)
    return out, n0


# A decision margin this close to 1 sits on its threshold: which side a
# channel lands on then depends on each library's rounding.
EDGE = 1e-4
BRANCHES = ("peak", "strong", "noise", "hang", "recover")


def agc_margins(gain, bb, bb_power, n0, headroom, threshold, bandwidth, blocktime=BLOCKTIME):
    """The three decision margins of agc_block (ops/agc.py:80-82), in float64:
    peak*gain/(sqrt2*headroom), ampl*gain/headroom and
    bn*gain/(threshold*headroom), as rows of a [3, C] array. A margin above 1
    takes its branch."""
    bb = np.asarray(bb).astype(np.complex128)
    C, N = bb.shape
    power = bb.real ** 2 + bb.imag ** 2
    sps = min(max(int(round(N * 0.002 / blocktime)), 1), N)
    ns = max(N // sps, 1)
    peak = np.sqrt(power[:, : ns * sps].reshape(C, ns, sps).mean(-1).max(-1))
    ampl = np.sqrt(np.asarray(bb_power, np.float64))
    bn = np.sqrt(np.asarray(bandwidth, np.float64) * np.maximum(np.asarray(n0, np.float64), 0.0))
    g = np.asarray(gain, np.float64)
    hr = np.asarray(headroom, np.float64)
    return np.stack([peak * g / (np.sqrt(2.0) * hr), ampl * g / hr,
                     bn * g / (np.asarray(threshold, np.float64) * hr)])


def agc_branch(margins, hang, enable):
    """Index into BRANCHES of each channel's decision; -1 where AGC is off."""
    m = margins > 1.0
    br = np.where(m[0], 0, np.where(m[1], 1, np.where(m[2], 2, np.where(hang > 0, 3, 4))))
    return np.where(enable, br, -1)


def agc_on_edge(margins, enable):
    """Channels with AGC on and a margin within EDGE of 1."""
    return (np.abs(margins - 1.0) <= EDGE).any(0) & enable


def hang_outcomes(hang, hangtime_samples, N: int, samprate: int):
    """[C, 4]: the hangcount each branch gives (peak, strong, noise or
    recover, hang)."""
    hang = np.asarray(hang)
    return np.stack([np.full_like(hang, round(0.08 * samprate)),
                     np.asarray(hangtime_samples, hang.dtype), hang, np.maximum(hang - N, 0)], -1)


def assert_agc_held(t_agc, j_agc, prev_hang, edge, margins, hangtime_samples, N, samprate,
                    rtol=2e-5):
    """The port's carried AGC state against JAX's after one block started from
    the same state: exact hangcount and gain at `rtol` off the thresholds; on
    a threshold, gain at rtol 1e-3 and a hangcount that some branch gives.
    No channel may sit on the peak threshold, where the two sides' gains part
    by design (an instant clamp against a ramp)."""
    t_agc, j_agc = _to_np(t_agc), _to_np(jax.device_get(j_agc))
    held = ~edge
    assert not (edge & (np.abs(margins[0] - 1.0) <= EDGE)).any(), "a channel on the peak threshold"
    np.testing.assert_array_equal(t_agc["hangcount"][held], j_agc["hangcount"][held])
    np.testing.assert_allclose(t_agc["gain"][held], j_agc["gain"][held], rtol=rtol)
    if edge.any():
        outs = hang_outcomes(prev_hang, hangtime_samples, N, samprate)[edge]
        assert (outs == t_agc["hangcount"][edge][:, None]).any(-1).all()
        np.testing.assert_allclose(t_agc["gain"][edge], j_agc["gain"][edge], rtol=1e-3)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _assert_rows_close(got, want, edge, rtol):
    """Rows off the thresholds within rtol of the whole array's peak, rows on
    one within 1e-3 of their own."""
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got[~edge] - want[~edge]).max(initial=0.0) <= rtol * scale
    for r in np.nonzero(edge)[0]:
        assert np.abs(got[r] - want[r]).max() <= 1e-3 * max(np.abs(want[r]).max(), 1e-30), r


def test_agc_block_matches_jax():
    """Four blocks, each of the port's started from JAX's state of the previous
    block, so a decision that flips cannot carry on. Held as in
    test_linear_demod_matches_jax: exact off the thresholds, rtol 1e-3 on
    them (only the noise threshold, under an eighth of the channel-blocks)."""
    C = 64
    rng = np.random.default_rng(0)
    p = _demod_params(C, rng)
    blocks, n0 = _blocks(C, 4, 1)
    js = jagc.agc_init(C, 20.0)
    _assert_tree_close(tagc.agc_init(C, 20.0, device="cpu"), js, rtol=0)
    kw = dict(headroom=p["headroom"], hangtime_samples=p["hangtime_samples"],
              recovery_per_sample=p["recovery_per_sample"], threshold=p["threshold"],
              bandwidth=p["bandwidth"])
    jagc_block = jax.jit(lambda s, bb, pw, n: jagc.agc_block(
        s, bb, pw, n, enable=jnp.asarray(p["agc_enable"]), samprate=RATE, blocktime=BLOCKTIME,
        **{k: jnp.asarray(v) for k, v in kw.items()}))
    n_edge = 0
    for bb in blocks:
        pw = (bb.real ** 2 + bb.imag ** 2).mean(-1).astype(np.float32)
        prev = jax.device_get(js)
        m = agc_margins(prev["gain"], bb, pw, n0, p["headroom"], p["threshold"], p["bandwidth"])
        edge = agc_on_edge(m, p["agc_enable"])
        n_edge += int(edge.sum())
        assert (np.abs(m[2, edge] - 1.0) <= EDGE).all(), "an edge other than the noise threshold"
        js, jr = jagc_block(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, tr = tagc.agc_block(_tensors(prev), torch.from_numpy(bb), torch.from_numpy(pw),
                                torch.from_numpy(n0), enable=torch.from_numpy(p["agc_enable"]),
                                samprate=RATE, blocktime=BLOCKTIME,
                                **{k: torch.from_numpy(v) for k, v in kw.items()})
        assert_agc_held(ts, js, prev["hangcount"], edge, m, p["hangtime_samples"], OLEN, RATE)
        jr = np.asarray(jr)
        np.testing.assert_allclose(tr.numpy()[~edge], jr[~edge], rtol=2e-5)
        np.testing.assert_allclose(tr.numpy()[edge], jr[edge], rtol=1e-3)
    assert n_edge <= C * len(blocks) // 8, n_edge


def test_linear_demod_matches_jax():
    """Five blocks: audio, state and readouts. Each block of the port starts
    from JAX's state of the previous block (converted to tensors), so one
    flipped decision cannot carry into later blocks.

    The AGC builds knife edges of its own: after a noise-branch ramp the
    gain is threshold*headroom/bn (ops/agc.py:65), so with a steady n0 the
    next block's `bn*gain > threshold*headroom` (:60) compares two numbers
    equal up to rounding, and torch and XLA round pow() differently. So the
    three decision margins are computed from JAX's state before each block:
    on every channel whose margins all lie more than 1e-4 from 1, hangcount,
    gain and audio are held at the usual bounds; the few others at rtol 1e-3
    (hangcount to a value some branch gives). On these inputs every channel
    on a threshold is on the noise one, right after a noise ramp, and they are
    under an eighth of the channel-blocks. Every branch (peak, strong, noise,
    hang, recover) occurs on channels held exactly."""
    C = 64
    rng = np.random.default_rng(2)
    p = _demod_params(C, rng)
    blocks, n0 = _blocks(C, 5, 3)
    js = jlin.linear_init(C)
    _assert_tree_close(tlin.linear_init(C, device="cpu"), js, rtol=0)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    step = jax.jit(lambda s, bb, pw, n: jlin.linear_demod(s, bb, pw, n, jp, samprate=RATE,
                                                          blocktime=BLOCKTIME))
    seen, n_edge = set(), 0
    for bb in blocks:
        pw = (bb.real ** 2 + bb.imag ** 2).mean(-1).astype(np.float32)
        prev = jax.device_get(js)
        m = agc_margins(prev["agc"]["gain"], bb, pw, n0, p["headroom"], p["threshold"],
                        p["bandwidth"])
        edge = agc_on_edge(m, p["agc_enable"])
        n_edge += int(edge.sum())
        assert (np.abs(m[2, edge] - 1.0) <= EDGE).all(), "an edge other than the noise threshold"
        br = agc_branch(m, prev["agc"]["hangcount"], p["agc_enable"])
        seen |= {BRANCHES[b] for b in br[~edge] if b >= 0}
        js, ja, ji = step(js, jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0))
        ts, ta, ti = tlin.linear_demod(_tensors(prev), torch.from_numpy(bb), torch.from_numpy(pw),
                                       torch.from_numpy(n0), tp, samprate=RATE,
                                       blocktime=BLOCKTIME)
        assert_agc_held(ts.pop("agc"), js["agc"], prev["agc"]["hangcount"], edge, m,
                        p["hangtime_samples"], OLEN, RATE)
        _assert_tree_close(ts, {k: v for k, v in js.items() if k != "agc"}, rtol=2e-5)
        _assert_rows_close(ta.numpy(), np.asarray(ja), edge, 5e-5)
        for k in ("gain", "output_power"):
            got, want = ti.pop(k).numpy(), np.asarray(ji[k])
            np.testing.assert_allclose(got[~edge], want[~edge], rtol=2e-5, err_msg=k)
            np.testing.assert_allclose(got[edge], want[edge], rtol=1e-3, err_msg=k)
        _assert_tree_close(ti, {k: v for k, v in ji.items() if k not in ("gain", "output_power")},
                           rtol=2e-5)
    assert set(BRANCHES) <= seen, seen
    assert n_edge <= C * len(blocks) // 8, n_edge
    assert (np.asarray(ji["squelch_state"]) > 0).any() and (np.asarray(ji["squelch_state"]) == 0).any()


def test_agc_thresholds_same_branch():
    """One channel on each side of each AGC threshold, at a margin of
    1 +- 1e-3: both packages take the same branch, the one the margin names.
    A steady tone of amplitude a makes peak = ampl = a; the gain sets the
    margin. Pairs: the peak threshold (below it the strong branch), the
    strong one (below it the hang branch) and the noise one (below it the
    hang branch); the last pair starts with no hang count (below it the
    recover branch)."""
    hr = thr = np.float32(10 ** (-15 / 20))
    bw = np.float32(2500.0)
    sides = np.array([1e-3, -1e-3] * 4)
    a = np.array([0.1, 0.1, 0.1, 0.1, 1e-3, 1e-3, 1e-3, 1e-3])
    gain = np.empty(8)
    gain[0:2] = (1 + sides[0:2]) * np.sqrt(2.0) * hr / a[0:2]
    gain[2:4] = (1 + sides[2:4]) * hr / a[2:4]
    gain[4:8] = 1.0
    # bn = sqrt(bw * n0) puts the noise margin at 1 +- 1e-3 for the last pairs
    n0 = np.zeros(8)
    n0[4:8] = ((1 + sides[4:8]) * thr * hr) ** 2 / bw
    hang = np.array([1000] * 6 + [0, 0], np.int32)
    want = ["peak", "strong", "strong", "hang", "noise", "hang", "noise", "recover"]
    t = np.arange(OLEN)
    bb = (a[:, None] * np.exp(2j * np.pi * 0.05 * t)).astype(np.complex64)
    pw = (a ** 2).astype(np.float32)
    gain, n0 = gain.astype(np.float32), n0.astype(np.float32)
    m = agc_margins(gain, bb, pw, n0, np.full(8, hr), np.full(8, thr), np.full(8, bw))
    assert (np.abs(np.abs(m - 1.0)[[0, 0, 1, 1, 2, 2, 2, 2], range(8)] - 1e-3) < 1e-5).all()
    assert [BRANCHES[b] for b in agc_branch(m, hang, np.ones(8, bool))] == want
    kw = dict(headroom=np.full(8, hr), hangtime_samples=np.full(8, 8800, np.int32),
              recovery_per_sample=np.full(8, 10 ** (20 / 20 / RATE), np.float32),
              threshold=np.full(8, thr), bandwidth=np.full(8, bw))
    js, _ = jagc.agc_block({"gain": jnp.asarray(gain), "hangcount": jnp.asarray(hang)},
                           jnp.asarray(bb), jnp.asarray(pw), jnp.asarray(n0),
                           enable=jnp.ones(8, bool), samprate=RATE, blocktime=BLOCKTIME,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    ts, _ = tagc.agc_block({"gain": torch.from_numpy(gain), "hangcount": torch.from_numpy(hang)},
                           torch.from_numpy(bb), torch.from_numpy(pw), torch.from_numpy(n0),
                           enable=torch.ones(8, dtype=torch.bool), samprate=RATE,
                           blocktime=BLOCKTIME, **{k: torch.from_numpy(v) for k, v in kw.items()})
    # the branch each took, read off its new hang count and gain
    outcome = {"peak": round(0.08 * RATE), "strong": 8800, "hang": 1000 - OLEN}
    for name, st in (("jax", jax.device_get(js)), ("torch", _to_np(ts))):
        for i, w in enumerate(want):
            h, g = int(st["hangcount"][i]), float(st["gain"][i])
            if w in outcome:
                assert h == outcome[w], (name, i, w, h)
            elif w == "noise":
                assert h == hang[i] and g < gain[i], (name, i, w, h, g)
            else:
                assert h == 0 and g > gain[i], (name, i, w, h, g)
    np.testing.assert_array_equal(_to_np(ts)["hangcount"], np.asarray(js["hangcount"]))


@pytest.mark.parametrize("kind,param", [("kaiser", 7.0), ("hann", None), ("blackman_harris", None),
                                        ("gaussian", 0.4), ("hp5ft", None)])
def test_windows_equal(kind, param):
    from ka9q_radio_tpu.ops import windows as jwin

    np.testing.assert_array_equal(twin.make_window(kind, 513, param),
                                  jwin.make_window(kind, 513, param))
    w = twin.make_window(kind, 513, param)
    assert twin.window_noise_bandwidth(w) == jwin.window_noise_bandwidth(w)


@pytest.mark.parametrize("real", [True, False])
def test_wide_spectrum_matches_jax(real):
    """The first block runs the warm-up loop (a boxcar over its first 10 of
    40 frames, then the EMA), later blocks the steady closed form; then the
    per-channel slices."""
    fs, L = 2_048_000.0, 40_960
    jg = jspec.wide_geometry(fs, L, real, 2_000.0, fft_avg=10)
    tg = tspec.wide_geometry(fs, L, real, 2_000.0, fft_avg=10)
    assert jg.mxu is None, "small geometry keeps JAX on its FFT, not the matmul cascade"
    assert (tg.fft_n, tg.hop, tg.frames_per_block, tg.carry, tg.bins) == (
        jg.fft_n, jg.hop, jg.frames_per_block, jg.carry, jg.bins)
    np.testing.assert_array_equal(tg.window, jg.window)
    assert tg.noise_bw == jg.noise_bw
    rng = np.random.default_rng(4)
    js, ts = jspec.wide_init(jg), tspec.wide_init(tg, device="cpu")
    consts = tspec.wide_constants(tg, device="cpu")
    frames = 0
    shifts = np.array([-20_000, -3, 0, 7, 12_345, 25_599, 25_600], np.int32)
    acc = jax.jit(lambda s, b: jspec.wide_accumulate(s, b, jg))
    for _ in range(3):
        x = rng.standard_normal(L).astype(np.float32)
        if not real:
            x = (x + 1j * rng.standard_normal(L)).astype(np.complex64)
        js, jp = acc(js, jnp.asarray(x))
        ts, tp = tspec.wide_accumulate(ts, torch.from_numpy(x), tg, consts, frames)
        frames += tg.frames_per_block
        jp = np.array(jp)
        np.testing.assert_allclose(tp.numpy(), jp, rtol=2e-4, atol=1e-6 * jp.max())
        assert int(ts["frames"]) == int(js["frames"]) == frames
        np.testing.assert_array_equal(ts["carry"].numpy(), np.asarray(js["carry"]))
        jb = np.asarray(jspec.wide_extract(jnp.asarray(jp), jnp.asarray(shifts), 51_200, jg, 32))
        tb = tspec.wide_extract(torch.from_numpy(jp), torch.from_numpy(shifts), 51_200, tg, 32)
        np.testing.assert_array_equal(tb.numpy(), jb)
