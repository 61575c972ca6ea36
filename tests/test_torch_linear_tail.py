"""PyTorch port, the linear tail's route and counters on the CPU.

A linear group without PLL, envelope, stereo or filter2 (usb, lsb, a cw
offset) runs its tail on the card as one kernel (ops/cuda_tail.py,
csrc/linear_tail.cu); every other group, and every group on the CPU, runs
the plain chain. Here, without a card:
  (a) the route: which presets take the kernel on CUDA, and none on the CPU;
  (b) the wrapper's CPU path is the chain: a group forced onto the fused
      route gives the chain's outputs and carried state bit for bit, with
      the same keys, dtypes and shapes;
  (c) Radiod.tail_counts(): the channel-blocks of linear groups and of those
      on the fused route, under GraphStep(emulate=True) and at time-shards
      = 8.
On the card the kernel's launches are counted in `launches["linear_tail"]`,
graph replays included (tests/test_torch_cuda.py, chip_smoke.py).
The kernel itself is held against its plain version on the card
(tests/test_torch_cuda.py).
"""
import numpy as np
import pytest
import torch

import ka9q_radio_tpu_torch.runtime as trt
from ka9q_radio_tpu_torch.config import load_config
from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops.cuda_tail import cuda_linear_tail, linear_tail_plain
from ka9q_radio_tpu_torch.runtime.engine import takes_fused_tail
from ka9q_radio_tpu_torch.runtime.graphs import GraphStep
from ka9q_radio_tpu_torch.runtime.radiod import Radiod

CUDA, CPU = torch.device("cuda"), torch.device("cpu")

_ONE = """
[global]
hardware = gen
[gen]
device = sig_gen
samprate = 1m024
complex = yes
[ch]
mode = {mode}
freq = 100k0
{extra}
"""

# mode, extra section keys -> whether the group takes the kernel on CUDA
ROUTES = {
    "usb": ("usb", "", True),
    "lsb": ("lsb", "", True),
    "wspr": ("wspr", "", True),  # usb with the AGC off and a fixed gain
    "cw": ("usb", "shift = 500\nlow = -200\nhigh = 200", True),  # a cw offset, no filter2
    "usb-snr-squelch": ("usb", "snr-squelch = yes", True),
    "cwu": ("cwu", "", False),  # filter2
    "cwl": ("cwl", "", False),
    "isb": ("isb", "", False),  # filter2 and stereo
    "am": ("am", "", False),  # envelope
    "amsq": ("amsq", "", False),
    "nam": ("nam", "", False),
    "sam": ("sam", "", False),  # PLL
    "ame": ("ame", "", False),
    "dsb": ("dsb", "", False),  # the squaring PLL
    "iq": ("iq", "", False),  # stereo
    "fm": ("fm", "", False),
    "nfm": ("nfm", "", False),
    "pm": ("pm", "", False),
    "wfm": ("wfm", "", False),
    "spectrum": ("spectrum", "", False),
}


@pytest.mark.parametrize("name", list(ROUTES))
def test_fused_tail_route(name):
    """usb, lsb, wspr and a cw offset without filter2 take the kernel on
    CUDA; filter2 (cwu, cwl, isb), envelope, PLL and stereo linear groups
    and every other demodulator keep the chain; on the CPU nothing does."""
    mode, extra, fused = ROUTES[name]
    (spec,) = load_config(_ONE.format(mode=mode, extra=extra)).groups
    assert takes_fused_tail(spec, CUDA) == fused
    assert takes_fused_tail(spec, "cuda:0") == fused
    assert not takes_fused_tail(spec, CPU)
    if name == "cw":
        assert spec.channels[0].shift_hz == 500.0 and spec.channels[0].low == -200.0


def _groups():
    """usb with SNR squelch, a cw offset, wspr (AGC off), am (the chain),
    nfm (not linear)."""
    ch = trt.ChannelSpec
    f = np.linspace(60e3, 440e3, 17)
    return [
        trt.GroupSpec(name="usb", demod="linear", samprate=12_000, snr_squelch=True,
                      channels=tuple(ch(freq=float(x), low=50.0, high=3000.0) for x in f[:6])),
        trt.GroupSpec(name="cw", demod="linear", samprate=12_000, hangtime_s=0.2,
                      channels=tuple(ch(freq=float(x), low=-200.0, high=200.0, shift_hz=500.0)
                                     for x in f[6:9])),
        trt.GroupSpec(name="wspr", demod="linear", samprate=12_000, agc=False, gain_db=60.0,
                      channels=tuple(ch(freq=float(x), low=50.0, high=3000.0) for x in f[9:13])),
        trt.GroupSpec(name="am", demod="am", samprate=12_000,
                      channels=tuple(ch(freq=float(x)) for x in f[13:15])),
        trt.GroupSpec(name="nfm", demod="fm", samprate=24_000,
                      channels=tuple(ch(freq=float(x), low=-6250.0, high=6250.0)
                                     for x in f[15:])),
    ]


def _force_route(groups) -> None:
    """Put each group on the route it takes on the card: on the CPU the
    wrapper then runs its plain version."""
    for g in groups.values():
        g.fused_tail = takes_fused_tail(g.spec, CUDA)


def _assert_same(a, b, where) -> None:
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}/{k}")
    elif torch.is_tensor(a):
        assert a.shape == b.shape and a.dtype == b.dtype, where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("seed", [3, 4])
def test_fused_route_on_cpu_equals_chain(seed):
    """Engine.step with usb, cw and wspr on the fused route (the wrapper's
    CPU path) against the chain, eight blocks of a noisy scene with tones
    from the same start: outputs and carried state bit for bit, the same
    keys, dtypes and shapes, and no kernel launched."""
    fs = 1_024_000
    ef = trt.Engine(fs, _groups(), real=False, device="cpu")
    ec = trt.Engine(fs, _groups(), real=False, device="cpu")
    _force_route(ef.groups)
    assert [n for n, g in ef.groups.items() if g.fused_tail] == ["usb", "cw", "wspr"]
    assert not any(g.fused_tail for g in ec.groups.values())
    sf, pf, sc, pc = ef.init_state(), ef.init_params(), ec.init_state(), ec.init_params()
    rng = np.random.default_rng(seed)
    t = np.arange(ef.L) / fs
    for b in range(8):
        tones = sum(a * np.exp(2j * np.pi * f * (t + b * ef.L / fs))
                    for a, f in ((0.05, 61_500.0), (0.2, 108_100.0), (0.01, 250_700.0)))
        x = (tones + 1e-3 * (rng.standard_normal(ef.L) + 1j * rng.standard_normal(ef.L))
             ).astype(np.complex64)
        before = dict(tcc.launches)
        sf, of = ef.step(sf, pf, torch.from_numpy(x))
        assert tcc.launches == before
        sc, oc = ec.step(sc, pc, torch.from_numpy(x))
        _assert_same(of, oc, f"block {b} outputs")
        _assert_same({k: v for k, v in sf.items() if k != "host"},
                     {k: v for k, v in sc.items() if k != "host"}, f"block {b} state")
    assert float(of["usb"]["audio"].abs().max()) > 0  # the tones were heard


@pytest.mark.parametrize("C,N,blocktime", [(7, 240, 0.02), (5, 96, 0.008), (3, 33, 0.02)])
def test_cpu_wrapper_is_the_chain(C, N, blocktime):
    """cuda_linear_tail given CPU tensors returns linear_tail_plain's
    outputs, and those are fine_tune, the mean |bb|^2 and linear_demod's bit
    for bit, on rows with every AGC and squelch setting mixed."""
    from ka9q_radio_tpu_torch.models.linear import linear_demod, linear_init
    from ka9q_radio_tpu_torch.ops.filterbank import fine_tune

    g = torch.Generator().manual_seed(C * N)
    bb = torch.complex(torch.randn(C, N, generator=g), torch.randn(C, N, generator=g))
    i32 = lambda: torch.randint(-2**31, 2**31 - 1, (C,), generator=g,  # noqa: E731
                                dtype=torch.int32)
    flag = lambda: torch.rand(C, generator=g) < 0.5  # noqa: E731
    acc, inc, adj = i32(), i32(), i32()
    n0 = torch.rand(C, generator=g) * 1e-3
    st = linear_init(C)
    st["agc"]["gain"] = torch.rand(C, generator=g) * 2
    st["agc"]["hangcount"] = torch.randint(0, 3000, (C,), generator=g, dtype=torch.int32)
    st["squelch_state"] = torch.randint(0, 6, (C,), generator=g, dtype=torch.int32)
    st["squelch_open"] = flag()
    st["am_dc"] = torch.rand(C, generator=g)
    st["shift_acc"] = i32()
    p = {"agc_enable": flag(), "headroom": torch.full((C,), 0.178), "hangtime_samples":
         torch.full((C,), 13_200, dtype=torch.int32), "recovery_per_sample":
         torch.full((C,), 1.0002), "threshold": torch.full((C,), 0.178), "bandwidth":
         torch.full((C,), 2950.0), "manual_gain": torch.rand(C, generator=g) * 1e3,
         "shift_inc_q32": torch.where(flag(), i32(), 0), "squelch_open": torch.full((C,), 6.3),
         "squelch_close": torch.full((C,), 5.0), "squelch_tail": torch.ones(C, dtype=torch.int32),
         "snr_squelch_enable": flag()}
    kw = dict(samprate=int(round(N / blocktime)), blocktime=blocktime)
    keys = ("acc", "pw", "st", "audio", "info")
    got = dict(zip(keys, cuda_linear_tail(bb, acc, inc, adj, n0, st, p, **kw)))
    _assert_same(got, dict(zip(keys, linear_tail_plain(bb, acc, inc, adj, n0, st, p, **kw))),
                 "plain")
    tuned, acc2 = fine_tune(bb, acc, inc, adj)
    pw = (tuned.real * tuned.real + tuned.imag * tuned.imag).mean(-1)
    st2, audio, info = linear_demod(st, tuned, pw, n0, p, **kw)
    _assert_same(got, dict(zip(keys, (acc2, pw, st2, audio, info))), "chain")


RD_CONF = """
[global]
hardware = gen
status = 127.0.0.1
data = 127.0.0.1
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
snr-squelch = yes

[wspr]
mode = wspr
freq = 200k0 210k0 220k0

[am]
mode = am
freq = 300k0 310k0

[nfm]
mode = nfm
freq = 400k0
"""


@pytest.mark.parametrize("opts,fused", [("", True), ("", False), ("time-shards = 8", True),
                                        ("time-shards = 8", False)])
def test_tail_counts(opts, fused):
    """Radiod.tail_counts() under GraphStep(emulate=True), one block and 8
    blocks a dispatch: each block emitted counts the C rows of every linear
    group (usb 6, wspr 3, am 2; not nfm), and of those on the fused route
    (usb and wspr, forced as on the card; none on the CPU's own route)."""
    rd = Radiod(load_config(RD_CONF.format(opts=opts)), use_network=False, device="cpu")
    D = rd._time_shards or 1
    assert D == (8 if opts else 1)
    rd.step = rd._stepper = GraphStep(rd.engine, rd._time_shards, emulate=True)
    if fused:
        _force_route(rd.engine.groups)
    assert rd.tail_counts() == {"blocks": 0, "linear_rows": 0, "fused_rows": 0}
    for n in range(1, 4):
        rd.step_block()
        assert rd.tail_counts() == {"blocks": n * D, "linear_rows": n * D * 11,
                                    "fused_rows": n * D * (9 if fused else 0)}
    assert rd._stepper.graph_stats()["dispatch"] == "emulated"
