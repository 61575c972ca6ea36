"""Kernel A's choice of design, on the CPU.

(a) `channelize_plan`: the persistent design for launches of many row tiles
    whose 64-row X tile fits in shared memory, the one-shot design for the
    rest, from the shapes and the SM count alone; each group of the shipped
    deployments at an H100's 132 SMs (the flagship's 32,728 channels
    persistent; hf-generic's groups and rx888's 1,000 channels one-shot).
(b) `_Group.channelize_designs` and `Radiod.channelize_counts()`: the
    channel-blocks of the launches of kernel A and of those on the
    persistent design, with the SM count patched to 132 (the CPU runs the
    plain version and plans no persistent launch).
"""
import pytest

from ka9q_radio_tpu_torch.config import load_config
from ka9q_radio_tpu_torch.ops import cuda_channelize as tcc
from ka9q_radio_tpu_torch.ops.filterbank import MasterConfig
from ka9q_radio_tpu_torch.runtime import engine as teng
from ka9q_radio_tpu_torch.runtime.graphs import GraphStep
from ka9q_radio_tpu_torch.runtime.radiod import Radiod

H100_SMS = 132


def _group_shapes(path: str) -> dict:
    """{group name: (C, n_bins, olen)} of a shipped config, from its master
    geometry as the engine computes it."""
    cfg = load_config(path)
    m = MasterConfig.from_rate(cfg.samprate, cfg.blocktime, cfg.overlap, cfg.real)
    fs = int(round(cfg.samprate))
    return {g.name: (len(g.channels), m.N * int(g.samprate) // fs, m.L * int(g.samprate) // fs)
            for g in cfg.groups}


@pytest.mark.parametrize("path,design", [
    ("examples/radiod@rx888-wspr.conf", {"hf": "persistent"}),
    ("examples/radiod@hf-generic.conf", {"wspr": "one-shot", "ft8": "one-shot",
                                          "ft4": "one-shot", "10m-fm": "one-shot"}),
])
def test_plan_of_the_shipped_deployments(path, design):
    shapes = _group_shapes(path)
    assert set(shapes) == set(design)
    for name, (C, n, olen) in shapes.items():
        assert tcc.channelize_plan(C, tcc.fold_pad(n), olen, H100_SMS) == design[name], name
    if "hf" in shapes:
        assert shapes["hf"] == (32_728, 300, 240)
    else:
        assert {s[0] for s in shapes.values()} == {12, 10, 8, 4}


@pytest.mark.parametrize("C,n,olen,sms,design", [
    (1_000, 300, 240, H100_SMS, "one-shot"),      # rx888: 16 row tiles, one wave
    (4_000, 300, 240, H100_SMS, "persistent"),    # rx888x4
    (16_000, 300, 240, H100_SMS, "persistent"),   # rx888x16
    (32_728, 300, 240, H100_SMS, "persistent"),   # the flagship
    (32_728, 300, 240, 0, "one-shot"),            # no card
    (32_728, 600, 480, H100_SMS, "one-shot"),     # n 600: the X tile does not fit
    (32_728, 320, 256, H100_SMS, "persistent"),   # the widest fold that fits
    (32_728, 321, 256, H100_SMS, "one-shot"),
    (4, 600, 480, H100_SMS, "one-shot"),          # hf-generic's 10m-FM
])
def test_plan_cases(C, n, olen, sms, design):
    assert tcc.channelize_plan(C, tcc.fold_pad(n), olen, sms) == design


def test_plan_crossover_is_monotone():
    """Past the crossover every larger C stays persistent, below it one-shot."""
    n_pad, sms = tcc.fold_pad(300), H100_SMS
    seen = [tcc.channelize_plan(C, n_pad, 240, sms) for C in range(64, 40_000, 64)]
    first = seen.index("persistent")
    assert set(seen[:first]) == {"one-shot"} and set(seen[first:]) == {"persistent"}
    assert 1_000 < 64 * (first + 1) <= 4_000


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

[fm]
mode = nfm
freq = 400k0
"""


@pytest.mark.parametrize("opts", ["", "time-shards = 8"])
@pytest.mark.parametrize("persist_at", [None, 4])
def test_channelize_counts(monkeypatch, opts, persist_at):
    """Radiod.channelize_counts() under GraphStep(emulate=True), one block and
    8 blocks a dispatch: each block emitted counts the C of each group that
    launches kernel A (usb 6, nfm 1), and of those the plan puts on the
    persistent design: none on the CPU (0 SMs), and with 132 SMs patched in
    and the crossover lowered to `persist_at` channels, the usb group."""
    if persist_at is not None:
        monkeypatch.setattr(teng, "sm_count", lambda dev: H100_SMS)
        monkeypatch.setattr(teng, "channelize_plan",
                            lambda C, n_pad, olen, sms: "persistent" if sms and C >= persist_at
                            else "one-shot")
    rd = Radiod(load_config(RD_CONF.format(opts=opts)), use_network=False, device="cpu")
    D = rd._time_shards or 1
    rd.step = rd._stepper = GraphStep(rd.engine, rd._time_shards, emulate=True)
    assert rd.channelize_counts() == {"blocks": 0, "a_rows": 0, "persist_rows": 0}
    designs = {name: g.channelize_designs() for name, g in rd.engine.groups.items()}
    assert [c for c, _ in designs["usb"]] == [6] and [c for c, _ in designs["fm"]] == [1]
    for n in range(1, 3):
        rd.step_block()
        assert rd.channelize_counts() == {"blocks": n * D, "a_rows": n * D * 7,
                                          "persist_rows": n * D * (6 if persist_at else 0)}
