"""Shared fixtures of the benchmark's own tests: the harness's modules on the
path, a small configuration that the CPU runs at 2.048 Msps (the same
channel geometry as the cells: n 300, olen 240 at 12 kHz; n 600 at 24 kHz),
its complex twin (an I/Q stream around a tuner's centre, a group of two
rails), and the `card` fixture that skips a test where no CUDA card is seen."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL_TEXT = """[global]
sap = no
advertise = no
hardware = fe
status = 127.0.0.1:{status}
data = 127.0.0.1:{data}
mode = usb
time-shards = 2
egress-slots = 16
update = 2000
[fe]
device = external
samprate = 2m048
real = yes
[hf]
mode = usb
samprate = 12k
raster = 100k 400k 1k815
snr-squelch = yes
[WSPR]
data = 127.0.0.1:{data:WSPR}
mode = wspr
freq = "474k200 636k600"
[10m-FM]
mode = nfm
samprate = 24k
freq = "500k 560k"
"""
_USB = {"demod": "linear", "samprate": 12000, "low": 50.0, "high": 3000.0, "agc": True,
        "snr_squelch": False}
SMALL_CFG = {
    "name": "small", "text": SMALL_TEXT,
    "reference": {"samprate": "2m048", "real": True, "time_shards": 2, "groups": [
        dict(_USB, name="hf", raster=["100k", "400k", "1k815"], snr_squelch=True),
        dict(_USB, name="wspr", agc=False, gain_db=60.0, freq=["474k200", "636k600"]),
        {"name": "10m-fm", "demod": "fm", "samprate": 24000, "low": -6250.0, "high": 6250.0,
         "freq": ["500k", "560k"]}]}}
SMALL_WL = {
    "config": "small", "loop": "flat", "ring_blocks": 8, "warmup_dispatches": 2,
    "trace_dispatches": 2, "noise": {"dbfs_per_hz": -138.0},
    "tones": [{"group": "hf", "select": {"strata": 8}, "dbfs": -80.0, "offset_hz": [1400.0, 1600.0]},
              {"group": "wspr", "select": "all", "dbfs": [-90.0, -70.0], "offset_hz": [300.0, 2700.0]}],
    "fm": [{"group": "10m-fm", "select": "all", "dbfs": -66.0, "tone_hz": 1000.0,
            "deviation_hz": 2500.0}],
    "compare": [{"group": "hf", "select": {"tones": 4}}, {"group": "wspr"}, {"group": "10m-fm"}]}
SMALL_BENCH = {"end_to_end": [{"name": "wall_capacity_x", "unit": "x"}, {"name": "setup_s", "unit": "s"}],
               "per_layer": []}

# a complex A/D stream: 2.048 Msps I/Q tuned to 10 MHz, USB channels at
# signed offsets of -600 to +800 kHz and two I/Q channels (two rails)
COMPLEX_TEXT = """[global]
sap = no
advertise = no
hardware = fe
status = 127.0.0.1:{status}
data = 127.0.0.1:{data}
mode = usb
time-shards = 2
update = 2000
[fe]
device = external
samprate = 2m048
real = no
frequency = 10m
[usb]
mode = usb
samprate = 12k
freq = "9m4 9m7 9m95 10m05 10m3 10m8"
snr-squelch = yes
[iq]
data = 127.0.0.1:{data:iq}
mode = iq
freq = "9m85 10m15"
"""
COMPLEX_CFG = {
    "name": "complex", "text": COMPLEX_TEXT,
    "reference": {"samprate": "2m048", "real": False, "frequency": "10m", "time_shards": 2,
                  "groups": [
                      dict(_USB, name="usb", snr_squelch=True,
                           freq=["9m4", "9m7", "9m95", "10m05", "10m3", "10m8"]),
                      dict(_USB, name="iq", low=-5000.0, high=5000.0, stereo=True,
                           freq=["9m85", "10m15"])]}}
COMPLEX_WL = {
    "config": "complex", "loop": "flat", "ring_blocks": 8, "warmup_dispatches": 2,
    "trace_dispatches": 2, "noise": {"dbfs_per_hz": -138.0},
    "tones": [{"group": "usb", "select": {"strata": 4}, "dbfs": -80.0,
               "offset_hz": [1400.0, 1600.0]},
              {"group": "iq", "select": "all", "dbfs": [-66.0, -56.0],
               "offset_hz": [-2500.0, 2500.0]}],
    "compare": [{"group": "usb", "select": {"tones": 4}}, {"group": "iq"}]}


@pytest.fixture
def card():
    """Skip where no CUDA card is seen (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the port on CUDA")
    return torch.device("cuda")
