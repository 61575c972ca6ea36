"""bench_torch.py (the port's twin of bench.py) on the CPU: its engines
against bench.py's JAX engines, config for config; its timed body at R = 1,
K = 2 in a subprocess that imports no JAX; --matmul's refusal; and the
engine keyword behind --no-tiled, use_tiled=False, against JAX's on every
demodulator (the per-element channelizer's parity bounds: audio 5e-4 of
each group's peak, status 2e-4, flags exact)."""
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
import bench_torch  # noqa: E402
SPEC_FIELDS = ("name", "demod", "samprate", "snr_squelch", "bin_bw", "bin_count", "input")
CHAN_FIELDS = ("freq", "low", "high", "input")


@pytest.mark.parametrize("config", ["rx888", "rx888x2", "hf2000", "nbfm400", "wfm", "linear8"])
def test_build_engine_matches_bench_py(config):
    """The same groups, demods, rates, channels (freq, low, high, input) and
    spectrum geometry as bench.py's engine, exactly, and the same samprate,
    master type, input count and baseline."""
    je, jfs, jbase = bench.build_engine(config)
    te, tfs, tbase = bench_torch.build_engine(config, device="cpu")
    assert (tfs, tbase) == (jfs, jbase)
    assert (te.samprate, te.master.real, te.n_inputs, te.master.N, te.L) == \
        (je.samprate, je.master.real, je.n_inputs, je.master.N, je.L)
    assert len(te.specs) == len(je.specs)
    for tg, jg in zip(te.specs, je.specs):
        assert [getattr(tg, f) for f in SPEC_FIELDS] == [getattr(jg, f) for f in SPEC_FIELDS]
        assert len(tg.channels) == len(jg.channels)
        assert [[getattr(c, f) for f in CHAN_FIELDS] for c in tg.channels] == \
            [[getattr(c, f) for f in CHAN_FIELDS] for c in jg.channels]


def test_measure_prints_one_line_without_jax():
    """linear8 on the CPU at R = 1, K = 2 through main(): one JSON line with
    bench.py's keys and the port's, a finite rate, and neither jax nor the
    JAX package in the process."""
    code = ("import sys\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "import bench_torch\n"
            "bench_torch.main(['linear8', '--device', 'cpu'], reps=1, k=2)\n"
            "bad = [n for n in sys.modules if n.split('.')[0] in ('jax', 'ka9q_radio_tpu')]\n"
            "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd="/", capture_output=True, text=True,
                       timeout=120, env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "2"})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert {"metric", "value", "unit", "vs_baseline", "ms_per_block", "enqueue_ms_per_block",
            "card", "device"} <= set(out)
    assert out["metric"] == "linear8_input_rate" and out["unit"] == "Msps"
    assert math.isfinite(out["value"]) and out["value"] > 0 and math.isfinite(out["checksum"])
    assert out["device"] == "cpu" and out["card"] is None and out["steps"] == 12
    assert out["vs_baseline"] == pytest.approx(out["value"] / 1.024)


def test_matmul_raises():
    with pytest.raises(ValueError, match="TPU's MXU matmul channelizer"):
        bench_torch.main(["linear8", "--device", "cpu", "--matmul"], reps=1, k=1)


def test_no_tiled_runs_the_per_element_channelizer(capsys):
    bench_torch.main(["linear8", "--device", "cpu", "--no-tiled"], reps=1, k=1)
    out = json.loads(capsys.readouterr().out)
    assert out["metric"] == "linear8_notiled_input_rate" and math.isfinite(out["value"])
    eng, _, _ = bench_torch.build_engine("rx888", device="cpu", use_tiled=False)
    assert not any(g.tiled for g in eng.groups.values())
    assert bench_torch.build_engine("rx888", device="cpu")[0].groups["hf"].tiled


def test_untiled_engine_matches_jax():
    """Every demodulator on a complex 1.024 Msps master with use_tiled=False
    in both packages: six blocks, each of the port's from JAX's state."""
    from torch_parity import step_against_jax
    from torch_scenes import CFS, demod_block, demod_groups

    import ka9q_radio_tpu.runtime as jrt
    import ka9q_radio_tpu_torch.runtime as trt

    je = jrt.Engine(samprate=CFS, real=False, groups=demod_groups(jrt), fft="monolithic",
                    use_tiled=False)
    te = trt.Engine(samprate=CFS, real=False, groups=demod_groups(trt), device="cpu",
                    use_tiled=False)
    assert not any(g.tiled for g in te.groups.values())
    assert not any(g.tiled for g in je.groups.values())
    assert trt.Engine(samprate=CFS, real=False, groups=demod_groups(trt),
                      device="cpu").groups["fm"].tiled
    rng = np.random.default_rng(17)
    torch.manual_seed(0)
    step_against_jax(je, te, [demod_block(b, te.L, rng) for b in range(6)])
