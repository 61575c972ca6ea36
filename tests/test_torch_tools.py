"""The port's measuring tools on the CPU, beside the JAX package's where a
run there is cheap: profile_latency_torch.py (the keys and the added
latency of profile_latency.py), tools/bench_highc_torch.py (a small live
daemon: the tap's 700 Hz tone, and its per-block latency equal to the
daemon's ring, which already holds a dispatch over its D blocks), and
tools/prof_master_torch.py (each ablation case of the distributed master
against numpy, the whole against torch.fft at test_torch_parallel.py's
relative 2e-4)."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import bench_highc_torch  # noqa: E402
import prof_master_torch  # noqa: E402
import profile_latency  # noqa: E402
import profile_latency_torch  # noqa: E402


def test_profile_latency_twin():
    """time-shards 0 and 4 on the CPU: the JAX tool's keys and modes, and
    added_latency_ms = dispatch p50 + (D - 1) x 20 ms."""
    want = profile_latency.measure(0, 3)
    for ts, n in ((0, 4), (4, 2)):
        got = profile_latency_torch.measure(ts, n, device="cpu")
        assert set(want) <= set(got) and got["device"] == "cpu"
        assert got["mode"] == ("per-block" if ts == 0 else "time-shards=4")
        assert got["samples"] == n and got["blocks_per_dispatch"] == max(ts, 1)
        assert 0 < got["dispatch_p50_ms"] <= got["dispatch_p99_ms"]
        assert got["added_latency_ms"] == pytest.approx(
            got["dispatch_p50_ms"] + (max(ts, 1) - 1) * 20.0)
    assert want["mode"] == "per-block" and want["blocks_per_dispatch"] == 1


def test_bench_highc_on_cpu():
    """256 channels at 1.024 Msps, 4 blocks a dispatch, 2 s of stream: no
    drop, the carrier channel's audio at 700 Hz, no overflow after warm-up,
    and p50/p99 a block are the daemon's ring as it is, not over D again
    (tools/bench_highc.py divides them by D a second time)."""
    a = bench_highc_torch.parse(["--channels", "256", "--fs", "1.024e6", "--secs", "2",
                                 "--shards", "4", "--device", "cpu", "--loopback"])
    out, rd = bench_highc_torch.run(a)
    assert out["block_drops"] == 0 and abs(out["tap_tone_hz"] - 700.0) < 20
    assert out["egress_overflows_after_warmup"] == 0 and out["tap_packets"] > 0
    assert out["channels"] == 256 and out["time_shards"] == 4 and not out["chan_kernel"]
    p50, p99 = rd.latency_percentiles()
    assert out["p50_ms_per_block"] == p50 * 1e3 and out["p99_ms_per_block"] == p99 * 1e3
    assert 0 < out["p50_ms_per_block"] != p50 * 1e3 / 4


@pytest.mark.parametrize("D", [1, 4])
def test_prof_master_cases_on_a_cpu_mesh(D):
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel.master import DigitMaster

    N = 76_800
    mesh = make_mesh(["cpu"] * D)
    dm = DigitMaster.plan(mesh, "c", N, real=True)
    x = np.random.default_rng(D).standard_normal(N).astype(np.float32)
    xt = torch.from_numpy(x)
    full = torch.cat(prof_master_torch.pipeline(dm, xt))
    assert torch.equal(full, torch.cat(dm.fft_natural(xt).shards))
    ref = np.fft.fft(x.astype(np.float64))[:N // 2 + 1]
    got = full.numpy()[:N // 2 + 1]
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 2e-4
    # each case is the transform with its parts made identity: natural
    # order k1 + n1 k2 over the kept columns
    k1 = np.arange(dm.n1)[:, None]
    b = np.arange(dm.n2)[None, :]
    for case, (s1, s2, tw, strided) in prof_master_torch.CASES.items():
        out = torch.cat(prof_master_torch.pipeline(dm, xt, s1, s2, tw, strided)).numpy()
        assert out.shape == (dm.nat_bins,)
        if not strided:  # the same work over the contiguous axis: a cost proxy
            continue
        X = x.reshape(dm.n1, dm.n2).astype(np.complex128)
        if s1:
            X = np.fft.fft(X, axis=0)
        if tw:
            X = X * np.exp(-2j * np.pi * ((k1 * b) % N) / N)
        if s2:
            X = np.fft.fft(X, axis=1)
        want = np.zeros((dm.n1, dm.kept_pad), complex)
        want[:, :min(dm.kept_pad, dm.n2)] = X[:, :dm.kept_pad]
        want = want.T.reshape(-1)
        assert np.linalg.norm(out - want) / np.linalg.norm(want) < 2e-4, case
    rec = prof_master_torch.profile(mesh, N=N, k=2, reps=1)
    assert rec["D"] == D and set(rec["ms"]) == set(prof_master_torch.CASES)
    assert all(math.isfinite(v) and v > 0 for v in rec["ms"].values())
