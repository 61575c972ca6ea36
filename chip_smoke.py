#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ka9q_radio_tpu_torch).

Usage, from the root of a checkout, on a host with one NVIDIA GPU (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the rx888 shapes and at the hf32000 shapes (32,000
channels, from tile params built directly), times each (profiler device
time, beside its bound, its plain version and one PyTorch call as a
yardstick), drives the rx888 configuration (129.6 Msps real input, 1,000
SSB channels at 12 kHz with SNR squelch, a 16-channel wide spectrum sweep)
through Engine.step on a known-answer scene, times 64 distinct random
blocks, and splits the block time by stage and by kernel (CUDA events,
torch.profiler), with each kernel's device time inside the step. Then it
runs the daemon (Radiod) on the card at full width: the
examples/radiod@rx888-wspr.conf HF farm (about 32,700 usb channels with SNR
squelch, egress-slots 512, time-shards 8, the native edge) fed by a
sig_gen carrier, its RTP received on a local UDP socket, a retune command
fed through Radiod.handle_packet, and both kernels checked, timed and
counted at the daemon's own shapes. Each phase prints one JSON line; the
kernels line and the card's `nvidia-smi` name and power limit come before
the last line, which is
{"ok": true, "device": {...}}. Any failed phase exits non-zero. Long logs
go to chiprun_out/. It imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM peak rates (NVIDIA data sheet): device memory bytes/s, FP32 FLOP/s
# outside the tensor cores (an FMA counts 2), dense TF32 FLOP/s on the tensor
# cores, and 32-bit integer operations/s (132 SMs x 64 INT32 lanes x the
# 1.98 GHz boost clock).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
TF32_OPS_S = 495e12
INT32_OPS_S = 132 * 64 * 1.98e9

FS = 129_600_000
N0_SCENE = 1e-11  # noise density of the known-answer scene, power/Hz


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def rx888_groups(rt):
    """bench.py's rx888 configuration, in the port's specs."""
    ChannelSpec, GroupSpec = rt.ChannelSpec, rt.GroupSpec
    freqs = np.linspace(0.02 * FS, 0.48 * FS, 1000)
    sfreqs = np.linspace(0.05 * FS, 0.45 * FS, 16)
    return [
        GroupSpec(name="hf", demod="linear", samprate=12_000, snr_squelch=True,
                  channels=tuple(ChannelSpec(freq=float(f), low=50.0, high=3000.0) for f in freqs)),
        GroupSpec(name="sweep", demod="spectrum", samprate=32_400, bin_bw=1000.0, bin_count=128,
                  channels=tuple(ChannelSpec(freq=float(f)) for f in sfreqs)),
    ]


def time_ms(fn, n: int = 30, warm: int = 3) -> float:
    """Median CUDA-event time of one call of fn, over n calls: the wall time
    of the call on the card's clock, launch overhead included."""
    for _ in range(warm):
        fn()
    evs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
           for _ in range(n)]
    for e0, e1 in evs:
        e0.record()
        fn()
        e1.record()
    torch.cuda.synchronize()
    ts = sorted(e0.elapsed_time(e1) for e0, e1 in evs)
    return ts[n // 2]


def device_ms(fn, n: int = 20, warm_s: float = 0.05, name: str = "") -> float:
    """Device time of one call of fn: the summed durations of the kernels and
    copies it launches whose name holds `name` (all of them by default; a
    name leaves out others, such as an L2 flush), from a torch.profiler
    (CUPTI) trace of n calls, over n, after warm_s seconds of calls (the
    card's clocks rise under load). Host launch overhead is not in it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t_end = time.perf_counter() + warm_s
    while time.perf_counter() < t_end:
        fn()
        torch.cuda.synchronize()
    for attempt in range(3):  # a profiler session now and then records nothing
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA and name in ev.name]
        if evs:
            return sum(ev.time_range.elapsed_us() for ev in evs) / 1e3 / n
        print(f"chip_smoke: profiler session {attempt + 1} recorded no device time "
              f"(kernel name {name!r})", file=sys.stderr, flush=True)
    fail(f"the profiler recorded no device time (kernel name {name!r})")


def bound(nbytes: float, *ops: tuple[float, float]) -> tuple[float, str]:
    """Least ms for nbytes through device memory and, for each (count,
    rate) of ops, count operations at that rate (each kind on its own
    units, so the slowest sets the time); and which of the two sets it."""
    tb, to = nbytes / HBM_BYTES_S, max(n / rate for n, rate in ops)
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def counts_a(C: int, S: int, n: int, olen: int, unique_rows: int) -> tuple[int, int]:
    """Kernel A's work, as the function needs it: bytes (the F rows the
    channels cover, the responses, E[:n], tile params and the output, each
    once) and FLOP (the gather's complex products, the fold's adds, the
    folded n-term complex product, the ramp)."""
    nbytes = unique_rows * 128 * 8 + C * S * 8 + n * olen * 8 + C * olen * 8 + 3 * C * 4
    return nbytes, 6 * C * S + 2 * C * (S - n) + 8 * C * n * olen + 8 * C * olen


def bound_a(nbytes: int, nops: int) -> dict:
    """A's bound on the tensor cores (3xTF32: three TF32 products for each
    FP32-accurate one) and, beside it, on the FP32 cores. The operations
    are the dense folded product the kernel does; an FFT form of the same
    IDFT needs far fewer, so the byte term alone is given too."""
    b, by = bound(nbytes, (3 * nops, TF32_OPS_S))
    b32, by32 = bound(nbytes, (nops, FP32_OPS_S))
    return {"bound_ms": b, "bound_by": by, "bound_rate": "3xTF32 on the tensor cores",
            "ops_counted": "dense folded product 8 C n olen + gather, fold, ramp",
            "bound_fp32_cores_ms": b32, "bound_fp32_cores_by": by32,
            "bound_bytes_ms": nbytes / HBM_BYTES_S * 1e3}


def counts_b(C: int, W: int, unique_bins: int) -> tuple[int, int, int]:
    """Kernel B's work as the function needs it: bytes (the window bins
    once, shifts, N0 and keys), FP32 operations (3 for |F|^2 of a bin, the
    mean's compare and add) and 32-bit integer operations (one compare a
    key: an exact order statistic reads every key at least once)."""
    return unique_bins * 8 + C * (4 + 4 + 8), C * W * (3 + 2), C * W


def bound_b(nbytes: int, fp_ops: int, int_ops: int) -> dict:
    b, by = bound(nbytes, (fp_ops, FP32_OPS_S), (int_ops, INT32_OPS_S))
    return {"bound_ms": b, "bound_by": by, "bytes": nbytes, "ops": fp_ops + int_ops,
            "ops_fp32": fp_ops, "ops_int32": int_ops}


def check_kernels(eng, params, F) -> list[dict]:
    """Each kernel against its plain version at the main path's shapes."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import _CTILE, tiled_channelize
    from ka9q_radio_tpu_torch.ops.noise import estimate_noise_keys, gather_noise_bins

    g, p, m = eng.groups["hf"], params["hf"], eng.master
    C, S = p["resp_tiles"].shape
    olen = g.olen

    def kern_a():
        return cc.cuda_channelize(F, p["resp_tiles"], p["tile_lo"], p["slope"], p["shifts"],
                                  g.tile_E, g.n_bins, olen, m.real, m.N, E_op=g.tile_op)

    def plain_a():
        return tiled_channelize(F, p["resp_tiles"], p["tile_lo"], p["slope"], p["shifts"],
                                g.tile_E, g.n_bins, olen, m.real, m.N)

    got, want = kern_a(), plain_a()
    err_a = float((got - want).abs().max())
    scale_a = float(want.abs().max())
    c128 = [t.to(torch.complex128) for t in (F, p["resp_tiles"], g.tile_E)]
    exact = tiled_channelize(c128[0], c128[1], p["tile_lo"], p["slope"], p["shifts"], c128[2],
                             g.n_bins, olen, m.real, m.N)
    err_a64 = float((got.to(torch.complex128) - exact).abs().max())
    if not err_a < 3e-5 * scale_a:
        fail(f"channelize kernel disagrees: max abs err {err_a} vs bound {3e-5 * scale_a}")
    # library yardstick: one complex GEMM of the gathered, filtered bins by E
    nrows = -(-m.bins // _CTILE)
    tl = np.asarray(g.host["tile_lo"], np.int64)
    rows = np.clip(tl[:, None] + np.arange(S // _CTILE), 0, nrows - 1)
    Fp = torch.nn.functional.pad(F, (0, nrows * _CTILE - m.bins)).reshape(nrows, _CTILE)
    x = Fp[torch.as_tensor(rows, device=F.device)].reshape(C, S) * p["resp_tiles"]
    lib_a = device_ms(lambda: torch.matmul(x, g.tile_E))
    nb_a, nops_a = counts_a(C, S, g.n_bins, olen, len(np.unique(rows)))
    # A alone after a 64 MB write has evicted L2 (E's operand, the
    # responses, F): how much of its in-step time L2 misses explain
    flush = torch.empty(16 << 20, dtype=torch.float32, device=F.device)
    cold_a = device_ms(lambda: (flush.fill_(1.0), kern_a()), name="channelize_kernel")

    def kern_b():
        return cc.cuda_noise_est(F, p["shifts"], g.noise_bins, m.real, m.N, eng.samprate)

    def plain_b():
        return estimate_noise_keys(gather_noise_bins(F, p["shifts"], g.noise_bins, m.real, m.N),
                                   m.bins, eng.samprate)

    (n0_k, keys_k), (n0_t, keys_t) = kern_b(), plain_b()
    if not torch.equal(keys_k, keys_t):
        bad = int((keys_k != keys_t).any(-1).sum())
        fail(f"noise kernel order-statistic keys differ from the plain version on {bad} channels")
    rel_b = float(((n0_k - n0_t).abs() / n0_t.abs()).max())
    if not rel_b <= 2e-5:
        fail(f"noise kernel N0 disagrees: max rel err {rel_b} > 2e-5")
    W = -(-g.noise_bins // _CTILE) * _CTILE
    sh = np.abs(np.asarray(g.host["shifts"], np.int64))
    start = np.clip(sh - W // 2, 0, m.bins - W) // _CTILE * _CTILE
    bb = bound_b(*counts_b(C, W, len(np.unique(start[:, None] + np.arange(W)))))
    energies = gather_noise_bins(F, p["shifts"], g.noise_bins, m.real, m.N)
    i_stat = int(np.floor(0.10 * (W - 1)))
    lib_b = device_ms(lambda: torch.kthvalue(energies, i_stat + 1, dim=-1))

    kernels = [
        {"name": "channelize", "route": "cuda", "source": cc.SOURCES["channelize"],
         "replaces": cc.REPLACES["channelize"], "launches": 0, "max_abs_err": err_a,
         "err_bound": 3e-5 * scale_a, "max_abs_err_vs_f64_sum": err_a64,
         "ms": device_ms(kern_a), "plain_ms": device_ms(plain_a), "call_ms": time_ms(kern_a),
         "ms_cold_l2": cold_a, **bound_a(nb_a, nops_a), "library_ms": lib_a,
         "library_call": "torch.matmul(gathered x [C, S] c64, E [S, olen] c64)",
         "bytes": nb_a, "ops": nops_a,
         "shape": {"C": C, "S": S, "n": g.n_bins, "olen": olen}},
        {"name": "noise_est", "route": "cuda", "source": cc.SOURCES["noise_est"],
         "replaces": cc.REPLACES["noise_est"], "launches": 0,
         "max_abs_err": float((n0_k - n0_t).abs().max()), "max_rel_err": rel_b,
         "keys_equal": True, "ms": device_ms(kern_b), "plain_ms": device_ms(plain_b),
         "call_ms": time_ms(kern_b), **bb, "library_ms": lib_b,
         "library_call": "torch.kthvalue(gathered |F|^2 [C, W], i + 1): statistic i only",
         "shape": {"C": C, "W": W}},
    ]
    return kernels


def hf_tiles(C: int, device, seed: int = 7) -> dict:
    """Kernel inputs of the hf<C> configuration (bench.py:69-80: C SSB
    channels at 12 kHz spread over one 129.6 Msps real stream; n 300, olen
    240), from tile params built directly rather than through an engine, and
    a random master spectrum from `seed`."""
    from ka9q_radio_tpu_torch.ops.filter_design import (design_bandpass_response,
                                                        response_to_device_order)
    from ka9q_radio_tpu_torch.ops.filterbank import (MasterConfig, build_tile_params,
                                                     compute_tuning, tiled_idft_matrix)

    n_bins, olen = 300, 240
    m = MasterConfig.from_rate(FS, real=True)
    resp1 = response_to_device_order(design_bandpass_response(
        n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0, real_master=True, master_points=m.N))
    freqs = np.linspace(0.02 * FS, 0.48 * FS, C)
    shifts = np.array([compute_tuning(m.N, FS, f)[0] for f in freqs], np.int32)
    rt, tl, sl = build_tile_params(np.broadcast_to(resp1, (C, n_bins)), shifts, True, m.N)
    rng = np.random.default_rng(seed)
    F = (0.05 * (rng.standard_normal(m.bins) + 1j * rng.standard_normal(m.bins))).astype(np.complex64)
    d = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return {"m": m, "n_bins": n_bins, "olen": olen, "tile_lo_host": tl, "shifts_host": shifts,
            "F": d(F), "resp_tiles": d(rt), "tile_lo": d(tl), "slope": d(sl), "shifts": d(shifts),
            "E": d(tiled_idft_matrix(n_bins, olen, rt.shape[-1]))}


def check_hf32000(device, C: int = 32_000) -> dict:
    """Both kernels against their plain versions, timed, at the hf32000
    shapes (noise window 1,024)."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import _CTILE, tiled_channelize
    from ka9q_radio_tpu_torch.ops.noise import estimate_noise_keys, gather_noise_bins

    h = hf_tiles(C, device)
    m, n_bins, olen, W = h["m"], h["n_bins"], h["olen"], 1024
    F, E, rt_d, sh_d = h["F"], h["E"], h["resp_tiles"], h["shifts"]
    tl, shifts = h["tile_lo_host"], h["shifts_host"]
    S = rt_d.shape[-1]
    op = cc.channelize_operand(E, n_bins, olen)
    args = (F, rt_d, h["tile_lo"], h["slope"], sh_d, E, n_bins, olen, True, m.N)
    kern_a = lambda: cc.cuda_channelize(*args, E_op=op)  # noqa: E731
    plain_a = lambda: tiled_channelize(*args)  # noqa: E731
    got, want = kern_a(), plain_a()
    err_a, scale_a = float((got - want).abs().max()), float(want.abs().max())
    if not err_a < 3e-5 * scale_a:
        fail(f"hf32000 channelize disagrees: {err_a} vs bound {3e-5 * scale_a}")
    nrows = -(-m.bins // _CTILE)
    rows = np.clip(tl.astype(np.int64)[:, None] + np.arange(S // _CTILE), 0, nrows - 1)
    Fp = torch.nn.functional.pad(F, (0, nrows * _CTILE - m.bins)).reshape(nrows, _CTILE)
    x = Fp[torch.as_tensor(rows, device=device)].reshape(C, S) * rt_d
    nb_a, nops_a = counts_a(C, S, n_bins, olen, len(np.unique(rows)))
    a = {"C": C, "max_abs_err": err_a, "err_bound": 3e-5 * scale_a, "ms": device_ms(kern_a),
         "plain_ms": device_ms(plain_a), "library_ms": device_ms(lambda: torch.matmul(x, E)),
         **bound_a(nb_a, nops_a), "bytes": nb_a, "ops": nops_a}
    del x, got, want

    kern_b = lambda: cc.cuda_noise_est(F, sh_d, W, True, m.N, FS)  # noqa: E731
    plain_b = lambda: estimate_noise_keys(gather_noise_bins(F, sh_d, W, True, m.N),  # noqa: E731
                                          m.bins, FS)
    (n0_k, keys_k), (n0_t, keys_t) = kern_b(), plain_b()
    if not torch.equal(keys_k, keys_t):
        fail("hf32000 noise keys differ from the plain version")
    rel_b = float(((n0_k - n0_t).abs() / n0_t.abs()).max())
    if not rel_b <= 2e-5:
        fail(f"hf32000 N0 disagrees: max rel err {rel_b}")
    start = np.clip(np.abs(shifts.astype(np.int64)) - W // 2, 0, m.bins - W) // _CTILE * _CTILE
    bb = bound_b(*counts_b(C, W, len(np.unique(start[:, None] + np.arange(W)))))
    energies = gather_noise_bins(F, sh_d, W, True, m.N)
    i_stat = int(np.floor(0.10 * (W - 1)))
    b = {"C": C, "keys_equal": True, "max_rel_err": rel_b, "ms": device_ms(kern_b),
         "plain_ms": device_ms(plain_b, n=5),
         "library_ms": device_ms(lambda: torch.kthvalue(energies, i_stat + 1, dim=-1)), **bb}
    return {"channelize": a, "noise_est": b}


def check_complex_master(device) -> dict:
    """Both kernels on a complex master (mod-wrapped rows and windows), which
    the rx888 path does not reach, against their plain versions."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response
    from ka9q_radio_tpu_torch.ops.filterbank import (build_tile_params, tiled_channelize,
                                                     tiled_idft_matrix)
    from ka9q_radio_tpu_torch.ops.noise import estimate_noise_keys, gather_noise_bins

    rng = np.random.default_rng(5)
    master_N, n_bins, olen, C = 65_536, 256, 200, 256
    resp = np.stack([design_bandpass_response(n_bins, olen, 50 / 12e3, 3e3 / 12e3, 11.0,
                                              real_master=False, master_points=master_N)
                     * np.exp(1j * rng.uniform(0, 2 * np.pi)) for _ in range(C)]).astype(np.complex64)
    shifts = np.linspace(-30_000, 30_000, C).astype(np.int32)
    rt, tl, sl = build_tile_params(resp, shifts, False, master_N)
    E = tiled_idft_matrix(n_bins, olen, rt.shape[-1])
    F = (rng.standard_normal(master_N) + 1j * rng.standard_normal(master_N)).astype(np.complex64)
    d = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    args = (d(F), d(rt), d(tl), d(sl), d(shifts), d(E), n_bins, olen, False, master_N)
    op = cc.channelize_operand(args[5], n_bins, olen)
    got, want = cc.cuda_channelize(*args, E_op=op), tiled_channelize(*args)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not err < 3e-5 * scale:
        fail(f"complex-master channelize disagrees: {err} vs bound {3e-5 * scale}")
    n0_k, keys_k = cc.cuda_noise_est(d(F), d(shifts), 1000, False, master_N, 1e6)
    n0_t, keys_t = estimate_noise_keys(gather_noise_bins(d(F), d(shifts), 1000, False, master_N),
                                       master_N, 1e6)
    if not torch.equal(keys_k, keys_t):
        fail("complex-master noise keys differ from the plain version")
    rel = float(((n0_k - n0_t).abs() / n0_t.abs()).max())
    if not rel <= 2e-5:
        fail(f"complex-master N0 disagrees: max rel err {rel}")
    return {"channelize_err": err, "channelize_bound": 3e-5 * scale, "noise_rel_err": rel}


def pick_on_grid(freqs, offset: float, hz_per_bin: float, lo: int, hi: int, avoid=()):
    """Channel index in [lo, hi) whose dial + offset lies closest to a master
    bin centre (a bin-centred carrier leaks into no other bin)."""
    cand = [i for i in range(lo, hi) if all(abs(i - a) > 50 for a in avoid)]
    x = (np.asarray(freqs)[cand] + offset) / hz_per_bin
    i = int(np.argmin(np.abs(x - np.round(x))))
    return cand[i], int(np.round(x[i]))


def peak_hz(audio, rate: float) -> float:
    a = np.asarray(audio, np.float64)
    n = 8 * a.size
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size), n))
    return float(np.fft.rfftfreq(n, 1.0 / rate)[int(np.argmax(spec))])


def run_scene(eng, params, device, seed: int = 1) -> dict:
    """Known-answer scene through Engine.step: a carrier at channel k's dial
    + 700 Hz, one at channel j's dial - 1000 Hz (the opposite sideband of an
    upper-sideband channel), calibrated noise of density N0_SCENE. 10 blocks
    (the first 2 discarded); then a retune of channel k by -500 Hz and 6
    more blocks (2 discarded)."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    m, L = eng.master, eng.L
    hz = eng.samprate / m.N
    freqs = [c.freq for c in eng.groups["hf"].spec.channels]
    k, kbin = pick_on_grid(freqs, 700.0, hz, 100, 900)
    j, jbin = pick_on_grid(freqs, -1000.0, hz, 100, 900, avoid=(k,))
    gen = torch.Generator(device=device).manual_seed(seed)
    std = float(np.sqrt(N0_SCENE * eng.samprate / 2.0))  # real stream: fs/2 of bandwidth

    def block(b: int) -> torch.Tensor:
        n = torch.arange(L, dtype=torch.int64, device=device) + b * L
        sig = sum(torch.cos((2 * np.pi / m.N) * torch.remainder(n * kb, m.N).to(torch.float64))
                  for kb in (kbin, jbin))
        return sig.to(torch.float32) + std * torch.randn(L, generator=gen, device=device)

    state = eng.init_state()
    cc.reset_launches()
    outs = []
    for b in range(10):
        state, out = eng.step(state, params, block(b))
        outs.append(out)
    launches = dict(cc.launches)
    host_due = sum(1 for b in range(10) if b < 2 or b % eng.noise_every == 0)
    hf = [o["hf"] for o in outs[2:]]
    audio_k = torch.cat([o["audio"][k] for o in hf]).cpu().numpy()
    p_k = float(torch.stack([o["info"]["baseband_power"][k] for o in hf]).mean())
    p_j = float(torch.stack([o["info"]["baseband_power"][j] for o in hf]).mean())
    n0 = outs[-1]["hf"]["info"]["n0"].cpu().numpy()
    others = np.delete(n0, [k, j])
    dev_db = 10 * np.log10(others / N0_SCENE)
    sweep = outs[-1]["sweep"]["info"]["bin_data"]

    # retune channel k 500 Hz down: its carrier moves to 1200 Hz of audio,
    # with every param tensor and constant left where it was
    g = eng.groups["hf"]
    ptrs = {key: t.data_ptr() for key, t in params["hf"].items() if torch.is_tensor(t)}
    ptrs["tile_E"], ptrs["tile_op"] = g.tile_E.data_ptr(), g.tile_op.data_ptr()
    params = eng.retune(params, "hf", k, freqs[k] - 500.0)
    ptrs_after = {key: t.data_ptr() for key, t in params["hf"].items() if torch.is_tensor(t)}
    ptrs_after["tile_E"], ptrs_after["tile_op"] = g.tile_E.data_ptr(), g.tile_op.data_ptr()
    outs2 = []
    for b in range(10, 16):
        state, out = eng.step(state, params, block(b))
        outs2.append(out)
    audio_k2 = torch.cat([o["hf"]["audio"][k] for o in outs2[2:]]).cpu().numpy()
    # restore the original tuning for later phases
    params = eng.retune(params, "hf", k, freqs[k])
    rate = eng.groups["hf"].spec.samprate
    return {
        "k": k, "j": j,
        "tone_k_offset_hz": kbin * hz - freqs[k], "tone_j_offset_hz": jbin * hz - freqs[j],
        "peak_k_hz": peak_hz(audio_k, rate),
        "rejection_db_lower_bound": float(10 * np.log10(p_k / p_j)),
        "p_k": p_k, "p_j": p_j,
        "n0_median_dev_db": float(np.median(dev_db)),
        "n0_max_abs_dev_db": float(np.abs(dev_db).max()),
        "n0_frac_within_1db": float(np.mean(np.abs(dev_db) <= 1.0)),
        "launches": launches, "due_blocks": host_due, "blocks": 10,
        "sweep_finite": bool(torch.isfinite(sweep).all()), "sweep_shape": list(sweep.shape),
        "retune_peak_hz": peak_hz(audio_k2, rate),
        "retune_expected_hz": kbin * hz - (freqs[k] - 500.0),
        "retune_rebuilt": sorted(key for key in ptrs if ptrs[key] != ptrs_after.get(key)),
    }


def timed_run(eng, params, device, nblocks: int = 64, warm: int = 4, seed: int = 2) -> dict:
    """nblocks distinct random blocks through step under sync-debug "error"
    (any device->host sync raises), timed with CUDA events."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    gen = torch.Generator(device=device).manual_seed(seed)
    std = float(np.sqrt(N0_SCENE * eng.samprate / 2.0))
    blocks = std * torch.randn((warm + nblocks, eng.L), generator=gen, device=device)
    state = eng.init_state()
    for b in range(warm):
        state, _ = eng.step(state, params, blocks[b])
    j0 = state["host"]["jobnum"]
    due = sum(1 for b in range(j0, j0 + nblocks) if b % eng.noise_every == 0)
    cc.reset_launches()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        e0.record()
        for b in range(warm, warm + nblocks):
            state, out = eng.step(state, params, blocks[b])
        e1.record()
        host_ms = (time.perf_counter() - t0) * 1e3 / nblocks
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / nblocks
    return {"blocks": nblocks, "ms_per_block": ms, "host_enqueue_ms_per_block": host_ms,
            "msps": eng.L / (ms * 1e-3) / 1e6,
            "realtime_factor": eng.L / (ms * 1e-3) / eng.samprate,
            "launches": dict(cc.launches), "due_blocks": due,
            "finite": bool(torch.isfinite(out["hf"]["audio"]).all()
                           and torch.isfinite(out["sweep"]["info"]["bin_data"]).all())}


def stage_split(eng, params, device) -> dict:
    """Each stage of one steady rx888 block timed alone, as device time
    (profiler) and as wall time on the card's clock (CUDA events, launch
    overhead included): master FFT, kernel A, kernel B, the hf group's
    demod tail (N0 EMA, fine tune, AGC, squelch), the sweep."""
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft

    gen = torch.Generator(device=device).manual_seed(3)
    blk = float(np.sqrt(N0_SCENE * eng.samprate / 2.0)) * torch.randn(eng.L, generator=gen,
                                                                      device=device)
    m, st = eng.master, eng.init_state()
    _, F = master_fft(m, st["master"], blk)
    g, p, sw = eng.groups["hf"], params["hf"], eng.groups["sweep"]
    bb = g._channelize(p, F)
    n0 = g._noise_est(p, F)
    steady = {"warmup": 0, "frames": 10 * sw.wide_geo.fft_avg}
    stages = {
        "master_fft": lambda: master_fft(m, st["master"], blk),
        "channelize": lambda: g._channelize(p, F),
        "noise_est": lambda: g._noise_est(p, F),
        "demod_tail": lambda: g._demod_tail(st["groups"]["hf"], p, bb, n0, True, False),
        "sweep": lambda: sw.step(st["groups"]["sweep"], params["sweep"], F, blk, 8, steady),
    }
    return {"stage_device_ms": {k: device_ms(f) for k, f in stages.items()},
            "stage_wall_ms": {k: time_ms(f) for k, f in stages.items()}}


def device_busy(eng, params, device, out_dir: Path, nblocks: int = 8, seed: int = 4) -> dict:
    """Kernel time per steady block from a torch.profiler trace of nblocks
    steps (CUDA activity): the device's busy time, its kernel count, and
    the kernels that take most of it. The trace goes to out_dir."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    gen = torch.Generator(device=device).manual_seed(seed)
    std = float(np.sqrt(N0_SCENE * eng.samprate / 2.0))
    blocks = std * torch.randn((8 + nblocks, eng.L), generator=gen, device=device)
    state = eng.init_state()
    for b in range(8):
        state, _ = eng.step(state, params, blocks[b])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in range(8, 8 + nblocks):
            state, _ = eng.step(state, params, blocks[b])
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out_dir / "step_trace.json"))
    kern = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for ev in kern:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / nblocks
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    # the two kernels' device time per launch inside the step
    in_step = {}
    for name, sub in (("channelize", "channelize_kernel"), ("noise_est", "noise_kernel")):
        evs = [ev for ev in kern if sub in ev.name]
        in_step[name] = (sum(ev.time_range.elapsed_us() for ev in evs) / 1e3 / len(evs)
                         if evs else None)
    return {"blocks": nblocks, "kernels_per_block": len(kern) / nblocks,
            "busy_ms_per_block": sum(by_name.values()) if kern else None,
            "kernel_in_step_ms_per_launch": in_step,
            "top_ms_per_block": [[name[:80], ms] for name, ms in top]}


WSPR_CONF = ROOT / "examples" / "radiod@rx888-wspr.conf"
DAEMON_K = 6334  # raster channel of the daemon's carrier: 2.6 MHz + k * 1.815 kHz
DAEMON_OPEN = 320  # channels the daemon's busy run opens, under egress-slots = 512
# their tones' level: ~20 dB SNR in the channel. At the carrier's -60 dBFS a
# tone also opens its neighbours on the 1.815 kHz raster (the USB passband is
# wider than the pitch): 320 such tones opened 862-961 channels.
DAEMON_TONE_DBFS = -80.0


def _free_port() -> int:
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def daemon_config(dport: int, sport: int) -> tuple[str, list[str], float]:
    """examples/radiod@rx888-wspr.conf with the changes listed in `reduced`:
    a sig_gen front end at the same rate with a carrier 1,500 Hz above one
    raster channel's dial and a noise floor, and the streams on local ports.
    Returns (config text, reduced, carrier's channel dial)."""
    import re

    text = WSPR_CONF.read_text()
    dial = 2_600_000 + DAEMON_K * 1_815
    adc = ("[adc]\ndevice = sig_gen\nsamprate = 129m6\nreal = yes\n"
           f"carrier = {dial + 1500}\namplitude = -60\nn0 = -138\n\n")
    text, n = re.subn(r"\[adc\].*?(?=\n\[hf\])", adc, text, flags=re.S)
    if n != 1:
        fail("the daemon config's [adc] section was not found")
    text = text.replace("status = hffarm.local", f"status = 127.0.0.1:{sport}")
    text = text.replace("data = hffarm-pcm.local", f"data = 127.0.0.1:{dport}")
    text = text.replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1)
    reduced = [
        "[adc]: device = rtp (the SDR host's 129.6 Msps s16be stream) -> device = sig_gen at "
        f"samprate 129m6, real = yes: carrier {dial + 1500} Hz (raster channel {DAEMON_K}'s dial "
        "+ 1,500 Hz) at -60 dBFS, noise density -138 dBFS/Hz",
        f"data, status: hffarm-pcm.local, hffarm.local -> 127.0.0.1:{dport}, 127.0.0.1:{sport}",
        "sap = no, advertise = no: no SAP or mDNS announcements (the run has no network)",
    ]
    return text, reduced, float(dial)


def run_daemon(card: str, device) -> tuple[dict, dict]:
    """The daemon at full width on the card: warm-up, ~256 blocks flat out
    while the carrier's RTP is received, a +500 Hz retune command through
    handle_packet, 64 more blocks; then a profiled dispatch (each kernel's
    time inside the daemon) and both kernels against their plain versions
    at the daemon's shapes. Returns (the phase's JSON, per-kernel data)."""
    import select
    import socket

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    dport, sport = _free_port(), _free_port()
    text, reduced, dial = daemon_config(dport, sport)
    cfg = load_config(text)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", dport))
    rx.setblocking(False)
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    rd = Radiod(cfg, use_network=True, data_port=dport, status_port=sport)
    t_init = time.perf_counter() - t0
    g = rd.engine.groups["hf"]
    ch = next(c for c in rd.chans.values() if c.group == "hf" and c.idx == DAEMON_K)
    if ch.freq != dial:
        fail(f"raster channel {DAEMON_K} is at {ch.freq} Hz, want {dial}")
    if "hf" not in rd.edges:
        fail("the daemon's native edge did not come up")
    D = rd._time_shards
    pkts: list[tuple[int, bytes]] = []  # (seq, payload) of the carrier's channel
    others: set[int] = set()
    max_count = [0]

    def drain(keep: bool):
        while select.select([rx], [], [], 0)[0]:
            pkt = rx.recv(65536)
            h, payload = RtpHeader.unpack(pkt)
            if h.ssrc != ch.ssrc:
                others.add(h.ssrc)
            elif keep:
                pkts.append((h.seq, payload))

    def dispatch(keep: bool):
        rd.step_block()
        info = rd._ginfo["hf"]
        max_count[0] = max(max_count[0], int(np.max(info._cache["egress_count"])))
        drain(keep)

    def tone(n_dispatches: int) -> tuple[float, int]:
        pkts.clear()
        for _ in range(n_dispatches):
            dispatch(True)
        audio = np.concatenate([np.frombuffer(p, ">i2") for _, p in sorted(pkts)])
        return peak_hz(audio.astype(np.float64), g.spec.samprate), audio.size

    # the host's share of a block: the generator's and the step's enqueue,
    # the device->host copy (it waits for the device's unfinished work) and
    # the per-block emission (RTP, beacons, lifetimes)
    parts = {"siggen_enqueue": "_siggen", "step_enqueue": "step", "d2h_sync": "_fetch_out",
             "finish_block": "_finish_block"}

    def timed_run(body) -> tuple:
        """body() with each part of the host's block timed and the block-time
        ring emptied first; returns (body's result, the run's block times)."""
        split = dict.fromkeys(parts, 0.0)
        orig = {k: getattr(rd, a) for k, a in parts.items()}

        def wrap(k):
            fn = orig[k]

            def wrapped(*args):
                t = time.perf_counter()
                r = fn(*args)
                split[k] += time.perf_counter() - t
                return r
            return wrapped

        for k, a in parts.items():
            setattr(rd, a, wrap(k))
        rd._t_n = 0
        b0 = rd.blocks
        t0 = time.perf_counter()
        res = body()
        elapsed = time.perf_counter() - t0
        for k, a in parts.items():
            setattr(rd, a, orig[k])
        blocks = rd.blocks - b0
        host_split = {k: v * 1e3 / blocks for k, v in split.items()}
        host_split["other"] = elapsed * 1e3 / blocks - sum(host_split.values())
        p50, p99 = rd.latency_percentiles()
        return res, {"blocks": blocks, "dispatches": blocks // D, "p50_ms": p50 * 1e3,
                     "p99_ms": p99 * 1e3, "mean_ms": elapsed * 1e3 / blocks,
                     "host_split_ms_per_block": host_split,
                     "realtime_factor": rd.cfg.blocktime / p50 if p50 else None,
                     "msps": blocks * rd.engine.L / elapsed / 1e6}

    for _ in range(4):  # warm-up: the first dispatch plans cuFFT, the AGC starts
        dispatch(False)
    cc.reset_launches()
    j0, b0 = rd.state["host"]["jobnum"], rd.blocks
    (peak1, n1), one = timed_run(lambda: tone(32))
    blocks = one["blocks"]
    rd.handle_packet(encode_status({T.OUTPUT_SSRC: ch.ssrc, T.COMMAND_TAG: 1,
                                    T.RADIO_FREQUENCY: dial + 500.0}, cmd=True))
    peak2, n2 = tone(8)
    launches = dict(cc.launches)
    due = sum(1 for b in range(j0, rd.state["host"]["jobnum"])
              if b % rd.engine.noise_every == 0)
    send_k = bool(rd._ginfo["hf"]["send"][ch.idx])
    edge = rd.edges["hf"][0]
    out = {"phase": "daemon", "card": card, "config": str(WSPR_CONF.relative_to(ROOT)),
           "reduced": reduced, "channels": g.C, "egress_slots": g.spec.egress_slots,
           "time_shards": D, "init_s": t_init, "open_channels": "one (the carrier's)",
           **one, "packets_sent": edge.packets,
           "peak_device_mb": torch.cuda.max_memory_allocated(device) / 2**20,
           "carrier_ssrc": ch.ssrc, "carrier_send": send_k, "tone_hz": peak1,
           "tone_samples": int(n1), "retune_tone_hz": peak2, "retune_samples": int(n2),
           "egress_count_max": max_count[0], "egress_overflows": rd.egress_overflows,
           "block_drops": rd.block_drops, "other_ssrcs_heard": sorted(others)[:20],
           "launches": launches, "due_blocks": due}
    if abs(peak1 - 1500.0) > 10.0:
        fail(f"daemon: the carrier's channel peaks at {peak1} Hz, want 1500")
    if not send_k or n1 == 0:
        fail("daemon: the carrier's channel did not open its squelch")
    if abs(peak2 - 1000.0) > 10.0:
        fail(f"daemon: after the +500 Hz retune the tone is at {peak2} Hz, want 1000")
    if rd.egress_overflows or rd.block_drops or max_count[0] >= g.spec.egress_slots // 4:
        fail(f"daemon: overflows {rd.egress_overflows}, drops {rd.block_drops}, "
             f"egress count up to {max_count[0]} of {g.spec.egress_slots}")
    if launches["channelize"] != blocks + 8 * D or launches["noise_est"] != due:
        fail(f"daemon: launch counts {launches}, want channelize {blocks + 8 * D}, "
             f"noise_est {due}")

    # the same farm with a realistic open fraction: DAEMON_OPEN more raster
    # channels each carry a weak tone near 1,500 Hz above their dial, added to the
    # generator's carrier and noise. Each tone is a whole number of cycles a
    # block (a multiple of 50 Hz), so one device block repeats without a
    # phase step.
    from ka9q_radio_tpu_torch.runtime.source import multi_tone_block

    ks = [k for k in np.linspace(0, g.C - 1, DAEMON_OPEN + 1).astype(int) if k != DAEMON_K]
    ks = ks[:DAEMON_OPEN]
    freqs = np.round((2_600_000 + np.asarray(ks) * 1_815 + 1500) / 50.0) * 50.0
    tones = torch.zeros(rd.engine.L, device=device)
    for i in range(0, len(ks), 32):  # 32 carriers at a time: [32, L] complex ramps
        st = {"phase": torch.zeros(len(freqs[i:i + 32]), dtype=torch.int32, device=device)}
        amps = np.full(len(freqs[i:i + 32]), 10.0 ** (DAEMON_TONE_DBFS / 20.0))
        tones += multi_tone_block(st, freqs[i:i + 32], amps,
                                  rd.engine.samprate, rd.engine.L)[1]
    carrier_gen = rd._siggen

    def with_tones(st_):
        st_, blocks_ = carrier_gen(st_)
        return st_, blocks_ + tones

    rd._siggen = with_tones
    counts = []

    def many(n_dispatches: int):
        for _ in range(n_dispatches):
            rd.step_block()
            counts.extend(int(c) for c in np.atleast_1d(rd._ginfo["hf"]._cache["egress_count"]))
            drain(False)

    p0 = edge.packets
    many(2)  # the new channels open their squelch
    counts.clear()
    _, busy_run = timed_run(lambda: many(32))
    opened = sum(bool(rd._ginfo["hf"]["send"][k]) for k in ks)
    out["open_many"] = {"tone_channels": len(ks), "tone_dbfs": DAEMON_TONE_DBFS, **busy_run,
                        "egress_count_min": min(counts), "egress_count_max": max(counts),
                        "tone_channels_open_last_block": opened,
                        "packets_sent": edge.packets - p0,
                        "peak_device_mb": torch.cuda.max_memory_allocated(device) / 2**20}
    if opened != len(ks) or min(counts) < len(ks) or max(counts) >= g.spec.egress_slots:
        fail(f"daemon: {opened} of {len(ks)} tone channels open, egress count "
             f"{min(counts)}..{max(counts)} of {g.spec.egress_slots}")
    if rd.egress_overflows or rd.block_drops:
        fail(f"daemon: overflows {rd.egress_overflows}, drops {rd.block_drops} "
             f"with {len(ks)} channels open")

    # where the host's time goes with those channels open: cProfile over 4
    # dispatches (its overhead inflates every entry alike), the top functions
    # by own time, per block
    import cProfile
    import io
    import pstats

    prof_host = cProfile.Profile()
    prof_host.enable()
    for _ in range(4):
        rd.step_block()
    prof_host.disable()
    buf = io.StringIO()
    st = pstats.Stats(prof_host, stream=buf).sort_stats("tottime")
    st.print_stats(25)
    (ROOT / "chiprun_out" / "daemon_host_profile.txt").write_text(buf.getvalue())
    top = sorted(st.stats.items(), key=lambda kv: -kv[1][2])[:10]
    out["host_profile_top_ms_per_block"] = [
        [f"{fn[0].rsplit('/', 1)[-1]}:{fn[1]}({fn[2]})", v[2] * 1e3 / (4 * D),
         v[3] * 1e3 / (4 * D)] for fn, v in top]

    # each kernel's device time inside the daemon, with those channels open
    # (profiler, two dispatches)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):  # a profiler session now and then records nothing
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(2):
                rd.step_block()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
        if kern:
            break
    else:
        fail("daemon: the profiler recorded no device time")
    busy = sum(ev.time_range.elapsed_us() for ev in kern) / 1e3
    in_daemon = {}
    for name, sub in (("channelize", "channelize_kernel"), ("noise_est", "noise_kernel")):
        evs = [ev for ev in kern if sub in ev.name]
        in_daemon[name] = (sum(ev.time_range.elapsed_us() for ev in evs) / 1e3 / len(evs)
                           if evs else None)
    out.update({"profiled_blocks": 2 * D, "device_busy_ms_per_block": busy / (2 * D),
                "wall_ms_per_block_profiled": wall / (2 * D),
                "device_idle_share": 1.0 - busy / wall, "kernel_in_daemon_ms": in_daemon})
    rx.close()

    # both kernels against their plain versions at the daemon's shapes
    blk = float(np.sqrt(1.585e-14 * rd.engine.samprate / 2.0)) * torch.randn(
        rd.engine.L, generator=torch.Generator(device=device).manual_seed(6), device=device)
    _, F = master_fft(rd.engine.master, rd.engine.init_state()["master"], blk)
    at = {k["name"]: k for k in check_kernels(rd.engine, rd.params, F)}
    per_kernel = {}
    for name in ("channelize", "noise_est"):
        k = at[name]
        per_kernel[name] = {
            "C": g.C, "launches": launches[name], "in_daemon_ms": in_daemon[name],
            **{key: k[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                       "max_abs_err") if key in k},
            **({"max_rel_err": k["max_rel_err"]} if "max_rel_err" in k else {}),
            **({"err_bound": k["err_bound"]} if "err_bound" in k else {})}
    out["kernels_at_daemon"] = per_kernel
    for edge_, _ in rd.edges.values():
        edge_.close()
    return out, per_kernel


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    if not (ROOT / "ka9q_radio_tpu_torch" / "csrc").is_dir():
        fail(f"no ka9q_radio_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    import ka9q_radio_tpu_torch as port
    import ka9q_radio_tpu_torch.runtime as rt
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft

    if Path(port.__file__).resolve().parent != ROOT / "ka9q_radio_tpu_torch":
        fail(f"imported {port.__file__}, not this checkout's package")
    device = torch.device("cuda")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)

    # phase 1: the card, then the kernels' build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip() if smi else "unknown"
    print(card, flush=True)
    built = cc.build()
    (out_dir / "build.log").write_text("\n".join(f"== {k}\n{v}" for k, v in built["log"].items()))
    ptxas = [ln.strip() for v in built["log"].values() for ln in v.splitlines()
             if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": built["seconds"], "built": built["built"],
          "ptxas": ptxas, "torch": torch.__version__, "cuda": torch.version.cuda})

    # phase 2: kernels against their plain versions at the rx888 shapes
    t0 = time.perf_counter()
    eng = rt.Engine(samprate=FS, real=True, groups=rx888_groups(rt))
    params = eng.init_params()
    emit({"phase": "engine", "seconds": time.perf_counter() - t0, "L": eng.L, "N": eng.master.N,
          "bins": eng.master.bins,
          "groups": {n: {"C": g.C, "n_bins": g.n_bins, "olen": g.olen} for n, g in eng.groups.items()}})
    gen = torch.Generator(device=device).manual_seed(0)
    blk = 0.05 * torch.randn(eng.L, generator=gen, device=device)
    _, F = master_fft(eng.master, eng.init_state()["master"], blk)
    kernels = check_kernels(eng, params, F)
    cplx = check_complex_master(device)
    emit({"phase": "kernels_vs_plain", "channelize_max_abs_err": kernels[0]["max_abs_err"],
          "channelize_bound": kernels[0]["err_bound"], "noise_keys_equal": True,
          "noise_max_rel_err": kernels[1]["max_rel_err"], "complex_master": cplx})
    del F
    big = check_hf32000(device)
    emit({"phase": "kernels_hf32000", "card": card, **big})
    for kern in kernels:
        kern["at_hf32000"] = big[kern["name"]]

    # phase 3: known-answer scene through the main path
    sc = run_scene(eng, params, device)
    emit({"phase": "scene", **sc})
    if abs(sc["peak_k_hz"] - sc["tone_k_offset_hz"]) > 10.0:
        fail(f"channel {sc['k']} audio peaks at {sc['peak_k_hz']} Hz, want {sc['tone_k_offset_hz']}")
    if sc["rejection_db_lower_bound"] < 60.0:
        fail(f"opposite-sideband rejection {sc['rejection_db_lower_bound']} dB < 60 dB")
    if abs(sc["n0_median_dev_db"]) > 1.0 or sc["n0_frac_within_1db"] < 0.95:
        fail(f"N0 off the calibrated {N0_SCENE}: median {sc['n0_median_dev_db']} dB, "
             f"{sc['n0_frac_within_1db']} of channels within 1 dB")
    if sc["launches"] != {"channelize": sc["blocks"], "noise_est": sc["due_blocks"]}:
        fail(f"launch counts {sc['launches']}: want channelize {sc['blocks']}, "
             f"noise_est {sc['due_blocks']}")
    if not sc["sweep_finite"] or sc["sweep_shape"] != [16, 128]:
        fail("sweep bins not finite or of the wrong shape")
    if abs(sc["retune_peak_hz"] - sc["retune_expected_hz"]) > 10.0:
        fail(f"retuned channel peaks at {sc['retune_peak_hz']} Hz, want {sc['retune_expected_hz']}")
    if sc["retune_rebuilt"]:
        fail(f"retune reallocated {sc['retune_rebuilt']}")
    for kern in kernels:
        kern["launches"] = sc["launches"][kern["name"]]

    # phase 4: sustained rate over distinct random blocks, no host syncs
    tr = timed_run(eng, params, device)
    emit({"phase": "timed", "card": card, **tr})
    if tr["launches"] != {"channelize": tr["blocks"], "noise_est": tr["due_blocks"]} \
            or not tr["finite"]:
        fail(f"timed run: launches {tr['launches']}, finite {tr['finite']}")
    # where the time goes: each stage alone (CUDA events), then the device's
    # kernel time inside the step (profiler) against the block time above
    split = stage_split(eng, params, device)
    busy = device_busy(eng, params, device, out_dir)
    idle = (None if busy["busy_ms_per_block"] is None
            else 1.0 - busy["busy_ms_per_block"] / tr["ms_per_block"])
    emit({"phase": "stages", "card": card, **split, **busy, "device_idle_share": idle})
    for kern in kernels:
        kern["in_step_ms"] = busy["kernel_in_step_ms_per_launch"][kern["name"]]

    # phase 5: the daemon at full width (the port's Radiod over its Engine)
    dmn, at_daemon = run_daemon(card, device)
    emit(dmn)
    for kern in kernels:
        kern["daemon_launches"] = at_daemon[kern["name"]]["launches"]
        kern["at_daemon"] = at_daemon[kern["name"]]

    if "jax" in sys.modules or any(n == "ka9q_radio_tpu" or n.startswith("ka9q_radio_tpu.")
                                   for n in sys.modules):
        fail("the port pulled in jax or the JAX package")
    emit({"kernels": kernels, "card": card})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
