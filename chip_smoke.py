#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (ka9q_radio_tpu_torch).

Usage, from the root of a checkout, on a host with one NVIDIA GPU (sm_90a)
and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's CUDA kernels from csrc/, holds each against its plain
PyTorch version at the rx888 shapes and at the hf32000 shapes (32,000
channels, from tile params built directly), times each (CUDA events
around a CUDA graph of n calls, beside its bound, its plain version and
one PyTorch call as a yardstick, all timed alike), drives the rx888
configuration (129.6 Msps real input, 1,000 SSB channels at 12 kHz with
SNR squelch, a 16-channel wide spectrum sweep) through Engine.step on a
known-answer scene, times 64 distinct random blocks, and splits the block
time by stage and by kernel (CUDA events, torch.profiler), with each
kernel's device time inside the step. Then it
runs the daemon (Radiod) on the card at full width: the
examples/radiod@rx888-wspr.conf HF farm (about 32,700 usb channels with SNR
squelch, egress-slots 512, time-shards 8, the native edge) fed by a
sig_gen carrier, its RTP received on a local UDP socket, a retune command
fed through Radiod.handle_packet, and both kernels checked, timed and
counted at the daemon's own shapes. Then the VHF demodulators: both kernels
at bench.py's nbfm400 shapes (400 NBFM channels on a complex 30.72 Msps
master) and kernel B at its wfm shapes (8 stations on 7.68 Msps, a
9,600-bin window), the PLL and Goertzel recurrence kernels against their
plain loops; nbfm400 through Engine.step (a 1 kHz FM tone, a quiet
channel's squelch, 64 timed blocks), wfm (stereo separation, the mono
fallback, 64 timed blocks), and examples/radiod@2m.conf through Radiod
(CTCSS open and mute, a switch to sam that locks its PLL, a switch to isb,
a 50 Hz spectrum channel polled). Then several inputs, odd masters and
beamforming: bench.py's rx888x4 (four 129.6 Msps real streams, one group
of 4,000 SSB channels over all four: both kernels with input offsets
against their plain versions, a tone on one stream's channel heard there
only, 64 timed steps, a trace), an RTL-SDR's 2.4 Msps complex master
(N 60,000: the per-element channelizer on cuFFT, kernel B on per-element
windows, an FM known answer), tests/test_beam.py's dual-antenna scene,
and the daemon on two [hardware] sig_gen sections (the rx888-wspr farm on
one, a usb section on the other: each carrier heard on its own input
only, the per-input IF power in the status). Last, the client side:
fft-gen-torch's cold start of the rx888-wspr config (a subprocess),
pcmrecord-torch (a subprocess) recording the carrier of the daemon phase's
farm, and stereod-torch's decode on the card against its CPU path, timed,
then its CLI over 127.0.0.1. Before the clients, the sharded engine (the
`mesh` phase) on D = 4 and 8 shards of the one card ([cuda:0] * D: one
process over a list of devices, the corner turns and gathers as copies on
the card): the flagship parity drive (sharded against single-device over
10 blocks with a retune and a table grow), kernels A and B on every shard's
local rows against their plain versions and by the port's launch
counters (D launches of each a block), the sharded step as CUDA graph
replays beside its eager step (12 blocks bit for bit with a retune and the
sweep disarmed, the launch counts equal; ms, enqueue ms and the device's
idle share each way), step_time at D = 8 (the halo tail exact, the outputs
against 8 steps; as graph replays against the eager step_time, bit for
bit), radiod-torch with `mesh = yes` on examples/radiod@mesh-rx888.conf
twice (its own make_mesh(), and 4 shards; every dispatch a graph replay),
and the sharded step's ms beside the single-device step's. It checks no
peer copy between cards and no shards running at once. Then a mesh of two
processes (the `multihost` phase): this script started twice as
`--multihost-worker`, each process with 2 shards of the card, joined by
torch.distributed over gloo (the pieces that cross processes staged
through host memory; NCCL refuses two processes on one card): the flagship
parity drive on each process's rows, the time-shard halo across the
process boundary, A and B 2 times a block in each process (by the
counters) and against their plain versions on its rows, 8 timed steps with
the bytes that cross processes. Then the `churn` phase:
tools/churn_soak_torch.py on the card for 45 s with 4 spares a class (no
foreground rebuild, no dropped block, RSS and device memory flat, at least
one background restock swapped in). Then the `ingest` phase, the RTP A/D
front end on the card: the raw loopback ceiling (tools/bench_ingest_torch.py
raw: the native paced sender ingest_blast into the native reader, 8,192- and
704-frame packets, every frame held to the sender's ramp), the copy of one
flagship dispatch to the card, then examples/radiod@rx888-wspr.conf with its
[adc] stream fed by ingest_blast at 129.6 Msps and examples/radiod@2m.conf's
complex 5.12 Msps [vhf-feed] (the first timed dispatch's block on the card
equal to the ramp bit for bit, A and B by their counters, finite outputs,
the channels' RTP audio, the frames sent = read + dropped + still
buffered; achieved Msps, margin, block times and the host split reported).
Then the `graphs` phase, the compiled dispatch (runtime/graphs.py GraphStep:
each dispatch one CUDA graph replay, the twin of the JAX package's jit):
bench.py's rx888, rx888x4, nbfm400, wfm, hf32000 and linear8 and the odd
master, each as graph replays beside its eager step from the same state
(12 blocks bit for bit with a retune and the sweep disarmed, the launch
counts equal; ms and enqueue ms a block each way, the device's idle share,
captures, capture ms, pool MB, eager blocks by reason), and
profile_latency_torch at time-shards 0, 4 and 16 (its daemon's dispatch as
graph replays). Every daemon phase dispatches as graph replays, the mesh
daemons' included.
Then the `tools` phase, the measuring kit: bench_torch.measure on six of
bench.py's configurations (rx888, rx888x16, hf32000, nbfm400, wfm, linear8:
finite output, A and B by the counters, peak device memory),
tools/bench_highc_torch.py for 10 s in a subprocess (it must exit 0), and
tools/prof_master_torch.py's ablation on 1 and 4 shards of the card.
Then the `control` phase, the daemon's control plane on the card: the
rx888-wspr farm (its own Radiod, every dispatch a graph replay) driven on
the carrier's channel through a doppler ramp (the tone's pitch walks at the
commanded rate, within 10 Hz a dispatch, and returns to 1,500 Hz when the
ramp is cancelled), KAISER_BETA and GAIN (the same engine and graphs; the
output 16.99 dB over the baseband power at GAIN = 20), MAXDELAY = 3 (the
group leaves the native edge, each flush carries 3 x 240 samples, the
tone's phase continuous over every join) and a preset switch to lsb (a
rebuild, its graphs captured, the tone at 1,500 Hz); then
tests/test_control_plane.py's config and command script run by two daemons
on the card, one as graph replays and one whose _mk_step gives the eager
step, their packets held to each other, kernels A and B counted in each
(equal) and held against their plain versions at both configs' shapes.
Last, the `calibration` phase, what the radio reports held to the physics of
a known scene: the rx888 master at full width with, beside the `hf` group,
an `iq` group (16 kHz, AGC off, +/-6 kHz) and a `stop` group (+/-5 kHz at 12
kHz, Kaiser beta 11), as graph replays on noise of a known density with
carriers on master bin centres (N0 within 1 dB on every channel of both
groups, the white-noise gain within 5% of 2 B/fs x the input variance, a
carrier 3 kHz past a +/-5 kHz edge at least 60 dB down, SNR within 0.75 dB
of analytic and the carrier within 0.1 dB); tests/test_engine.py's 2,000 FM
channels as graph replays; kernels A and B at those shapes against their
plain versions; and two daemons on the card in spectrum-format = byte and =
rice polled on one sweep, their levels equal. `python3 chip_smoke.py
--calibration` builds the kernels and runs this phase alone.
Last, the `examples` phase, the shipped deployments as users start them:
examples/radiod@siggen.conf (its own sig_gen: the AM tone), @aviation.conf
(a cf32le capture: an AM carrier on the tower's 118.3 MHz that stops
halfway; amsq opens there only, closes within squelch-tail + 3 blocks, the
prealloc = amsq pool silent), @hf-generic.conf (an s16be capture: WSPR,
FT8 and 10m-FM tones each on its own channel and its section's own data
stream, W1AW disabled), @spectrum.conf (a sig_gen: the byte-format survey
on the carrier's bin and the scene's noise density, neither kernel
launched) and @fm.conf (a cs16le capture: stereo separation, the RDS PI
code from the companion stream, a mono station), each through Radiod at
its full rate and channel set beside a second daemon on the eager step
(packets byte for byte), A and B by the counters and against their plain
versions at every group's shape; then the four RTP-fed ones fed by
ingest_blast at their own rate. The captures are written by numpy from a
seed into a temporary directory. `python3 chip_smoke.py --examples` runs
this phase alone.

Kernel times come from CUDA events around a CUDA graph of n calls (a call
that cannot be captured: n back-to-back calls, named in its phase's line),
launch counts from the port's counters (`launches[...]`), never from a
trace. torch.profiler (CUDA activity alone) gives the step and daemon
breakdowns only; a trace that kept fewer kernel events than the counters
saw is a note in that line, not a failure. Each phase prints one JSON
line; the kernels line and the card's `nvidia-smi` name and power limit
come before the last line, which is
{"ok": true, "device": {...}}. Any failed phase exits non-zero, and so does
a CUDA graph capture that recorded nothing (a "The CUDA Graph is empty"
warning, counted in the kernels line). Long logs go to chiprun_out/. It
imports nothing of JAX.
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


T_START = time.perf_counter()


def emit(obj: dict) -> None:
    """One JSON line; a phase's line says how its event_ms calls were timed,
    and when it ended (t_s: seconds since the script started)."""
    if "phase" in obj and (TIMING["graph"] or TIMING["back_to_back"]):
        obj = {**obj, **timing_note()}
    if "phase" in obj:
        obj = {**obj, "t_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def rx888_groups(rt, B: int = 1):
    """bench.py's rx888 configuration, in the port's specs; B > 1 gives its
    rx888x<B>: one group of 1,000 SSB channels on each of B streams
    (per-channel inputs), the 16-channel sweep on stream 0."""
    ChannelSpec, GroupSpec = rt.ChannelSpec, rt.GroupSpec
    freqs = np.linspace(0.02 * FS, 0.48 * FS, 1000)
    sfreqs = np.linspace(0.05 * FS, 0.45 * FS, 16)
    return [
        GroupSpec(name="hf", demod="linear", samprate=12_000, snr_squelch=True,
                  channels=tuple(ChannelSpec(freq=float(f), low=50.0, high=3000.0,
                                             input=b if B > 1 else None)
                                 for b in range(B) for f in freqs)),
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


# how event_ms timed each call (a CUDA graph, or back-to-back calls where a
# call cannot be captured) and the profiler sessions of the run, for the
# kernels line
TIMING: dict = {"graph": 0, "back_to_back": 0, "uncaptured": []}
PROFILER = {"sessions": 0}


def event_ms(fn, n: int = 20, warm: int = 3, what: str = "") -> float:
    """Device ms of one call of fn: n calls captured in one CUDA graph,
    replayed between two CUDA events, over n (the launches' host gaps are
    not in it). A call that cannot be captured (a host sync) is timed as n
    back-to-back calls between the two events instead (its host launch gaps
    in it), and `what` goes to TIMING["uncaptured"]. A call known not to be
    capturable before it enqueues anything (a pageable copy, which torch
    refuses at once, leaving the capture empty) takes _back_to_back_ms."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture (cuFFT plans, the allocator)
        for _ in range(warm):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    # the capture by hand (not torch.cuda.graph): a call that breaks it
    # still ends the capture and leaves the capture stream
    graph, err = torch.cuda.CUDAGraph(), None
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            for _ in range(n):
                fn()
        except Exception as e:  # noqa: BLE001 - the call is timed without a graph below
            err = e
        try:
            graph.capture_end()
        except Exception as e:  # noqa: BLE001
            err = err or e
    torch.cuda.synchronize()
    if err is not None:
        TIMING["uncaptured"].append(f"{what or getattr(fn, '__name__', '?')}: "
                                    f"{type(err).__name__}: {str(err)[:120]}")
        return _back_to_back_ms(fn, n, warm)
    graph.replay()
    torch.cuda.synchronize()
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    TIMING["graph"] += 1
    return e0.elapsed_time(e1) / n


def _back_to_back_ms(fn, n: int, warm: int) -> float:
    """event_ms without a graph: n calls back to back between two events."""
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    TIMING["back_to_back"] += 1
    return e0.elapsed_time(e1) / n


# every "The CUDA Graph is empty" warning of the run, by the script's frames
# that led to it: a capture that recorded nothing is a timing or a graph
# dispatch that measured nothing
EMPTY_GRAPHS: list = []


def watch_empty_graphs() -> None:
    import traceback
    import warnings

    warnings.filterwarnings("always", message="The CUDA Graph is empty")
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if "The CUDA Graph is empty" in str(message):
            EMPTY_GRAPHS.append([f"{Path(f.filename).name}:{f.lineno} {f.name}"
                                 for f in traceback.extract_stack()[:-1]][-6:])
        shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show


def timing_note() -> dict:
    """How this phase's event_ms calls were timed (then cleared): for a
    phase's JSON line."""
    note = {"timing": "CUDA events around a CUDA graph of n calls, over n",
            "graph_timed": TIMING["graph"], "back_to_back_timed": TIMING["back_to_back"],
            "uncaptured": TIMING["uncaptured"]}
    TIMING.update(graph=0, back_to_back=0, uncaptured=[])
    return note


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


def tile_rows(tile_lo: np.ndarray, S: int, m) -> np.ndarray:
    """[C, S/128] master tile rows of each channel's gather (kernel A's
    input): clipped to a real master's half spectrum, wrapped through DC on
    a complex one (ops/filterbank.py tiled_channelize)."""
    from ka9q_radio_tpu_torch.ops.filterbank import _CTILE

    r = np.asarray(tile_lo, np.int64)[:, None] + np.arange(S // _CTILE)
    if m.real:
        return np.clip(r, 0, -(-m.bins // _CTILE) - 1)
    return np.remainder(r, m.bins // _CTILE)


def window_bins(shifts: np.ndarray, nbins: int, m) -> np.ndarray:
    """[C, W] master bins of each channel's noise window (kernel B's input),
    placed as ops/noise.py gather_noise_bins places them: W = nbins rounded
    up to whole 128-bin tiles on the 128-bin grid where the master allows
    it, else W = nbins at any start (per-element)."""
    from ka9q_radio_tpu_torch.ops.filterbank import _CTILE
    from ka9q_radio_tpu_torch.ops.noise import noise_window_fits

    tiled = noise_window_fits(nbins, m.real, m.N)
    W = -(-nbins // _CTILE) * _CTILE if tiled else nbins
    sh = np.asarray(shifts, np.int64)
    if m.real:
        lo = np.clip(np.abs(sh) - W // 2, 0, max(m.bins - W, 0))
    else:
        lo = np.minimum(np.maximum(sh - W // 2, -(m.bins // 2)), (m.bins - 1) // 2 - (W - 1))
    if tiled:
        lo = lo // _CTILE * _CTILE
    idx = lo[:, None] + np.arange(W)
    return np.clip(idx, 0, m.bins - 1) if m.real else np.remainder(idx, m.bins)


def unique_count(idx: np.ndarray, inputs: "np.ndarray | None", stride: int) -> int:
    """Distinct master bins (or tile rows) of [C, k] per-input indices: the
    bytes a kernel must read, each once (inputs None: one spectrum)."""
    if inputs is not None:
        idx = idx + np.asarray(inputs, np.int64)[:, None] * stride
    return len(np.unique(idx))


def check_kernels(eng, params, F, group: str = "hf") -> list[dict]:
    """Each kernel of `group`'s path against its plain version at the shapes
    the main path gives it: kernel A where the group has an IDFT constant
    (a slice that takes the FFT-IDFT form, WFM's, does not launch it), then
    kernel B."""
    g = eng.groups[group]
    return ([check_kernel_a(eng, params, F, group)] if g.tile_E is not None else []) \
        + [check_kernel_b(eng, params, F, group)]


def check_kernel_a(eng, params, F, group: str) -> dict:
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import _CTILE, tiled_channelize

    g, p, m = eng.groups[group], params[group], eng.master
    C, S = p["resp_tiles"].shape
    olen, inp = g.olen, g.inputs_t

    def kern_a():
        return cc.cuda_channelize(F, p["resp_tiles"], p["tile_lo"], p["slope"], p["shifts"],
                                  g.tile_E, g.n_bins, olen, m.real, m.N, E_op=g.tile_op,
                                  inputs=inp)

    def plain_a():
        return tiled_channelize(F, p["resp_tiles"], p["tile_lo"], p["slope"], p["shifts"],
                                g.tile_E, g.n_bins, olen, m.real, m.N, inputs=inp)

    got, want = kern_a(), plain_a()
    err_a = float((got - want).abs().max())
    scale_a = float(want.abs().max())
    c128 = [t.to(torch.complex128) for t in (F, p["resp_tiles"], g.tile_E)]
    exact = tiled_channelize(c128[0], c128[1], p["tile_lo"], p["slope"], p["shifts"], c128[2],
                             g.n_bins, olen, m.real, m.N, inputs=inp)
    err_a64 = float((got.to(torch.complex128) - exact).abs().max())
    if not err_a < 3e-5 * scale_a:
        fail(f"channelize kernel disagrees: max abs err {err_a} vs bound {3e-5 * scale_a}")
    # library yardstick: one complex GEMM of the gathered, filtered bins by E
    # (several inputs: the rows of each channel's own input, ld bins apart)
    nrows = -(-m.bins // _CTILE)
    rows = tile_rows(g.host["tile_lo"], S, m)
    if inp is None:
        Fp = torch.nn.functional.pad(F, (0, nrows * _CTILE - m.bins)).reshape(nrows, _CTILE)
        flat = rows
    else:
        Fp = F.reshape(-1, _CTILE)
        flat = rows + g.inputs.astype(np.int64)[:, None] * (F.shape[-1] // _CTILE)
    x = Fp[torch.as_tensor(flat, device=F.device)].reshape(C, S) * p["resp_tiles"]
    lib_a = event_ms(lambda: torch.matmul(x, g.tile_E), what="torch.matmul, A's yardstick")
    nb_a, nops_a = counts_a(C, S, g.n_bins, olen, len(np.unique(flat)))
    # A alone after a 64 MB write has evicted L2 (E's operand, the
    # responses, F): how much of its in-step time L2 misses explain
    flush = torch.empty(16 << 20, dtype=torch.float32, device=F.device)
    cold_a = (event_ms(lambda: (flush.fill_(1.0), kern_a()), what="L2 flush + channelize")
              - event_ms(lambda: flush.fill_(1.0), what="L2 flush"))
    return {"name": "channelize", "route": "cuda", "source": cc.SOURCES["channelize"],
            "replaces": cc.REPLACES["channelize"], "launches": 0, "max_abs_err": err_a,
            "err_bound": 3e-5 * scale_a, "max_abs_err_vs_f64_sum": err_a64,
            "ms": event_ms(kern_a, what="channelize"),
            "plain_ms": event_ms(plain_a, what="tiled_channelize"), "call_ms": time_ms(kern_a),
            "ms_cold_l2": cold_a, **bound_a(nb_a, nops_a), "library_ms": lib_a,
            "library_call": "torch.matmul(gathered x [C, S] c64, E [S, olen] c64)",
            "bytes": nb_a, "ops": nops_a,
            "shape": {"C": C, "S": S, "n": g.n_bins, "olen": olen,
                      **({"inputs": eng.n_inputs, "ld": F.shape[-1]} if inp is not None else {})}}


def check_kernel_b(eng, params, F, group: str) -> dict:
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.noise import (estimate_noise_keys, gather_noise_bins,
                                                noise_window_fits)

    g, p, m = eng.groups[group], params[group], eng.master
    C, inp = p["shifts"].shape[0], g.inputs_t

    def kern_b():
        return cc.cuda_noise_est(F, p["shifts"], g.noise_bins, m.real, m.N, eng.samprate,
                                 inputs=inp)

    def plain_b():
        return estimate_noise_keys(
            gather_noise_bins(F, p["shifts"], g.noise_bins, m.real, m.N, inp), m.bins,
            eng.samprate)

    (n0_k, keys_k), (n0_t, keys_t) = kern_b(), plain_b()
    if not torch.equal(keys_k, keys_t):
        bad = int((keys_k != keys_t).any(-1).sum())
        fail(f"noise kernel order-statistic keys differ from the plain version on {bad} channels")
    rel_b = float(((n0_k - n0_t).abs() / n0_t.abs()).max())
    if not rel_b <= 2e-5:
        fail(f"noise kernel N0 disagrees: max rel err {rel_b} > 2e-5")
    win = window_bins(g.host["shifts"], g.noise_bins, m)
    W = win.shape[1]
    bb = bound_b(*counts_b(C, W, unique_count(win, g.inputs if inp is not None else None,
                                              F.shape[-1])))
    energies = gather_noise_bins(F, p["shifts"], g.noise_bins, m.real, m.N, inp)
    i_stat = int(np.floor(0.10 * (W - 1)))
    lib_b = event_ms(lambda: torch.kthvalue(energies, i_stat + 1, dim=-1),
                     what="torch.kthvalue, B's yardstick")
    return {"name": "noise_est", "route": "cuda", "source": cc.SOURCES["noise_est"],
            "replaces": cc.REPLACES["noise_est"], "launches": 0,
            "max_abs_err": float((n0_k - n0_t).abs().max()), "max_rel_err": rel_b,
            "keys_equal": True, "ms": event_ms(kern_b, what="noise_est"),
            "plain_ms": event_ms(plain_b, what="estimate_noise_keys"),
            "call_ms": time_ms(kern_b), **bb, "library_ms": lib_b,
            "library_call": "torch.kthvalue(gathered |F|^2 [C, W], i + 1): statistic i only",
            "shape": {"C": C, "W": W,
                      "window": ("tile-aligned" if noise_window_fits(g.noise_bins, m.real, m.N)
                                 else "per-element"),
                      **({"inputs": eng.n_inputs, "ld": F.shape[-1]} if inp is not None else {})}}


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
    a = {"C": C, "max_abs_err": err_a, "err_bound": 3e-5 * scale_a,
         "ms": event_ms(kern_a, what="channelize"),
         "plain_ms": event_ms(plain_a, n=5, what="tiled_channelize"),
         "library_ms": event_ms(lambda: torch.matmul(x, E), what="torch.matmul, A's yardstick"),
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
    b = {"C": C, "keys_equal": True, "max_rel_err": rel_b,
         "ms": event_ms(kern_b, what="noise_est"),
         "plain_ms": event_ms(plain_b, n=5, what="estimate_noise_keys"),
         "library_ms": event_ms(lambda: torch.kthvalue(energies, i_stat + 1, dim=-1),
                                what="torch.kthvalue, B's yardstick"), **bb}
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


def peak_hz(audio, rate: float, above: float = 0.0) -> float:
    """The audio's strongest frequency (Hann window, 8x zero padding),
    above `above` Hz (an AM envelope's DC term is not its tone)."""
    a = np.asarray(audio, np.float64)
    n = 8 * a.size
    spec = np.abs(np.fft.rfft(a * np.hanning(a.size), n))
    f = np.fft.rfftfreq(n, 1.0 / rate)
    spec[f < above] = 0.0
    return float(f[int(np.argmax(spec))])


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
    # the rx888 path's kernels (it runs no PLL or CTCSS recurrence)
    launches = {k: cc.launches[k] for k in MAIN_KERNELS}
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


def noise_blocks(eng, n: int, n0: float, device, seed: int) -> torch.Tensor:
    """[n, L] blocks ([n, B, L] for an engine of B inputs) of white noise of
    density n0 (power/Hz) for eng's master: float32 for a real one,
    complex64 for a complex one."""
    gen = torch.Generator(device=device).manual_seed(seed)
    std = float(np.sqrt(n0 * eng.samprate / 2.0))
    shape = (n, eng.n_inputs, eng.L) if eng.n_inputs > 1 else (n, eng.L)
    if eng.master.real:
        return std * torch.randn(shape, generator=gen, device=device)
    return torch.view_as_complex(std * torch.randn(shape + (2,), generator=gen, device=device))


def outputs_finite(out: dict) -> bool:
    """Every group's audio, and its spectrum bins where it has them, finite."""
    return all(bool(torch.isfinite(o["audio"]).all())
               and bool(torch.isfinite(o["info"].get("bin_data", torch.zeros(0))).all())
               for name, o in out.items() if not name.startswith("_"))


def timed_run(eng, params, device, n0: float = N0_SCENE, nblocks: int = 64, warm: int = 4,
              seed: int = 2) -> dict:
    """nblocks distinct noise blocks of density n0 through step under
    sync-debug "error" (any device->host sync raises), timed with CUDA
    events; every group's outputs finite."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    blocks = noise_blocks(eng, warm + nblocks, n0, device, seed)
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
    return {"blocks": nblocks, "inputs": eng.n_inputs, "ms_per_block": ms,
            "host_enqueue_ms_per_block": host_ms,
            "msps": eng.n_inputs * eng.L / (ms * 1e-3) / 1e6,
            "realtime_factor": eng.L / (ms * 1e-3) / eng.samprate,
            "launches": {k: cc.launches[k] for k in MAIN_KERNELS},
            "due_blocks": due, "finite": outputs_finite(out),
            "if_power_shape": list(out["_frontend"]["if_power"].shape)}


def stage_split(eng, params, device) -> dict:
    """Each stage of one steady rx888 block timed alone, as device time
    (event_ms: a CUDA graph of the stage) and as wall time on the card's
    clock (CUDA events, launch overhead included): master FFT, kernel A,
    kernel B, the hf group's demod tail (N0 EMA, fine tune, AGC, squelch),
    the sweep."""
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
    return {"stage_device_ms": {k: event_ms(f, what=k) for k, f in stages.items()},
            "stage_wall_ms": {k: time_ms(f) for k, f in stages.items()}}


# the main path's kernels (A, B and the linear tail): the phases count their
# launches; their device names in a trace
MAIN_KERNELS = ("channelize", "noise_est", "linear_tail")
KERNEL_NAMES = (("channelize", "channelize_kernel"), ("noise_est", "noise_kernel"),
                ("linear_tail", "linear_tail_kernel"))
RECUR_NAMES = (("pll_scan", "pll_scan_kernel"), ("goertzel", "goertzel_kernel"))


def traced(body, what: str):
    """body() under torch.profiler, CUDA activity alone: (the profile, its
    device events, body's wall ms, a note). The note gives the kernel events
    the trace kept beside the launches the port's counters saw in body; a
    trace that kept fewer is a measurement note, never a failure (a session
    now and then loses events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    torch.cuda.synchronize()
    before = dict(cc.launches)
    PROFILER["sessions"] += 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        body()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    expected = {k: cc.launches[k] - before[k] for k in before}
    kept = {name: sum(1 for ev in kern if sub in ev.name)
            for name, sub in KERNEL_NAMES + RECUR_NAMES}
    note = {"trace_events": len(kern), "trace_kept": kept, "trace_expected": expected,
            "trace_complete": all(kept[k] >= expected[k] for k in kept)}
    if not kern or not note["trace_complete"]:
        print(f"chip_smoke: {what}: the trace kept {kept} kernel events of the {expected} "
              "launches counted (a measurement note)", file=sys.stderr, flush=True)
    return prof, kern, wall, note


def per_launch_ms(kern, names) -> dict:
    """Each named kernel's mean device ms a launch among the events kern
    (None where it did not launch)."""
    out = {}
    for name, sub in names:
        evs = [ev for ev in kern if sub in ev.name]
        out[name] = (sum(ev.time_range.elapsed_us() for ev in evs) / 1e3 / len(evs)
                     if evs else None)
    return out


def device_busy(eng, params, device, out_dir: Path, n0: float = N0_SCENE, nblocks: int = 8,
                seed: int = 4, trace: str = "step_trace.json") -> dict:
    """Kernel time per steady block from a torch.profiler trace of nblocks
    steps of noise of density n0: the device's busy time, its kernel count,
    the kernels that take most of it, and each kernel of KERNEL_NAMES's
    time a launch inside the step. The trace goes to out_dir/trace."""
    blocks = noise_blocks(eng, 8 + nblocks, n0, device, seed)
    state = eng.init_state()
    for b in range(8):
        state, _ = eng.step(state, params, blocks[b])

    def body():
        nonlocal state
        for b in range(8, 8 + nblocks):
            state, _ = eng.step(state, params, blocks[b])

    prof, kern, _, note = traced(body, trace)
    prof.export_chrome_trace(str(out_dir / trace))
    by_name: dict[str, float] = {}
    for ev in kern:
        by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.elapsed_us() / 1e3 / nblocks
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"blocks": nblocks, "kernels_per_block": len(kern) / nblocks,
            "busy_ms_per_block": sum(by_name.values()),
            "kernel_in_step_ms_per_launch": per_launch_ms(kern, KERNEL_NAMES),
            "top_ms_per_block": [[name[:80], ms] for name, ms in top], **note}


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


def run_daemon(card: str, device) -> tuple[dict, dict, object]:
    """The daemon at full width on the card: warm-up, ~256 blocks flat out
    while the carrier's RTP is received, a +500 Hz retune command through
    handle_packet, 64 more blocks; then a profiled dispatch (each kernel's
    time inside the daemon) and both kernels against their plain versions
    at the daemon's shapes. Returns (the phase's JSON, per-kernel data, the
    daemon, its native edges open)."""
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
           "launches": launches, "due_blocks": due, "graphs": daemon_graphs(rd)}
    if abs(peak1 - 1500.0) > 10.0:
        fail(f"daemon: the carrier's channel peaks at {peak1} Hz, want 1500")
    if not send_k or n1 == 0:
        fail("daemon: the carrier's channel did not open its squelch")
    if abs(peak2 - 1000.0) > 10.0:
        fail(f"daemon: after the +500 Hz retune the tone is at {peak2} Hz, want 1000")
    if rd.egress_overflows or rd.block_drops or max_count[0] >= g.spec.egress_slots // 4:
        fail(f"daemon: overflows {rd.egress_overflows}, drops {rd.block_drops}, "
             f"egress count up to {max_count[0]} of {g.spec.egress_slots}")
    want_tail = (blocks + 8 * D) * fused_groups(rd.engine)
    if launches["channelize"] != blocks + 8 * D or launches["noise_est"] != due \
            or launches["linear_tail"] != want_tail:
        fail(f"daemon: launch counts {launches}, want channelize {blocks + 8 * D}, "
             f"noise_est {due}, linear_tail {want_tail}")

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
    _, kern, wall, note = traced(lambda: [rd.step_block() for _ in range(2)], "daemon")
    busy = sum(ev.time_range.elapsed_us() for ev in kern) / 1e3
    in_daemon = per_launch_ms(kern, KERNEL_NAMES)
    out.update({"profiled_blocks": 2 * D, "device_busy_ms_per_block": busy / (2 * D),
                "wall_ms_per_block_profiled": wall / (2 * D),
                "device_idle_share": 1.0 - busy / wall, "kernel_in_daemon_ms": in_daemon,
                **note})
    rx.close()  # the clients phase's pcmrecord-torch takes the data port
    rd._siggen = carrier_gen  # and records the carrier alone

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
    per_kernel["linear_tail"] = {"C": g.C, "launches": launches["linear_tail"],
                                 "in_daemon_ms": in_daemon["linear_tail"]}
    out["kernels_at_daemon"] = per_kernel
    return out, per_kernel, rd  # the clients phase records rd, then closes its edges


# ------------------------------------------------------------ the VHF slice
VHF_FS = 30_720_000  # bench.py nbfm400: complex 30.72 Msps, 400 NBFM channels
WFM_FS = 7_680_000  # bench.py wfm: complex 7.68 Msps, 8 broadcast stations
NBFM_K, NBFM_QUIET = 137, 300  # the carrier's channel, a noise-only channel
NBFM_N0 = 1e-13  # noise density of the VHF scenes, power/Hz (-130 dBFS/Hz)
WFM_K = 5  # the station that carries the stereo composite
# the wfm scene: blocks with the pilot, then without; separation is read
# from block WFM_SETTLE of the stereo run on
WFM_STEREO_BLOCKS, WFM_MONO_BLOCKS, WFM_SETTLE = 26, 16, 6
PLL_OPS = 45  # FP32 operations of one PLL sample, sincosf and atan2f as one each


def nbfm400_groups(rt):
    """bench.py's nbfm400 configuration, in the port's specs."""
    freqs = np.linspace(-0.45 * VHF_FS, 0.45 * VHF_FS, 400)
    return [rt.GroupSpec(name="nbfm", demod="fm", samprate=24_000, channels=tuple(
        rt.ChannelSpec(freq=float(f), low=-8000.0, high=8000.0) for f in freqs))]


def wfm_groups(rt):
    """bench.py's wfm configuration, in the port's specs."""
    freqs = np.linspace(-3_000_000, 3_000_000, 8)
    return [rt.GroupSpec(name="wfm", demod="wfm", samprate=384_000, channels=tuple(
        rt.ChannelSpec(freq=float(f), low=-100_000.0, high=100_000.0) for f in freqs))]


def tone_amp_db(a: np.ndarray, f0: float, fs: float) -> float:
    """Amplitude of the tone near f0 in dB (Hann window, energy of the 9
    bins around it), as tests/test_reference_parity.py measures it."""
    n = a.size
    w = np.hanning(n)
    X = np.fft.rfft(a * w)
    k = int(np.argmin(np.abs(np.fft.rfftfreq(n, 1 / fs) - f0)))
    e = float(np.sum(np.abs(X[k - 4:k + 5]) ** 2))
    return float(20 * np.log10(2.0 * np.sqrt(e / (n * np.sum(w ** 2))) + 1e-15))


def recurrence_stand_in(device, C: int = 400) -> dict:
    """Inputs of pll_scan (T = 240, a SAM block at 12 kHz) and goertzel_block
    (T = 480, an NBFM block at 24 kHz) at C channels, from a seed: a shape
    that stands in for a wide SAM or CTCSS group, which no phase runs."""
    from ka9q_radio_tpu_torch.ops.iir import goertzel_coeff
    from ka9q_radio_tpu_torch.ops.osc import pll_params

    rng = np.random.default_rng(9)
    d = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    T = 240
    t = np.arange(T) / 12_000
    bb = np.logspace(-3, -0.5, C)[:, None] * np.exp(
        2j * np.pi * (rng.uniform(-20, 20, (C, 1)) * t + rng.uniform(0, 1, (C, 1))))
    bb = bb + 3e-4 * (rng.standard_normal((C, T)) + 1j * rng.standard_normal((C, T)))
    pll = {"vco_phase": d(rng.integers(-2**31, 2**31, C, dtype=np.int64).astype(np.int32)),
           "u": d(rng.uniform(-1e-3, 1e-3, C).astype(np.float32)),
           "phi": d(rng.uniform(-0.9, 0.9, C).astype(np.float32)),
           "wraps": d(rng.integers(-3, 3, C).astype(np.int32))}
    k1, k2 = pll_params(d(np.full(C, 20.0 / 12_000, np.float32)))
    coeff, _ = goertzel_coeff(d(rng.uniform(60, 260, C).astype(np.float32) / 24_000))
    gst = {"s0": d(rng.standard_normal(C).astype(np.float32)),
           "s1": d(rng.standard_normal(C).astype(np.float32))}
    return {"pll_scan": (d(bb.astype(np.complex64)), pll, k1, k2, d(np.arange(C) % 3 == 0),
                         d(np.arange(C) % 2 == 1)),
            "goertzel": (gst, d(rng.standard_normal((C, 2 * T)).astype(np.float32)), coeff)}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| / |want|, an exact match counting 0 (also where
    want is 0)."""
    diff = (got - want).abs()
    return float(torch.where(diff == 0, 0.0, diff / want.abs()).max())


def check_recurrences(args: dict) -> dict:
    """pll_scan and goertzel_block on `args` (their wrappers' inputs, as
    recurrence_stand_in gives them) against their plain loops on the card,
    each timed beside its bound and the loop's time."""
    from ka9q_radio_tpu_torch.models.linear import pll_scan_plain
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.cuda_recur import cuda_goertzel_block, cuda_pll_scan
    from ka9q_radio_tpu_torch.ops.iir import goertzel_update_block

    a_p = args["pll_scan"]
    C, T = a_p[0].shape
    kern_p = lambda: cuda_pll_scan(*a_p)  # noqa: E731
    plain_p = lambda: pll_scan_plain(*a_p)  # noqa: E731
    (mk, sk, gk, nk), (mp, sp, gp, np_) = kern_p(), plain_p()
    err_p = float((mk - mp).abs().max())
    dv = int(((sk["vco_phase"].long() - sp["vco_phase"].long() + 2**31) % 2**32 - 2**31)
             .abs().max())
    rel_s, rel_n = rel_err(gk, gp), rel_err(nk, np_)
    bit_p = (torch.equal(mk, mp) and all(torch.equal(sk[k], sp[k]) for k in sk)
             and torch.equal(gk, gp) and torch.equal(nk, np_))
    if not (err_p <= 1e-5 * float(mp.abs().max()) and dv <= 4096 and rel_s <= 1e-5
            and rel_n <= 1e-5 and torch.equal(sk["wraps"], sp["wraps"])):
        fail(f"pll_scan disagrees with its plain loop at C {C}, T {T}: mixed {err_p}, "
             f"VCO {dv} LSB, sums {rel_s} {rel_n}")
    # bytes: bb in, mixed out, the loop constants and flags, the state in
    # and out, the two sums; operations: PLL_OPS a sample
    nb_p = 2 * C * T * 8 + C * (4 + 4 + 1 + 1) + 2 * C * 16 + 2 * C * 4
    b_p, by_p = bound(nb_p, (C * T * PLL_OPS, FP32_OPS_S))

    a_g = args["goertzel"]
    C2, T2 = a_g[1].shape
    kern_g = lambda: cuda_goertzel_block(*a_g)  # noqa: E731
    plain_g = lambda: goertzel_update_block(*a_g)  # noqa: E731
    got, want = kern_g(), plain_g()
    err_g = max(float((got[k] - want[k]).abs().max()) for k in got)
    scale_g = max(float(want[k].abs().max()) for k in want)
    if not err_g <= 1e-5 * scale_g:
        fail(f"goertzel_block disagrees with its plain loop at C {C2}, T {T2}: "
             f"{err_g} vs {1e-5 * scale_g}")
    nb_g = C2 * T2 * 4 + 5 * C2 * 4  # x, coeff, the state in and out
    b_g, by_g = bound(nb_g, (3 * C2 * T2, FP32_OPS_S))
    return {
        "pll_scan": {
            "name": "pll_scan", "route": "cuda", "source": cc.SOURCES["pll_scan"],
            "replaces": cc.REPLACES["pll_scan"], "launches": 0, "max_abs_err": err_p,
            "err_bound": 1e-5 * float(mp.abs().max()), "vco_max_lsb": dv,
            "sums_max_rel_err": max(rel_s, rel_n), "bit_exact": bit_p,
            "ms": event_ms(kern_p, what="pll_scan"),
            "plain_ms": event_ms(plain_p, n=2, warm=1, what="pll_scan_plain"),
            "plain_call_ms": time_ms(plain_p, n=3, warm=1), "call_ms": time_ms(kern_p),
            "bound_ms": b_p, "bound_by": by_p, "bytes": nb_p, "ops": C * T * PLL_OPS,
            "ops_counted": f"{PLL_OPS} FP32 operations a sample, sincosf and atan2f one each",
            "library_ms": None, "shape": {"C": C, "T": T}},
        "goertzel": {
            "name": "goertzel", "route": "cuda", "source": cc.SOURCES["goertzel"],
            "replaces": cc.REPLACES["goertzel"], "launches": 0, "max_abs_err": err_g,
            "err_bound": 1e-5 * scale_g,
            "bit_exact": all(torch.equal(got[k], want[k]) for k in got),
            "ms": event_ms(kern_g, what="goertzel"),
            "plain_ms": event_ms(plain_g, n=2, warm=1, what="goertzel_update_block"),
            "plain_call_ms": time_ms(plain_g, n=3, warm=1), "call_ms": time_ms(kern_g),
            "bound_ms": b_g, "bound_by": by_g, "bytes": nb_g, "ops": 3 * C2 * T2,
            "library_ms": None, "shape": {"C": C2, "T": T2}},
    }


def nbfm400_scene(eng, params, device, nblocks: int = 16, k: int = NBFM_K,
                  quiet: int = NBFM_QUIET) -> dict:
    """Known answer through Engine.step: channel k carries a carrier FM-
    modulated by 1 kHz at 2.5 kHz deviation (the port's sig_gen), over noise
    of density NBFM_N0; channel `quiet` has noise only. Returns the
    carrier channel's audio peak over blocks 4.., each channel's send flags
    and the kernels' launches."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.source import SigGenConfig, siggen_block, siggen_init

    g = eng.groups["nbfm"]
    freqs = [c.freq for c in g.spec.channels]
    cfg = SigGenConfig(samprate=eng.samprate, real=False, carrier_hz=freqs[k],
                       amplitude=0.1, noise_n0=NBFM_N0, fm_deviation_hz=2500.0, tone_hz=1000.0)
    st = siggen_init(cfg, seed=8, device=device)
    state = eng.init_state()
    cc.reset_launches()
    audio, send_k, send_q = [], [], []
    for b in range(nblocks):
        st, blk = siggen_block(cfg, st, eng.L)
        state, out = eng.step(state, params, blk)
        o = out["nbfm"]
        audio.append(o["audio"][k])
        send_k.append(bool(o["info"]["send"][k]))
        send_q.append(bool(o["info"]["send"][quiet]))
    launches = dict(cc.launches)
    due = sum(1 for b in range(nblocks) if b < 2 or b % eng.noise_every == 0)
    return {"channel": k, "carrier_hz": freqs[k], "quiet_channel": quiet,
            "blocks": nblocks, "audio_shape": list(out["nbfm"]["audio"].shape),
            "peak_hz": peak_hz(torch.cat(audio[4:]).cpu().numpy(), g.spec.samprate),
            "send_carrier": send_k, "send_quiet": send_q,
            "finite": bool(torch.isfinite(out["nbfm"]["audio"]).all()),
            "launches": launches, "due_blocks": due}


def wfm_block(b: int, L: int, fs: float, f0: float, pilot: bool, gen, device) -> torch.Tensor:
    """Block b of a station at f0 carrying a stereo composite at 75 kHz peak
    deviation: L = 700 Hz, R = 1,100 Hz, the 19 kHz pilot (left out when
    `pilot` is false: the L-R subcarrier stays), over noise of NBFM_N0. The
    FM phase is the exact integral of the composite, in float64."""
    t = (torch.arange(L, dtype=torch.float64, device=device) + b * L) / fs
    tp = 2 * np.pi * t
    ph = 0.225 * (-torch.cos(700 * tp) / (2 * np.pi * 700) - torch.cos(1100 * tp) / (2 * np.pi * 1100))
    if pilot:
        ph = ph + 0.1 * -torch.cos(19e3 * tp) / (2 * np.pi * 19e3)
    # the L-R DSB (sin 700 - sin 1100) sin(38 kHz), integrated
    for f, sgn in ((700.0, 1.0), (1100.0, -1.0)):
        ph = ph + 0.225 * sgn * (torch.sin((f - 38e3) * tp) / (4 * np.pi * (f - 38e3))
                                 - torch.sin((f + 38e3) * tp) / (4 * np.pi * (f + 38e3)))
    phase = torch.remainder(f0 * t, 1.0) * (2 * np.pi) + 2 * np.pi * 75e3 * ph
    x = 0.1 * torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    std = float(np.sqrt(NBFM_N0 * fs / 2.0))
    return x + torch.view_as_complex(std * torch.randn((L, 2), generator=gen, device=device))


def wfm_scene(eng, params, device) -> dict:
    """Known answer through Engine.step: station WFM_K carries the stereo
    composite for WFM_STEREO_BLOCKS, then loses its pilot for
    WFM_MONO_BLOCKS. Separation is read over blocks WFM_SETTLE.. of the
    stereo run; the mono tones over the last 10 blocks."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    g = eng.groups["wfm"]
    f0 = g.spec.channels[WFM_K].freq
    gen = torch.Generator(device=device).manual_seed(10)
    state = eng.init_state()
    cc.reset_launches()
    audio, stereo = [], []
    for b in range(WFM_STEREO_BLOCKS + WFM_MONO_BLOCKS):
        blk = wfm_block(b, eng.L, eng.samprate, f0, b < WFM_STEREO_BLOCKS, gen, device)
        state, out = eng.step(state, params, blk)
        audio.append(out["wfm"]["audio"][WFM_K])
        stereo.append(bool(out["wfm"]["info"]["stereo"][WFM_K]))
    launches = dict(cc.launches)
    fs = 48_000
    st = torch.cat(audio[WFM_SETTLE:WFM_STEREO_BLOCKS]).cpu().numpy().astype(np.float64)
    mo = torch.cat(audio[-10:]).cpu().numpy().astype(np.float64)[:, 0]
    sep = {}
    for col, f_own, f_other in ((0, 700.0, 1100.0), (1, 1100.0, 700.0)):
        own, other = tone_amp_db(st[:, col], f_own, fs), tone_amp_db(st[:, col], f_other, fs)
        sep["left" if col == 0 else "right"] = {"own_db": own, "other_db": other,
                                                "separation_db": own - other}
    lost = [b for b in range(WFM_STEREO_BLOCKS, len(stereo)) if not stereo[b]]
    due = sum(1 for b in range(len(stereo)) if b < 2 or b % eng.noise_every == 0)
    return {"station": WFM_K, "freq_hz": f0, "blocks": len(stereo),
            "audio_shape": list(out["wfm"]["audio"].shape), "stereo": stereo,
            "separation": sep,
            "mono_after_blocks": (lost[0] - WFM_STEREO_BLOCKS + 1) if lost else None,
            "mono_700_db": tone_amp_db(mo, 700.0, fs), "mono_1100_db": tone_amp_db(mo, 1100.0, fs),
            "finite": bool(torch.isfinite(out["wfm"]["audio"]).all()),
            "launches": launches, "due_blocks": due}


def check_wfm_scene(sc: dict) -> None:
    if not all(sc["stereo"][WFM_SETTLE:WFM_STEREO_BLOCKS]):
        fail(f"wfm: stereo flag not held with the pilot on: {sc['stereo']}")
    for side, s in sc["separation"].items():
        if s["separation_db"] < 30.0:
            fail(f"wfm: {side} separation {s['separation_db']} dB < 30 dB")
    if sc["mono_after_blocks"] is None or sc["mono_after_blocks"] > 5 or any(sc["stereo"][-10:]):
        fail(f"wfm: stereo flag did not fall within 5 blocks of the pilot's loss: {sc['stereo']}")
    if abs(sc["mono_700_db"] - sc["mono_1100_db"]) > 1.0 or sc["mono_700_db"] < -40.0:
        fail(f"wfm: mono tones {sc['mono_700_db']} dB (700 Hz), {sc['mono_1100_db']} dB (1100 Hz)")
    if not sc["finite"] or sc["audio_shape"] != [8, 960, 2]:
        fail(f"wfm: audio finite {sc['finite']}, shape {sc['audio_shape']}")


def check_nbfm400_scene(sc: dict, what: str = "nbfm400", shape=(400, 480)) -> None:
    if abs(sc["peak_hz"] - 1000.0) > 10.0:
        fail(f"{what}: channel {sc['channel']} audio peaks at {sc['peak_hz']} Hz, want 1000")
    if not all(sc["send_carrier"][2:]):
        fail(f"{what}: the carrier's channel did not keep its squelch open: {sc['send_carrier']}")
    if any(sc["send_quiet"][8:]):
        fail(f"{what}: the noise-only channel sends after warm-up: {sc['send_quiet']}")
    if not sc["finite"] or sc["audio_shape"] != list(shape):
        fail(f"{what}: audio finite {sc['finite']}, shape {sc['audio_shape']}")


VHF_CONF = ROOT / "examples" / "radiod@2m.conf"
VHF_FEED_FS = 5_120_000
VHF_CENTER = 146_000_000.0
VHF_SAM, VHF_ISB, VHF_SPEC = 146_415_000.0, 146_445_000.0, 146_200_000.0


def vhf_config(dport: int, sport: int) -> tuple[str, list[str]]:
    """examples/radiod@2m.conf with the changes listed in `reduced`: its
    [vhf-feed] network stream becomes a silent sig_gen at the same rate and
    centre (the blocks are built by vhf_block and handed to step_block), and
    the streams go to local ports."""
    import re

    text = VHF_CONF.read_text()
    feed = ("[vhf-feed]\ndevice = sig_gen\nsamprate = 5m12\nreal = no\nfrequency = 146m\n"
            "carrier = 146m\namplitude = -200\n\n")
    text, n = re.subn(r"\[vhf-feed\].*?(?=\n\[repeaters\])", feed, text, flags=re.S)
    if n != 1:
        fail("the 2 m config's [vhf-feed] section was not found")
    text = text.replace("status = 2m.local", f"status = 127.0.0.1:{sport}")
    text = text.replace("data = 2m-pcm.local", f"data = 127.0.0.1:{dport}")
    text = text.replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1)
    reduced = [
        "[vhf-feed]: device = rtp (2m-iq.local, complex 5.12 Msps at 146 MHz) -> the same rate "
        "and centre built on the card (vhf_block): FM at 145.180 MHz with its 107.2 Hz tone, FM "
        "at 146.700 MHz with 100.0 Hz (configured 103.5 Hz), then an unmodulated carrier 3 Hz "
        "above 146.415 MHz, tones 1,000 Hz above and 1,500 Hz below 146.445 MHz and a carrier "
        "500 Hz above 146.200 MHz, over noise of -130 dBFS/Hz",
        f"data, status: 2m-pcm.local, 2m.local -> 127.0.0.1:{dport}, 127.0.0.1:{sport}",
        "sap = no, advertise = no: no SAP or mDNS announcements (the run has no network)",
    ]
    return text, reduced


def vhf_block(b: int, L: int, gen, device) -> torch.Tensor:
    """Block b of the 2 m scene (see vhf_config's `reduced`): each FM
    carrier has a 1 kHz tone at 2.5 kHz deviation and its CTCSS tone at
    500 Hz deviation; the phases are exact in float64."""
    t = (torch.arange(L, dtype=torch.float64, device=device) + b * L) / VHF_FEED_FS
    tp = 2 * np.pi * t

    def carrier(f_rf: float, amp: float, extra=0.0):
        ph = torch.remainder((f_rf - VHF_CENTER) * t, 1.0) * (2 * np.pi) + extra
        return amp * torch.polar(torch.ones_like(ph), ph)

    x = 0
    for f_rf, tone in ((145_180_000.0, 107.2), (146_700_000.0, 100.0)):
        x = x + carrier(f_rf, 0.1, 2.5 * torch.sin(1000 * tp) + 500.0 / tone * torch.sin(tone * tp))
    x = x + carrier(VHF_SAM + 3.0, 0.05)
    x = x + carrier(VHF_ISB + 1000.0, 0.05) + carrier(VHF_ISB - 1500.0, 0.03)
    x = x + carrier(VHF_SPEC + 500.0, 0.01)
    std = float(np.sqrt(NBFM_N0 * VHF_FEED_FS / 2.0))
    noise = torch.view_as_complex(std * torch.randn((L, 2), generator=gen, device=device))
    return x.to(torch.complex64) + noise


def _clone(a):
    """a copy of a wrapper's argument: a tensor, a dict of them, or as is"""
    if torch.is_tensor(a):
        return a.clone()
    if isinstance(a, dict):
        return {k: _clone(v) for k, v in a.items()}
    return a


def vhf_daemon(device) -> tuple[dict, dict]:
    """examples/radiod@2m.conf through Radiod on `device`: CTCSS open and
    mute on the repeaters, then through handle_packet a switch of one
    simplex channel to sam (PLL lock), one to isb (each sideband in its own
    output column), a trace of 4 blocks (each kernel's time inside the
    daemon) and a new 50 Hz spectrum channel, polled. The RTP is received on
    127.0.0.1. Returns (the phase's JSON, the inputs of the last pll_scan
    and goertzel_block launches, as recurrence_stand_in gives them)."""
    import select
    import socket

    import ka9q_radio_tpu_torch.models.fm as fm_mod
    import ka9q_radio_tpu_torch.models.linear as linear_mod
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status, encode_status
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    dport, sport = _free_port(), _free_port()
    text, reduced = vhf_config(dport, sport)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", dport))
    rx.setblocking(False)
    t0 = time.perf_counter()
    rd = Radiod(load_config(text), use_network=True, data_port=dport, status_port=sport,
                device=device)
    t_init = time.perf_counter() - t0
    by_freq = {c.freq: c for c in rd.chans.values()}
    r0, r1 = by_freq[145_180_000.0], by_freq[146_700_000.0]
    sam, isb = by_freq[VHF_SAM], by_freq[VHF_ISB]
    pkts: dict[int, list] = {}  # ssrc -> [(seq, payload type, payload)]
    statuses: list[bytes] = []
    send_status = rd._send_status

    def spy(pkt, ch=None):
        statuses.append(pkt)
        send_status(pkt, ch)

    rd._send_status = spy

    def drain():
        while select.select([rx], [], [], 0)[0]:
            h, payload = RtpHeader.unpack(rx.recv(65536))
            pkts.setdefault(h.ssrc, []).append((h.seq, h.type, payload))

    # the recurrences' wrappers as the demodulators call them, each call's
    # inputs kept (the last one's), to hold the kernels at the daemon's shapes
    seen: dict[str, tuple] = {}
    wrapped = ((linear_mod, "cuda_pll_scan", "pll_scan"), (fm_mod, "cuda_goertzel_block", "goertzel"))
    originals = {attr: getattr(mod, attr) for mod, attr, _ in wrapped}

    def keep(attr: str, name: str):
        def call(*args):
            seen[name] = tuple(_clone(a) for a in args)
            return originals[attr](*args)
        return call

    for mod, attr, name in wrapped:
        setattr(mod, attr, keep(attr, name))

    gen = torch.Generator(device=device).manual_seed(11)

    def run(n: int):
        for _ in range(n):
            rd.step_block(block=vhf_block(rd.blocks, rd.engine.L, gen, device))
            drain()

    def audio(ssrc: int, nch: int = 1, skip: int = 0) -> np.ndarray:
        got = sorted(pkts.get(ssrc, []))[skip:]
        a = np.concatenate([np.frombuffer(p, ">i2") for _, _, p in got] or [np.zeros(0, ">i2")])
        return a.astype(np.float64).reshape(-1, nch) / 32768.0

    def status(ch) -> dict:
        return decode_status(rd.encode_channel_status(ch))[1]

    def cmd(fields: dict):
        rd.handle_packet(encode_status(fields, cmd=True))
        rd._finish_restock(wait=True)

    cc.reset_launches()
    t0 = time.perf_counter()
    # CTCSS: two 240 ms integrations must agree on the tone's phase (fm.c:279-325)
    run(40)
    out = {"reduced": reduced, "init_s": t_init, "channels": len(rd.chans)}
    a0, a1 = audio(r0.ssrc, skip=20), audio(r1.ssrc, skip=20)
    s0, s1 = status(r0), status(r1)
    out["ctcss"] = {
        "open": {"freq": r0.freq, "tone": s0.get(T.PL_TONE), "packets": len(pkts.get(r0.ssrc, [])),
                 "peak_hz": peak_hz(a0[:, 0], r0.samprate) if a0.size else None,
                 "max_abs": float(np.abs(a0).max(initial=0)),
                 "pl_deviation": s0.get(T.PL_DEVIATION)},
        "muted": {"freq": r1.freq, "tone": s1.get(T.PL_TONE), "packets": len(pkts.get(r1.ssrc, [])),
                  "max_abs": float(np.abs(a1).max(initial=0)),
                  "pl_deviation": s1.get(T.PL_DEVIATION)}}
    # a simplex channel to sam on its unmodulated carrier: PLL_LOCK within 100 blocks
    cmd({T.OUTPUT_SSRC: sam.ssrc, T.COMMAND_TAG: 1, T.PRESET: "sam"})
    lock_at = None
    for b in range(100):
        run(1)
        if status(rd.chans[sam.ssrc]).get(T.PLL_LOCK):
            lock_at = b + 1
            break
    st_sam = status(rd.chans[sam.ssrc])
    out["sam"] = {"freq": sam.freq, "demod": rd.engine.groups[rd.chans[sam.ssrc].group].spec.demod,
                  "lock_after_blocks": lock_at, "freq_offset_hz": st_sam.get(T.FREQ_OFFSET),
                  "pll_wraps": st_sam.get(T.PLL_WRAPS)}
    # another to isb: the tone above the dial in one output column, below in the other
    cmd({T.OUTPUT_SSRC: isb.ssrc, T.COMMAND_TAG: 2, T.PRESET: "isb"})
    n0 = len(pkts.get(isb.ssrc, []))
    run(20)
    ai = audio(isb.ssrc, nch=2, skip=n0 + 5)
    cols = []
    for c in range(2):
        cols.append({"1000_db": tone_amp_db(ai[:, c], 1000.0, isb.samprate) if ai.size else None,
                     "1500_db": tone_amp_db(ai[:, c], 1500.0, isb.samprate) if ai.size else None})
    out["isb"] = {"freq": isb.freq, "channels": rd.chans[isb.ssrc].channels,
                  "samples": int(ai.shape[0]), "columns": cols}
    # each kernel's device time a launch inside 4 blocks: the repeaters'
    # Goertzel and the sam channel's PLL run in every one
    _, kern, _, note = traced(lambda: run(4), "vhf_daemon")
    out["kernel_in_daemon_ms"] = per_launch_ms(kern, KERNEL_NAMES + RECUR_NAMES)
    out["trace"] = note
    # a new spectrum channel at 50 Hz, polled: the carrier's bin
    cmd({T.OUTPUT_SSRC: 9001, T.COMMAND_TAG: 3, T.PRESET: "spectrum",
         T.RADIO_FREQUENCY: VHF_SPEC, T.RESOLUTION_BW: 50.0, T.BIN_COUNT: 64})
    run(2)
    statuses.clear()
    rd.handle_packet(encode_status({T.OUTPUT_SSRC: 9001, T.COMMAND_TAG: 4}, cmd=True))
    bins = rbw = None
    for _ in range(20):
        run(1)
        for p in statuses:
            f = decode_status(p)[1]
            if f.get(T.OUTPUT_SSRC) == 9001 and f.get(T.COMMAND_TAG) == 4 and T.BIN_DATA in f:
                bins, rbw = np.asarray(f[T.BIN_DATA], np.float64), float(f[T.RESOLUTION_BW])
        if bins is not None:
            break
    spec_g = rd.engine.groups[rd.chans[9001].group]
    out["spectrum"] = {"freq": VHF_SPEC, "carrier_offset_hz": 500.0, "rbw": rbw,
                       "narrowband": not spec_g.spectrum_wide,
                       "bins": None if bins is None else int(bins.size),
                       "peak_bin": None if bins is None else int(np.argmax(bins)),
                       "want_bin": None if rbw is None else int(round(500.0 / rbw)),
                       "peak_over_median_db": None if bins is None else
                       float(10 * np.log10(bins.max() / max(np.median(bins), 1e-30)))}
    out["blocks"] = rd.blocks
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = dict(cc.launches)
    out["block_drops"] = rd.block_drops
    # A and B against their plain versions at the daemon's own shapes (its
    # tiled group's rows), on the master spectrum of one scene block
    eng = rd.engine
    _, F = master_fft(eng.master, eng.init_state()["master"], vhf_block(0, eng.L, gen, device))
    group = next(n for n, g in eng.groups.items() if g.tiled and g.tile_E is not None)
    out["kernels"] = {k["name"]: {"group": group, "C": eng.groups[group].C,
                                  **{x: k[x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                       "library_ms", "max_abs_err", "max_rel_err",
                                                       "err_bound") if x in k}}
                      for k in check_kernels(eng, rd.params, F, group)}
    for mod, attr, _ in wrapped:
        setattr(mod, attr, originals[attr])
    rx.close()
    for edge_, _ in rd.edges.values():
        edge_.close()
    return out, seen


def check_vhf_daemon(v: dict) -> None:
    o, m = v["ctcss"]["open"], v["ctcss"]["muted"]
    if o["peak_hz"] is None or abs(o["peak_hz"] - 1000.0) > 10.0 or o["max_abs"] < 0.01:
        fail(f"vhf_daemon: the 107.2 Hz repeater did not open on its tone: {o}")
    if m["max_abs"] != 0.0:
        fail(f"vhf_daemon: the 103.5 Hz repeater sent audio on a 100.0 Hz tone: {m}")
    if v["sam"]["demod"] != "linear" or v["sam"]["lock_after_blocks"] is None:
        fail(f"vhf_daemon: the sam channel did not lock within 100 blocks: {v['sam']}")
    c0, c1 = v["isb"]["columns"]
    if v["isb"]["samples"] < 2000 or v["isb"]["channels"] != 2:
        fail(f"vhf_daemon: isb output {v['isb']}")
    sep = max(min(c0["1000_db"] - c0["1500_db"], c1["1500_db"] - c1["1000_db"]),
              min(c0["1500_db"] - c0["1000_db"], c1["1000_db"] - c1["1500_db"]))
    v["isb"]["separation_db"] = sep
    if sep < 30.0:
        fail(f"vhf_daemon: isb sidebands not in their own columns: {v['isb']}")
    s = v["spectrum"]
    if s["bins"] != 64 or not s["narrowband"] or s["peak_bin"] != s["want_bin"] \
            or s["peak_over_median_db"] < 30.0:
        fail(f"vhf_daemon: spectrum poll {s}")
    # the 2 m config's groups (pm, nfm, and the sam and isb switches) take
    # no linear_tail: it runs usb, lsb and cw offsets without filter2
    if min(n for k, n in v["launches"].items() if k != "linear_tail") <= 0:
        fail(f"vhf_daemon: a kernel of the path was not launched: {v['launches']}")


# ------------------------------------------- several inputs, odd masters, beam
MULTI_B = 4  # bench.py's rx888x4: four 129.6 Msps real streams on one card
MULTI_TONE_INPUT = 2  # the stream that carries the multife scene's tone
ODD_FS = 2_400_000  # an RTL-SDR: complex 2.4 Msps, N 60,000 (not whole 128-bin tiles)
ODD_K, ODD_QUIET = 27, 60  # the odd master's FM channel and a noise-only one
BEAM_FS = 1_024_000  # tests/test_beam.py's master


def multife_scene(eng, params, device, seed: int = 21) -> dict:
    """Known answer on rx888x<B>: a tone 700 Hz above channel k's dial
    (bin-centred) on stream MULTI_TONE_INPUT only, noise of density N0_SCENE
    on every stream; 10 blocks, the first 2 discarded. The tone's channel's
    audio peak, its baseband power against its twins' on the other streams,
    the per-input IF power and the kernels' launches."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    m, L, B = eng.master, eng.L, eng.n_inputs
    hz = eng.samprate / m.N
    per = eng.groups["hf"].C // B
    freqs = [c.freq for c in eng.groups["hf"].spec.channels[:per]]
    k, kbin = pick_on_grid(freqs, 700.0, hz, 100, 900)
    gen = torch.Generator(device=device).manual_seed(seed)
    std = float(np.sqrt(N0_SCENE * eng.samprate / 2.0))

    def block(b: int) -> torch.Tensor:
        n = torch.arange(L, dtype=torch.int64, device=device) + b * L
        x = std * torch.randn((B, L), generator=gen, device=device)
        x[MULTI_TONE_INPUT] += 0.1 * torch.cos(
            (2 * np.pi / m.N) * torch.remainder(n * kbin, m.N).to(torch.float64)).to(torch.float32)
        return x

    state = eng.init_state()
    cc.reset_launches()
    outs = []
    for b in range(10):
        state, out = eng.step(state, params, block(b))
        outs.append(out)
    launches = {name: cc.launches[name] for name in ("channelize", "noise_est")}
    row = MULTI_TONE_INPUT * per + k
    twins = [b * per + k for b in range(B) if b != MULTI_TONE_INPUT]
    hf = [o["hf"] for o in outs[2:]]
    bbp = torch.stack([o["info"]["baseband_power"] for o in hf]).mean(0).cpu().numpy()
    audio = torch.cat([o["audio"][row] for o in hf]).cpu().numpy()
    return {"k": k, "row": row, "twin_rows": twins, "tone_offset_hz": kbin * hz - freqs[k],
            "peak_hz": peak_hz(audio, eng.groups["hf"].spec.samprate),
            "p_row": float(bbp[row]), "p_twins": [float(bbp[t]) for t in twins],
            "twin_ratio_min": float(bbp[row] / max(bbp[twins].max(), 1e-30)),
            "if_power": outs[-1]["_frontend"]["if_power"].cpu().tolist(),
            "finite": outputs_finite(outs[-1]), "launches": launches, "blocks": 10,
            "due_blocks": sum(1 for b in range(10) if b < 2 or b % eng.noise_every == 0)}


def check_multife_scene(sc: dict) -> None:
    if abs(sc["peak_hz"] - sc["tone_offset_hz"]) > 10.0:
        fail(f"multife: row {sc['row']} audio peaks at {sc['peak_hz']} Hz, want "
             f"{sc['tone_offset_hz']}")
    if sc["twin_ratio_min"] <= 100.0:
        fail(f"multife: the tone's channel is {sc['twin_ratio_min']}x its twins on the other "
             "streams, want > 100x")
    if len(sc["if_power"]) != MULTI_B or not sc["finite"]:
        fail(f"multife: if_power {sc['if_power']}, finite {sc['finite']}")
    if sc["launches"] != {"channelize": sc["blocks"], "noise_est": sc["due_blocks"]}:
        fail(f"multife: launches {sc['launches']}, want channelize {sc['blocks']}, "
             f"noise_est {sc['due_blocks']}")


def odd_master_groups(rt):
    """bench.py's nbfm400 layout at an RTL-SDR's rate: 80 NBFM channels at
    24 kHz evenly across +-0.45 fs of a complex 2.4 Msps master."""
    freqs = np.linspace(-0.45 * ODD_FS, 0.45 * ODD_FS, 80)
    return [rt.GroupSpec(name="nbfm", demod="fm", samprate=24_000, channels=tuple(
        rt.ChannelSpec(freq=float(f), low=-8000.0, high=8000.0) for f in freqs))]


def beam_groups(rt, a: complex, b: complex):
    """tests/test_beam.py's beam group: I/Q out, AGC off, channels at 100 and
    110 kHz, antenna weights a (I rail) and b (Q rail)."""
    return [rt.GroupSpec(name="beam", demod="iq", samprate=16_000, agc=False, beam=True,
                         a_weight=a, b_weight=b, channels=tuple(
                             rt.ChannelSpec(freq=f, low=-6000.0, high=6000.0, gain_db=0.0)
                             for f in (100_000.0, 110_000.0)))]


def beam_scene(rt, device) -> dict:
    """tests/test_beam.py's scene on the card: antenna A (100 kHz) on the I
    rail, antenna B (110 kHz) on Q, through both weight pairs, 10 blocks
    each; the selected channel's power over the nulled one's, in dB (>= 40
    dB is test_beam.py's bound), and the beamforming channelizer's and
    kernel B's times at these shapes."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    out = {"pairs": []}
    for a, b, want in ((0.5 + 0j, 0.5 + 0j, 0), (0.5 + 0j, -0.5 + 0j, 1)):
        eng = rt.Engine(samprate=BEAM_FS, real=False, groups=beam_groups(rt, a, b))
        params, state, L = eng.init_params(), eng.init_state(), eng.L
        cc.reset_launches()
        for k in range(10):
            t = (torch.arange(L, dtype=torch.float64, device=device) + k * L) / BEAM_FS
            x = torch.complex(0.1 * torch.cos(2 * np.pi * 100_000 * t),
                              0.1 * torch.cos(2 * np.pi * 110_000 * t)).to(torch.complex64)
            state, o = eng.step(state, params, x)
        p = o["beam"]["info"]["baseband_power"].cpu().numpy()
        iso = float(10 * np.log10(p[want] / max(p[1 - want], 1e-30)))
        due = sum(1 for j in range(10) if j < 2 or j % eng.noise_every == 0)
        out["pairs"].append({"a": str(a), "b": str(b), "selected": want, "p": p.tolist(),
                             "isolation_db": iso, "launches": dict(cc.launches),
                             "due_blocks": due})
    g, prm = eng.groups["beam"], params["beam"]
    _, F = eng.master_step(eng.init_state()["master"], x)
    out["channelize_beam_ms"] = event_ms(lambda: g._channelize(prm, F), what="beam channelize")
    out["kernels"] = {k["name"]: k for k in check_kernels(eng, params, F, "beam")}
    return out


def check_beam_scene(bs: dict) -> None:
    for pr in bs["pairs"]:
        if pr["isolation_db"] < 40.0 or pr["p"][pr["selected"]] <= 1e-5:
            fail(f"beam: antenna isolation {pr['isolation_db']} dB < 40 dB or no power: {pr}")
        if pr["launches"]["channelize"] != 0 or pr["launches"]["noise_est"] != pr["due_blocks"]:
            fail(f"beam: launches {pr['launches']}, want no channelize and noise_est "
                 f"{pr['due_blocks']}")
    if set(bs["kernels"]) != {"noise_est"}:
        fail(f"beam: kernels {sorted(bs['kernels'])}, want noise_est alone")


MFD_K0, MFD_K1 = DAEMON_K, 20_000  # raster channels of the carriers on stream 0 and stream 1


def multife_daemon_config(dport: int, sport: int) -> tuple[str, list[str], float, float]:
    """examples/radiod@rx888-wspr.conf on two front ends (the changes listed
    in `reduced`): [adc] a sig_gen carrier 1,500 Hz above raster channel
    MFD_K0's dial, a second sig_gen [adc2] with one 1,500 Hz above channel
    MFD_K1's, and a small usb section on [adc2] at both dials. Returns
    (config text, reduced, dial 0, dial 1)."""
    import re

    text = WSPR_CONF.read_text()
    d0, d1 = (2_600_000 + k * 1_815 for k in (MFD_K0, MFD_K1))
    adc = ("[adc]\ndevice = sig_gen\nsamprate = 129m6\nreal = yes\n"
           f"carrier = {d0 + 1500}\namplitude = -60\nn0 = -138\n\n"
           "[adc2]\ndevice = sig_gen\nsamprate = 129m6\nreal = yes\n"
           f"carrier = {d1 + 1500}\namplitude = -40\nn0 = -138\n\n")
    text, n = re.subn(r"\[adc\].*?(?=\n\[hf\])", adc, text, flags=re.S)
    if n != 1:
        fail("the daemon config's [adc] section was not found")
    text = text.replace("hardware = adc\n", "hardware = adc adc2\n", 1)
    text = text.replace("status = hffarm.local", f"status = 127.0.0.1:{sport}")
    text = text.replace("data = hffarm-pcm.local", f"data = 127.0.0.1:{dport}")
    text = text.replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1)
    text += (f"\n[fe1usb]\nhardware = adc2\nmode = usb\nsamprate = 12k\nsnr-squelch = yes\n"
             f"squelch-open = 8\nsquelch-close = 7\nfreq = {d1} {d0}\n")
    reduced = [
        "[adc]: device = rtp (the SDR host's 129.6 Msps s16be stream) -> device = sig_gen at "
        f"samprate 129m6, real = yes: carrier {d0 + 1500} Hz (raster channel {MFD_K0}'s dial "
        "+ 1,500 Hz) at -60 dBFS, noise density -138 dBFS/Hz",
        f"[adc2] added (hardware = adc adc2): sig_gen at 129m6 real, carrier {d1 + 1500} Hz "
        f"(raster channel {MFD_K1}'s dial + 1,500 Hz) at -40 dBFS, noise -138 dBFS/Hz",
        f"[fe1usb] added on [adc2]: usb at 12 kHz with SNR squelch, dials {d1} and {d0}",
        f"data, status: hffarm-pcm.local, hffarm.local -> 127.0.0.1:{dport}, 127.0.0.1:{sport}",
        "sap = no, advertise = no: no SAP or mDNS announcements (the run has no network)",
    ]
    return text, reduced, float(d0), float(d1)


def run_multife_daemon(card: str, device) -> dict:
    """The rx888-wspr farm on stream 0 and a usb section on stream 1 of one
    daemon (two [hardware] sig_gen sections, time-shards 8), RTP received
    on 127.0.0.1: each carrier must demodulate on its own input only, with
    no overflow or drop, and each channel's status must show its input's
    IF power. p50/p99 block time are reported, not held to a limit. Then
    both kernels against their plain versions at the daemon's shapes (the
    usb section's channels read stream 1's row of the padded spectra)."""
    import select
    import socket

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    dport, sport = _free_port(), _free_port()
    text, reduced, d0, d1 = multife_daemon_config(dport, sport)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", dport))
    rx.setblocking(False)
    t0 = time.perf_counter()
    rd = Radiod(load_config(text), use_network=True, data_port=dport, status_port=sport)
    t_init = time.perf_counter() - t0
    chans = {(c.group, c.freq): c for c in rd.chans.values()}
    hf0, hf1 = chans[("hf", d0)], chans[("hf", d1)]
    us1, us0 = chans[("fe1usb", d1)], chans[("fe1usb", d0)]
    pkts: dict[int, list] = {}

    def drain():
        while select.select([rx], [], [], 0)[0]:
            h, payload = RtpHeader.unpack(rx.recv(65536))
            pkts.setdefault(h.ssrc, []).append((h.seq, payload))

    def audio(ch) -> np.ndarray:
        got = sorted(pkts.get(ch.ssrc, []))
        a = np.concatenate([np.frombuffer(p, ">i2") for _, p in got] or [np.zeros(0, ">i2")])
        return a.astype(np.float64)

    D = rd._time_shards
    for _ in range(4):  # warm-up: cuFFT plans, the squelches open
        rd.step_block()
        drain()
    pkts.clear()
    cc.reset_launches()
    j0 = rd.state["host"]["jobnum"]
    rd._t_n = 0
    t0 = time.perf_counter()
    for _ in range(16):
        rd.step_block()
        drain()
    elapsed = time.perf_counter() - t0
    blocks = 16 * D
    p50, p99 = rd.latency_percentiles()
    launches = dict(cc.launches)
    due = sum(1 for b in range(j0, rd.state["host"]["jobnum"]) if b % rd.engine.noise_every == 0)
    st = {name: decode_status(rd.encode_channel_status(ch))[1] for name, ch in
          (("hf0", hf0), ("us1", us1))}
    out = {"phase": "multife_daemon", "card": card, "config": str(WSPR_CONF.relative_to(ROOT)),
           "reduced": reduced, "init_s": t_init, "inputs": rd.engine.n_inputs,
           "channels": {n: g.C for n, g in rd.engine.groups.items()}, "time_shards": D,
           "blocks": blocks, "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
           "mean_ms": elapsed * 1e3 / blocks, "msps": blocks * rd.engine.L * 2 / elapsed / 1e6,
           "realtime_factor": rd.cfg.blocktime / p50 if p50 else None,
           "if_power_in_db": [float(10 * np.log10(v)) for v in rd.if_power_in],
           "status_if_power_db": {n: float(f[T.IF_POWER]) for n, f in st.items()},
           "launches": launches, "due_blocks": due,
           "egress_overflows": rd.egress_overflows, "block_drops": rd.block_drops,
           "ssrcs": {"hf0": hf0.ssrc, "hf1": hf1.ssrc, "us1": us1.ssrc, "us0": us0.ssrc}}
    for name, ch in (("hf0", hf0), ("us1", us1)):
        a = audio(ch)
        out[f"{name}_tone_hz"] = peak_hz(a, ch.samprate) if a.size else None
    out["packets"] = {n: len(pkts.get(ch.ssrc, [])) for n, ch in
                      (("hf0", hf0), ("hf1", hf1), ("us1", us1), ("us0", us0))}
    rx.close()
    # both kernels at the daemon's shapes on one block's padded spectra
    blk = float(np.sqrt(1.585e-14 * rd.engine.samprate / 2.0)) * torch.randn(
        (2, rd.engine.L), generator=torch.Generator(device=device).manual_seed(22), device=device)
    _, F = rd.engine.master_step(rd.engine.init_state()["master"], blk)
    out["kernels_at_daemon"] = {
        gname: {k["name"]: {key: k[key] for key in ("max_abs_err", "max_rel_err", "ms", "plain_ms",
                                                     "bound_ms", "bound_by", "library_ms", "shape")
                            if key in k}
                for k in check_kernels(rd.engine, rd.params, F, gname)}
        for gname in ("hf", "fe1usb")}
    for edge_, _ in rd.edges.values():
        edge_.close()
    return out


def check_multife_daemon(v: dict) -> None:
    for name in ("hf0", "us1"):
        if v[f"{name}_tone_hz"] is None or abs(v[f"{name}_tone_hz"] - 1500.0) > 10.0:
            fail(f"multife_daemon: {name}'s carrier at {v[f'{name}_tone_hz']} Hz, want 1500")
    if v["packets"]["hf1"] or v["packets"]["us0"]:
        fail(f"multife_daemon: a carrier demodulated off its own input: {v['packets']}")
    if v["egress_overflows"] or v["block_drops"]:
        fail(f"multife_daemon: overflows {v['egress_overflows']}, drops {v['block_drops']}")
    lo, hi = v["if_power_in_db"]
    sif = v["status_if_power_db"]
    if abs(sif["hf0"] - lo) > 1e-3 or abs(sif["us1"] - hi) > 1e-3 or hi - lo < 10.0:
        fail(f"multife_daemon: status IF power {sif}, per input {v['if_power_in_db']}")
    want = {"channelize": 2 * v["blocks"], "noise_est": 2 * v["due_blocks"]}  # two groups
    if {k: v["launches"][k] for k in want} != want:
        fail(f"multife_daemon: launches {v['launches']}, want channelize {2 * v['blocks']}, "
             f"noise_est {2 * v['due_blocks']}")


# ------------------------------------------------------------ the clients
STEREO_FS = 384_000.0  # stereod's composite rate
STEREO_BLOCKS = 24
STEREO_TOL = 1e-4  # the card's decode against the CPU path's, of the block's peak


def stereo_composite(n: int, fs: float = STEREO_FS, start: int = 0) -> np.ndarray:
    """tests/test_clients2.py's composite at 384 kHz (or fs, from sample
    `start`): a 1 kHz tone on L only (L+R and L-R on 38 kHz), the 19 kHz
    pilot."""
    t = (np.arange(n) + start) / fs
    left = np.cos(2 * np.pi * 1000.0 * t)
    comp = (0.45 * left + 0.1 * np.sin(2 * np.pi * 19_000.0 * t)
            + 0.45 * left * np.sin(2 * np.pi * 38_000.0 * t)) * 0.9
    return comp.astype(np.float32)


def separation(audio: np.ndarray, rate: float, f0: float = 1000.0) -> tuple[float, float]:
    """(L's peak Hz, dB of L's peak over R's largest bin within 50 Hz of f0)."""
    a = audio[audio.shape[0] // 2:].astype(np.float64)
    f = np.fft.rfftfreq(a.shape[0], 1 / rate)
    spec_l = np.abs(np.fft.rfft(a[:, 0] * np.hanning(a.shape[0])))
    spec_r = np.abs(np.fft.rfft(a[:, 1] * np.hanning(a.shape[0])))
    band = (f > f0 - 50) & (f < f0 + 50)
    return float(f[np.argmax(spec_l)]), float(20 * np.log10(spec_l.max() / spec_r[band].max()))


def run_fftgen() -> dict:
    """fft-gen-torch on the daemon phase's config (full width, its `reduced`
    list), in a subprocess, with `wisdom` in a temporary directory."""
    import re
    import tempfile

    text, reduced, _ = daemon_config(_free_port(), _free_port())
    with tempfile.TemporaryDirectory() as tmp:
        conf = Path(tmp) / "radiod@rx888-wspr.conf"
        conf.write_text(text)
        wisdom = Path(tmp) / "wisdom"
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "ka9q_radio_tpu_torch.cli.fftgen", str(conf),
                            "--wisdom", str(wisdom)], cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
        wall = time.perf_counter() - t0
        log = (wisdom / "fft.log").read_text() if (wisdom / "fft.log").exists() else ""
    m = re.search(r"compiled master N=(\d+) \+ (\d+) channels in ([\d.]+)s; kernels: ([^;]*);",
                  r.stderr)
    if r.returncode != 0 or m is None:
        fail(f"fft-gen-torch: rc {r.returncode}: {r.stderr[-2000:]}")
    return {"config": str(WSPR_CONF.relative_to(ROOT)), "reduced": reduced, "rc": r.returncode,
            "N": int(m[1]), "channels": int(m[2]), "reported_s": float(m[3]), "wall_s": wall,
            "kernels": m[4], "kernel_cache_hit": m[4] == "cache hit",
            "fft_log_lines": log.splitlines()}


def run_pcmrecord(rd, k: int = DAEMON_K, dispatches: int = 8) -> dict:
    """pcmrecord-torch in a subprocess on the data port of the daemon of the
    `daemon` phase (the farm at full width, the carrier alone), while the
    daemon steps `dispatches` dispatches (64 blocks at time-shards 8)."""
    import signal
    import tempfile
    import wave

    (addr, dport), _ = rd._group_data_dest("hf")
    ch = next(c for c in rd.chans.values() if c.group == "hf" and c.idx == k)
    for _ in range(2):  # the tone channels of the busy run close their squelch
        rd.step_block()
    with tempfile.TemporaryDirectory() as tmp:
        p = subprocess.Popen([sys.executable, "-m", "ka9q_radio_tpu_torch.cli.pcmrecord",
                              "--data", f"{addr}:{dport}", "--dir", tmp, "--timeout", "60"],
                             cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            # the daemon steps until the recorder has opened the carrier's file:
            # it is bound and receiving (a probe bind of its port could take
            # the port from under it)
            t_end = time.monotonic() + 60
            while not list(Path(tmp).glob(f"*_ssrc{ch.ssrc}.wav")):
                if p.poll() is not None or time.monotonic() > t_end:
                    fail(f"clients: pcmrecord-torch opened no file for ssrc {ch.ssrc} "
                         f"(rc {p.poll()})")
                rd.step_block()
                time.sleep(0.1)
            b0, t0 = rd.blocks, time.perf_counter()
            for _ in range(dispatches):
                rd.step_block()
            step_s = time.perf_counter() - t0
            time.sleep(0.5)  # the last packets reach the recorder
            p.send_signal(signal.SIGINT)  # it closes its files and exits
            _, err = p.communicate(timeout=30)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        files = sorted(Path(tmp).glob("*.wav"))
        mine = [f for f in files if f.name.endswith(f"_ssrc{ch.ssrc}.wav")]
        if p.returncode != 0 or not mine:
            fail(f"pcmrecord-torch: rc {p.returncode}, files {[f.name for f in files][:10]}: "
                 f"{err[-2000:]}")
        with wave.open(str(mine[0])) as w:
            rate, nch, n = w.getframerate(), w.getnchannels(), w.getnframes()
            audio = np.frombuffer(w.readframes(n), "<i2").astype(np.float64)
    return {"data": f"{addr}:{dport}", "blocks": rd.blocks - b0, "step_s": step_s,
            "carrier_ssrc": ch.ssrc, "file": mine[0].name, "rate": rate, "channels": nch,
            "frames": n, "tone_hz": peak_hz(audio, rate), "files": len(files),
            "other_streams_written": len(files) - len(mine),
            "other_ssrcs": sorted(int(f.stem.rsplit("ssrc", 1)[1]) for f in files
                                  if f not in mine)[:20]}


def run_stereod(device) -> dict:
    """stereod-torch on the card: its decode against the CPU path's on the
    same blocks, the decode's device time and launches a block, then the
    CLI over 127.0.0.1 (composite in, 48 kHz stereo out)."""
    import select
    import socket
    import threading

    from ka9q_radio_tpu_torch.cli import stereod as stereod_cli
    from ka9q_radio_tpu_torch.models.wfm import StereoDecoder
    from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader, decode_samples, encode_samples

    card_dec, cpu_dec = StereoDecoder(device), StereoDecoder("cpu")
    Lc = card_dec.geo.Lc
    comp = stereo_composite(STEREO_BLOCKS * Lc)
    comp += 1e-3 * np.random.default_rng(31).standard_normal(comp.size).astype(np.float32)
    blocks = torch.from_numpy(comp).view(STEREO_BLOCKS, Lc)
    err, outs = 0.0, []
    for b in range(STEREO_BLOCKS):
        got = card_dec.decode(blocks[b].to(device))[0].cpu()
        want = cpu_dec.decode(blocks[b])[0]
        err = max(err, float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30))
        outs.append(got.numpy())
    peak, sep = separation(np.concatenate(outs), 48_000.0)
    on_card = blocks[-1].to(device)
    dev_ms = event_ms(lambda: card_dec.decode(on_card), what="stereod decode")
    call_ms = time_ms(lambda: card_dec.decode(blocks[-1].to(device))[0].cpu())
    _, ev, _, note = traced(lambda: [card_dec.decode(on_card) for _ in range(4)], "stereod")
    copies = sum(1 for e in ev if "memcpy" in e.name.lower() or "memset" in e.name.lower())

    # the CLI on the card over 127.0.0.1: 700-sample packets straddle blocks.
    # Its input binds port 0 and the wrapped listen_socket says which port it
    # got, so no other socket can hold that port meanwhile.
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 20)
    rx.bind(("127.0.0.1", 0))
    pout = rx.getsockname()[1]
    bound, real_listen = [], stereod_cli.listen_socket

    def listen_and_tell(dest):
        s = real_listen(dest)
        bound.append(s.getsockname()[1])
        return s

    stereod_cli.listen_socket = listen_and_tell
    try:
        th = threading.Thread(target=stereod_cli.main, daemon=True, args=(
            ["--input", "127.0.0.1:0", "--output", f"127.0.0.1:{pout}", "--duration", "4",
             "--device", str(device)],))
        th.start()
        t_end = time.monotonic() + 30
        while not bound:
            if not th.is_alive() or time.monotonic() > t_end:
                fail("clients: stereod-torch did not bind its input")
            time.sleep(0.05)
    finally:
        stereod_cli.listen_socket = real_listen
    pin = bound[0]
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    t0 = time.perf_counter()
    for seq, off in enumerate(range(0, comp.size, 700)):
        tx.sendto(RtpHeader(type=96, seq=seq, timestamp=off, ssrc=3).pack()
                  + encode_samples(comp[off:off + 700], Encoding.S16BE), ("127.0.0.1", pin))
        time.sleep(0.0002)
    pkts, t_end = [], time.monotonic() + 6
    while time.monotonic() < t_end:
        if select.select([rx], [], [], 0.5)[0]:
            pkts.append(rx.recv(65536))
        elif pkts:
            break
    cli_s = time.perf_counter() - t0
    th.join(timeout=10)
    tx.close()
    rx.close()
    hdrs = sorted((RtpHeader.unpack(q) for q in pkts), key=lambda hp: hp[0].seq)
    audio = (decode_samples(b"".join(pl for _, pl in hdrs), Encoding.S16BE).reshape(-1, 2)
             if hdrs else np.zeros((0, 2), np.float32))
    cli_peak, cli_sep = separation(audio, 48_000.0) if audio.shape[0] > 4800 else (0.0, 0.0)
    return {"blocks": STEREO_BLOCKS, "Lc": Lc, "audio_L": card_dec.geo.audio_L,
            "card_vs_cpu_max_rel_err": err, "tol": STEREO_TOL, "l_peak_hz": peak,
            "separation_db": sep, "device_ms_per_block": dev_ms,
            "call_ms_per_block": call_ms,
            "device_ops_per_block": (len(ev) - copies) / 4, "copies_per_block": copies / 4,
            "trace": note,
            "cli": {"packets_in": -(-comp.size // 700), "packets_out": len(pkts),
                    "payload_types": sorted({h.type for h, _ in hdrs}), "frames": audio.shape[0],
                    "l_peak_hz": cli_peak, "separation_db": cli_sep, "wall_s": cli_s}}


def run_clients(card: str, device, farm) -> dict:
    t0 = time.perf_counter()
    out = {"phase": "clients", "card": card, "fftgen": run_fftgen(),
           "pcmrecord": run_pcmrecord(farm), "stereod": run_stereod(device)}
    out["seconds"] = time.perf_counter() - t0
    return out


def check_clients(cl: dict) -> None:
    fg, pr, sd = cl["fftgen"], cl["pcmrecord"], cl["stereod"]
    if fg["N"] != 3_240_000 or fg["channels"] != 32_728:
        fail(f"fft-gen-torch: N {fg['N']}, {fg['channels']} channels")
    if pr["rate"] != 12_000 or pr["channels"] != 1 or pr["frames"] < 60 * 240:
        fail(f"pcmrecord-torch: {pr['rate']} Hz x{pr['channels']}, {pr['frames']} frames")
    if min(abs(pr["tone_hz"] - 1500.0), abs(pr["tone_hz"] - 1000.0)) > 10.0:
        fail(f"pcmrecord-torch: the carrier's file peaks at {pr['tone_hz']} Hz")
    if sd["card_vs_cpu_max_rel_err"] > STEREO_TOL:
        fail(f"stereod: the card's decode is {sd['card_vs_cpu_max_rel_err']} off the CPU's")
    for what, d in (("decode", sd), ("CLI", sd["cli"])):
        if abs(d["l_peak_hz"] - 1000.0) > 25.0 or d["separation_db"] < 20.0:
            fail(f"stereod {what}: L peaks at {d['l_peak_hz']} Hz, separation "
                 f"{d['separation_db']} dB")
    if sd["cli"]["payload_types"] != [113] or sd["cli"]["frames"] < 20 * 960:
        fail(f"stereod CLI: payload types {sd['cli']['payload_types']}, "
             f"{sd['cli']['frames']} frames")


# ------------------------------------------------------------ the sharded engine
MESH_CONF = ROOT / "examples" / "radiod@mesh-rx888.conf"
MESH_DS = (4, 8)  # shards of the one card the mesh phase runs the flagship on
MESH_BLOCKS = 10  # flagship_parity's blocks (a retune at 3, a table grow at 6)
MESH_DIAL = 14_095_600.0  # the WSPR dial whose channel the mesh daemon's carrier is in
# step_time's dispatches (D blocks each) held bit for bit, timed each way and
# traced, graph against eager
MESH_TS_CHECK, MESH_TS_TIMED, MESH_TS_TRACED = 4, 8, 2


def shard_view(eng, params, group: str, d: int):
    """Shard d of a sharded engine's group seen as a one-device engine of its
    C/D local rows (its own device constants and host rows), for
    check_kernels and the per-shard checks."""
    from types import SimpleNamespace

    from ka9q_radio_tpu_torch.parallel.sharding import local_tree

    g = eng.groups[group]
    D = eng.mesh.size
    rows = slice(d * g.C // D, (d + 1) * g.C // D)
    lg = SimpleNamespace(tile_E=g.lcs[d]["tile_E"], tile_op=g.lcs[d]["tile_op"], inputs_t=None,
                         inputs=None, n_bins=g.n_bins, olen=g.olen, noise_bins=g.noise_bins,
                         host={"tile_lo": g.host["tile_lo"][rows], "shifts": g.host["shifts"][rows]})
    le = SimpleNamespace(groups={group: lg}, master=eng.master, samprate=eng.samprate, n_inputs=1)
    return le, {group: local_tree(params[group], d)}


def shard_kernel_errors(le, lp, F, group: str) -> tuple[float, float, float, bool]:
    """Kernels A and B on one shard's local rows against their plain
    versions: (A's max abs err, A's peak, B's max rel err, B's keys equal)."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import tiled_channelize
    from ka9q_radio_tpu_torch.ops.noise import estimate_noise_keys, gather_noise_bins

    g, p, m = le.groups[group], lp[group], le.master
    a = (F, p["resp_tiles"], p["tile_lo"], p["slope"], p["shifts"], g.tile_E, g.n_bins, g.olen,
         m.real, m.N)
    got, want = cc.cuda_channelize(*a, E_op=g.tile_op), tiled_channelize(*a)
    n0, keys = cc.cuda_noise_est(F, p["shifts"], g.noise_bins, m.real, m.N, le.samprate)
    n0_t, keys_t = estimate_noise_keys(gather_noise_bins(F, p["shifts"], g.noise_bins, m.real, m.N),
                                       m.bins, le.samprate)
    return (float((got - want).abs().max()), float(want.abs().max()),
            float(((n0 - n0_t).abs() / n0_t.abs()).max()), bool(torch.equal(keys, keys_t)))


def mesh_step_check(em, device, n: int = 4) -> dict:
    """The main path of the sharded engine: n steps with the kernels' counts
    set to 0 just before and read just after (A, B and the linear tail of
    each fused group launch D times a block, B on its cadence; on a mesh of
    several processes, this process's shards' count), then one more step,
    one that re-estimates N0, counted alone: D launches of each on the
    shards' C/D rows."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    D, params = len(em.mesh.local), em.init_params()
    blocks = noise_blocks(em, 4 + n + 1, N0_SCENE, device, 31)  # block 4 + n is due
    st = em.init_state()
    for b in range(4):
        st, _ = em.step(st, params, blocks[b])
    j0 = st["host"]["jobnum"]
    due = sum(1 for b in range(j0, j0 + n) if b % em.noise_every == 0)
    cc.reset_launches()
    for b in range(4, 4 + n):
        st, out = em.step(st, params, blocks[b])
    torch.cuda.synchronize()
    launches = {k: cc.launches[k] for k in MAIN_KERNELS}
    nf = fused_groups(em)
    if launches != {"channelize": D * n, "noise_est": D * due, "linear_tail": D * n * nf}:
        fail(f"mesh D={D}: launches {launches}, want channelize {D * n}, noise_est {D * due}, "
             f"linear_tail {D * n * nf}")
    if not outputs_finite(out):
        fail(f"mesh D={D}: non-finite outputs")
    if st["host"]["jobnum"] % em.noise_every:
        fail(f"mesh D={D}: the due step is not one that re-estimates N0")
    cc.reset_launches()
    em.step(st, params, blocks[4 + n])
    torch.cuda.synchronize()
    one = {k: cc.launches[k] for k in MAIN_KERNELS}
    if one != {"channelize": D, "noise_est": D, "linear_tail": D * nf}:
        fail(f"mesh D={D}: the due step launched {one}, want {D} of A and B, {D * nf} of "
             "linear_tail")
    return {"blocks": n, "due_blocks": due, "launches": launches, "due_step_launches": one,
            "local_C": em.groups["hf"].C // em.mesh.size}


def mesh_kernels(em, device) -> dict:
    """A and B on every shard's local rows (this process's shards) of the
    all-gathered flagship spectrum against their plain versions; the first
    shard's timed (check_kernels: ms, plain ms, bound, the torch.matmul /
    torch.kthvalue yardstick)."""
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft, master_init

    gen = torch.Generator(device=device).manual_seed(32)
    blk = 0.05 * torch.randn(em.L, generator=gen, device=device)
    _, F = master_fft(em.master, master_init(em.master, device=device), blk)
    params = em.init_params()
    errs = [shard_kernel_errors(*shard_view(em, params, "hf", d), F, "hf") for d in em.mesh.local]
    for d, (ea, peak, rb, keys) in zip(em.mesh.local, errs):
        if not ea < 3e-5 * peak or not keys or not rb <= 2e-5:
            fail(f"mesh shard {d}: A err {ea} (bound {3e-5 * peak}), B keys {keys}, rel {rb}")
    timed = {k["name"]: k for k in check_kernels(*shard_view(em, params, "hf", em.mesh.local[0]),
                                                  F)}
    return {"shards": len(errs), "max_abs_err_a": max(e[0] for e in errs),
            "err_bound_a": 3e-5 * min(e[1] for e in errs),
            "max_rel_err_b": max(e[2] for e in errs), "keys_equal_b": True, "shard0": timed}


def mesh_time_shards(rt, device, D: int = 8) -> dict:
    """step_time at the flagship on D shards of the card: the halo tail
    against D sequential master steps (exact), the outputs against D step
    calls (tests/test_timeshard_engine.py's bounds), ms a dispatch; then
    step_time through GraphStep against the eager step_time
    (graph_vs_eager: MESH_TS_CHECK dispatches bit for bit)."""
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft, master_init
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel.timeshard import batch_master_fft

    mesh = make_mesh([device] * D)
    et = rt.Engine(samprate=FS, real=True, groups=rx888_groups(rt), mesh=mesh, time_shards=D)
    es = rt.Engine(samprate=FS, real=True, groups=rx888_groups(rt), device=device)
    blocks = noise_blocks(es, 3 * D, N0_SCENE, device, 33)
    # the halo: D blocks at once against D sequential master steps
    seq, ms = [], master_init(es.master, device=device)
    for b in range(D):
        ms, F = master_fft(es.master, ms, blocks[b])
        seq.append(F)
    tail, Fb = batch_master_fft(es.master, master_init(es.master, device=device)["tail"],
                                blocks[:D], mesh)
    tail_exact = bool(torch.equal(tail.full(), ms["tail"]))
    f_err = float((Fb.full() - torch.stack(seq)).abs().max())
    if not tail_exact or f_err > 1e-6 * float(torch.stack(seq).abs().max()):
        fail(f"time shards: tail exact {tail_exact}, spectra differ by {f_err}")
    st, ss = et.init_state(), es.init_state()
    pt, ps = et.init_params(), es.init_params()
    worst = 0.0
    for k in range(2):
        st, ot = et.step_time(st, pt, blocks[k * D:(k + 1) * D])
        for d in range(D):
            ss, o = es.step(ss, ps, blocks[k * D + d])
            a, b = ot["hf"]["audio"][d], o["hf"]["audio"]
            over = float(((a - b).abs() / (2e-6 + 2e-5 * b.abs())).max())
            worst = max(worst, over)
    if not worst <= 1.0:
        fail(f"time shards: outputs off D step calls by {worst} x (rtol 2e-5, atol 2e-6)")
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    st, ot = et.step_time(st, pt, blocks[2 * D:])
    e1.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    del st, ss, ot, blocks
    # step_time as one graph replay a dispatch against the eager step_time
    gr = graph_vs_eager(et, device, f"step_time D={D}", D, n_check=MESH_TS_CHECK,
                        n_timed=MESH_TS_TIMED, n_traced=MESH_TS_TRACED)
    return {"D": D, "tail_exact": tail_exact, "spectra_max_abs_diff": f_err,
            "outputs_err_over_bound": worst, "ms_per_dispatch": ms,
            "host_enqueue_ms_per_dispatch": host_ms, "blocks_per_dispatch": D, "graph": gr}


def mesh_daemon_config(dport: int, sport: int) -> tuple[str, list[str]]:
    """examples/radiod@mesh-rx888.conf with the daemon phase's `reduced`:
    the front end a sig_gen at the same 129m6 real rate with a carrier
    1,500 Hz above one WSPR dial, the streams on local ports, no
    announcements."""
    import re

    text = MESH_CONF.read_text()
    feed = ("[rx888-feed]\ndevice = sig_gen\nsamprate = 129m6\nreal = yes\n"
            f"carrier = {MESH_DIAL + 1500:.0f}\namplitude = -60\nn0 = -138\n\n")
    text, n = re.subn(r"\[rx888-feed\].*?(?=\n\[WSPR\])", feed, text, flags=re.S)
    if n != 1:
        fail("the mesh config's [rx888-feed] section was not found")
    for name in ("hf8-pcm.local", "wspr-pcm.local", "ft8-pcm.local"):
        text = text.replace(f"data = {name}", f"data = 127.0.0.1:{dport}")
    text = text.replace("status = hf8.local", f"status = 127.0.0.1:{sport}")
    text = text.replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1)
    reduced = [
        "[rx888-feed]: device = rtp (rx888-iq.local, 129.6 Msps s16be) -> device = sig_gen at "
        f"samprate 129m6, real = yes: carrier {MESH_DIAL + 1500:.0f} Hz (the {MESH_DIAL:.0f} Hz "
        "WSPR dial + 1,500 Hz) at -60 dBFS, noise density -138 dBFS/Hz",
        f"data, status: hf8-pcm/wspr-pcm/ft8-pcm.local, hf8.local -> 127.0.0.1:{dport}, "
        f"127.0.0.1:{sport}",
        "sap = no, advertise = no: no SAP or mDNS announcements (the run has no network)",
    ]
    return text, reduced


def run_mesh_daemon(mesh) -> dict:
    """radiod-torch with `mesh = yes` on examples/radiod@mesh-rx888.conf, on
    `mesh` (None: the daemon's own make_mesh(), every local card): the
    carrier's tone at 1,500 Hz in the received RTP, a +500 Hz retune moving
    it to 1,000 Hz, and the block times; every dispatch a CUDA graph replay
    (the config has no spectrum group: no block has a reason to run
    eagerly)."""
    import select
    import socket

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    dport, sport = _free_port(), _free_port()
    text, reduced = mesh_daemon_config(dport, sport)
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", dport))
    t0 = time.perf_counter()
    rd = Radiod(load_config(text), use_network=True, data_port=dport, status_port=sport,
                mesh=mesh)
    t_init = time.perf_counter() - t0
    if rd.engine.mesh is None or rd.engine.digit is None:
        fail("mesh daemon: the engine is not the sharded one")
    ch = next((c for c in rd.chans.values() if c.freq == MESH_DIAL), None)
    if ch is None:
        fail(f"mesh daemon: no channel at the {MESH_DIAL} Hz dial")
    pkts: list[tuple[int, bytes]] = []

    def tone(nblocks: int) -> tuple[float, int]:
        pkts.clear()
        for _ in range(nblocks):
            rd.step_block()
            while select.select([rx], [], [], 0)[0]:
                h, payload = RtpHeader.unpack(rx.recv(65536))
                if h.ssrc == ch.ssrc:
                    pkts.append((h.seq, payload))
        audio = np.concatenate([np.frombuffer(p, ">i2") for _, p in sorted(pkts)]) \
            if pkts else np.zeros(0)
        return (peak_hz(audio.astype(np.float64), ch.samprate) if audio.size else 0.0), audio.size

    for _ in range(4):
        rd.step_block()
    rd._t_n = 0
    peak1, n1 = tone(48)
    p50, p99 = rd.latency_percentiles()
    rd.handle_packet(encode_status({T.OUTPUT_SSRC: ch.ssrc, T.COMMAND_TAG: 1,
                                    T.RADIO_FREQUENCY: MESH_DIAL + 500.0}, cmd=True))
    rd.step_block()
    peak2, n2 = tone(24)
    rx.close()
    for edge, _ in rd.edges.values():
        edge.close()
    out = {"D": rd.engine.mesh.size, "devices": [str(d) for d in rd.engine.mesh.devices],
           "reduced": reduced, "init_s": t_init,
           "groups": {n: g.C for n, g in rd.engine.groups.items()},
           "carrier_ssrc": ch.ssrc, "tone_hz": peak1, "tone_samples": int(n1),
           "retune_tone_hz": peak2, "retune_samples": int(n2),
           "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3, "block_drops": rd.block_drops,
           "graphs": daemon_graphs(rd)}
    cur = rd.graph_stats()["current"]
    if cur is None or cur["dispatch"] != "cuda graph" or not cur["replays"] \
            or cur["eager_blocks"]:
        fail(f"mesh daemon D={out['D']}: its dispatch is not graph replays alone: {cur}")
    if abs(peak1 - 1500.0) > 10.0 or n1 == 0:
        fail(f"mesh daemon D={out['D']}: the carrier's channel peaks at {peak1} Hz ({n1} "
             "samples), want 1500")
    if abs(peak2 - 1000.0) > 10.0:
        fail(f"mesh daemon D={out['D']}: after the +500 Hz retune the tone is at {peak2} Hz")
    return out


def run_mesh(rt, card: str, device) -> tuple[dict, dict]:
    """The mesh phase: flagship_parity on D = 4 and 8 shards of the card,
    the main path's launches and both kernels per shard, the sharded step
    eager and as CUDA graph replays (graph_vs_eager), step_time at D = 8
    (eager and as replays), the daemon with `mesh = yes` twice (its
    dispatch replays), and the sharded step's ms beside the single-device
    step's. Returns (the phase's JSON, per-kernel data for the kernels
    line)."""
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel.master import DigitMaster
    from ka9q_radio_tpu_torch.parallel.selftest import flagship_parity

    if device.type == "cuda":
        device = torch.device("cuda", 0)  # the mesh names the card D times: [cuda:0] * D
    t_phase = time.perf_counter()
    out = {"phase": "mesh", "card": card,
           "label": "D shards on one H100: the sharded code's overhead, not a multi-GPU speed",
           "unverified": "peer copies between distinct cards; shards running at once"}
    per_kernel: dict = {"channelize": {}, "noise_est": {}}
    for D in MESH_DS:
        mesh = make_mesh([device] * D)
        dm = DigitMaster.plan(mesh, "c", int(round(FS * 0.02 * 1.25)))
        print(f"mesh geometry: FLAGSHIP FS={FS:,} N={dm.n1 * dm.n2:,} split={dm.n1}x{dm.n2} "
              f"D={D} devices={[str(d) for d in mesh.devices]}", flush=True)
        t0 = time.perf_counter()
        par = flagship_parity(mesh, nblocks=MESH_BLOCKS, FS=FS)
        par["seconds"] = time.perf_counter() - t0
        # the flagship (rx888: 1,000 hf SSB channels, the sweep) on D shards
        em = rt.Engine(samprate=FS, real=True, groups=rx888_groups(rt), mesh=mesh)
        launch = mesh_step_check(em, device)
        kern = mesh_kernels(em, device)
        params = em.init_params()
        tm = timed_run(em, params, device, nblocks=32)
        if not tm["finite"] or tm["launches"]["channelize"] != D * tm["blocks"]:
            fail(f"mesh D={D} timed run: launches {tm['launches']}, finite {tm['finite']}")
        # the compiled dispatch of the mesh: the step as graph replays
        # against the eager step, bit for bit, and A's launches D a block
        gr = graph_vs_eager(em, device, f"mesh D={D}")
        if gr["launches"]["channelize"] != D * gr["bit_equal_blocks"]:
            fail(f"mesh D={D} graphs: launches {gr['launches']}, want channelize "
                 f"{D * gr['bit_equal_blocks']}")
        out[f"d{D}"] = {"parity": par, "main_path": launch,
                        "kernels": {"shards": kern["shards"],
                                    "max_abs_err_a": kern["max_abs_err_a"],
                                    "err_bound_a": kern["err_bound_a"],
                                    "max_rel_err_b": kern["max_rel_err_b"]},
                        "sharded_step": {k: tm[k] for k in ("ms_per_block",
                                                            "host_enqueue_ms_per_block", "msps")},
                        "graph": gr}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_call",
                "max_abs_err", "shape")
        for name in per_kernel:
            k = kern["shard0"][name]
            per_kernel[name][f"d{D}"] = {
                "local_C": launch["local_C"], "launches_per_block": D,
                "launches": launch["launches"][name], "graph_launches": gr["launches"][name],
                "in_graph_ms": gr["kernel_in_graph_ms"][name],
                **{x: k[x] for x in keys if x in k}}
        del em
        torch.cuda.empty_cache()
    es = rt.Engine(samprate=FS, real=True, groups=rx888_groups(rt), device=device)
    ts = timed_run(es, es.init_params(), device, nblocks=32)
    out["single_device_step"] = {k: ts[k] for k in ("ms_per_block", "host_enqueue_ms_per_block",
                                                   "msps")}
    del es
    out["time_shards"] = mesh_time_shards(rt, device)
    out["daemon_make_mesh"] = run_mesh_daemon(None)
    out["daemon_4_shards"] = run_mesh_daemon(make_mesh([device] * 4))
    out["seconds"] = time.perf_counter() - t_phase
    return out, per_kernel


# ------------------------------------------------ a mesh of several processes
MH_NPROC, MH_LOCAL = 2, 2  # processes, shards of the one card each: a mesh of 4
MH_TIMED = 8  # steps timed a process
MH_TIMEOUT_S = 420.0  # both workers, from their start to their last line
MH_GROUP_TIMEOUT_S = 180.0  # a collective that waits longer for its peer raises


def multihost_worker(rank: int, nproc: int, port: int, device, fs: float) -> dict:
    """One process of the `multihost` phase's mesh (chip_smoke.py
    --multihost-worker): gloo over 127.0.0.1, MH_LOCAL shards of `device`
    a process. flagship_parity at `fs` (this process's rows against a
    single-device engine), batch_master_fft across the process boundary
    (each of its spectra against sequential master_fft steps, the halo tail
    exact), the rx888 engine's main path (A and B MH_LOCAL times a block in
    the counts, and on one due step alone), A and B on its shards' rows against their
    plain versions, then MH_TIMED timed steps. The processes time their
    kernels one after the other. Returns what its process prints."""
    import torch.distributed as dist

    import ka9q_radio_tpu_torch.runtime as rt
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft, master_init
    from ka9q_radio_tpu_torch.parallel import distributed as dd
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.parallel import sharding as tsh
    from ka9q_radio_tpu_torch.parallel.selftest import flagship_parity
    from ka9q_radio_tpu_torch.parallel.timeshard import batch_master_fft

    dd.initialize(f"127.0.0.1:{port}", nproc, rank, backend="gloo",
                  timeout_s=MH_GROUP_TIMEOUT_S)
    try:
        mesh = make_mesh(local_devices=[device] * MH_LOCAL)
        D = mesh.size
        out = {"rank": rank, "processes": nproc, "devices": [str(d) for d in mesh.devices],
               "local": mesh.local, "transport": f"{dd.backend()}, staged through host memory"}
        t0 = time.perf_counter()
        par = flagship_parity(mesh, nblocks=MESH_BLOCKS, FS=fs)
        out["parity"] = {**par, "seconds": time.perf_counter() - t0}
        # the halo across the process boundary: D blocks, one a shard
        es = rt.Engine(samprate=fs, real=True, groups=rx888_groups(rt), device=device)
        blocks = noise_blocks(es, D, N0_SCENE, device, 33)
        seq, ms = [], master_init(es.master, device=device)
        for b in range(D):
            ms, F = master_fft(es.master, ms, blocks[b])
            seq.append(F)
        tail, Fb = batch_master_fft(es.master, master_init(es.master, device=device)["tail"],
                                    blocks, mesh)
        rel = max(float((Fb.shards[d][0] - seq[d]).abs().max() / seq[d].abs().max())
                  for d in mesh.local)
        tail_exact = bool(torch.equal(tail.first, ms["tail"]))
        if not tail_exact or not rel < 1e-5:
            fail(f"multihost rank {rank}: halo tail exact {tail_exact}, spectra rel err {rel}")
        out["halo"] = {"blocks": D, "max_rel_err": rel, "tail_exact": tail_exact}
        del es, seq, Fb, F
        # the main path by the counts, then A and B per shard, one
        # process at a time on the card
        em = rt.Engine(samprate=fs, real=True, groups=rx888_groups(rt), mesh=mesh)
        out["main_path"] = mesh_step_check(em, device)
        kern = None
        for r in range(nproc):
            if r == rank:
                kern = mesh_kernels(em, device)
            dist.barrier()
        out["kernels"] = {k: kern[k] for k in ("shards", "max_abs_err_a", "err_bound_a",
                                               "max_rel_err_b")}
        keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library_call",
                "max_abs_err", "shape")
        out["per_kernel"] = {
            name: {"local_C": out["main_path"]["local_C"], "launches_per_block": MH_LOCAL,
                   "launches": out["main_path"]["launches"][name],
                   **{x: k[x] for x in keys if x in k}}
            for name, k in kern["shard0"].items()}
        # MH_TIMED steps: CUDA events and the host clock, the bytes that
        # cross processes and the kernels' launches
        params = em.init_params()
        blocks = noise_blocks(em, 4 + MH_TIMED, N0_SCENE, device, 2)
        st = em.init_state()
        for b in range(4):
            st, _ = em.step(st, params, blocks[b])
        torch.cuda.synchronize()
        dist.barrier()
        tsh.reset_traffic()
        cc.reset_launches()
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        for b in range(4, 4 + MH_TIMED):
            st, o = em.step(st, params, blocks[b])
        e1.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / MH_TIMED
        launches = {k: cc.launches[k] for k in ("channelize", "noise_est")}
        if launches["channelize"] != MH_LOCAL * MH_TIMED or not outputs_finite(o):
            fail(f"multihost rank {rank} timed run: launches {launches}")
        out["timed"] = {"blocks": MH_TIMED, "ms_per_block": e0.elapsed_time(e1) / MH_TIMED,
                        "wall_ms_per_block": wall, "launches": launches,
                        "msps": em.L / (wall * 1e-3) / 1e6,
                        "cross_process_bytes_per_block": tsh.traffic["bytes"] / MH_TIMED,
                        "cross_process_collectives_per_block":
                            tsh.traffic["collectives"] / MH_TIMED,
                        "cross_process_host_ms_per_block":
                            tsh.traffic["seconds"] * 1e3 / MH_TIMED,
                        "hf_rows": [em.groups["hf"].rows.start, em.groups["hf"].rows.stop],
                        "audio_shape": list(o["hf"]["audio"].shape)}
        return out
    finally:
        dd.shutdown()


def _free_tcp_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multihost(card: str, out_dir: Path, one_process_ms: float) -> tuple[dict, dict]:
    """The multihost phase: MH_NPROC worker processes of this script, each
    with MH_LOCAL shards of cuda:0 (one mesh of MH_NPROC x MH_LOCAL shards
    over gloo; NCCL refuses two processes on one card). Fails if a worker
    exits non-zero or prints no result. Returns (the phase's JSON, rank 0's
    per-kernel data for the kernels line)."""
    t0 = time.perf_counter()
    port = _free_tcp_port()
    procs = [subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"), "--multihost-worker",
                               str(r), str(MH_NPROC), str(port)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(MH_NPROC)]
    res = []
    try:
        for r, p in enumerate(procs):
            left = max(MH_TIMEOUT_S - (time.perf_counter() - t0), 1.0)
            try:
                so, se = p.communicate(timeout=left)
            except subprocess.TimeoutExpired:
                so, se = "", f"no result within {MH_TIMEOUT_S} s"
            (out_dir / f"multihost_rank{r}.log").write_text(se)
            last = so.strip().splitlines()[-1] if so.strip() else ""
            res.append((p.returncode, last, se))
    finally:
        for p in procs:  # a worker that hangs dies with the phase
            if p.poll() is None:
                p.kill()
                p.communicate()
    ranks = []
    for r, (rc, last, se) in enumerate(res):
        if rc != 0 or not last.startswith("{"):
            fail(f"multihost: worker {r} exited {rc} with no result: {se[-2000:]}")
        ranks.append(json.loads(last))
    for w in ranks:
        one = w["main_path"]["due_step_launches"]  # the tail's held in the worker
        if w["main_path"]["launches"]["channelize"] != MH_LOCAL * w["main_path"]["blocks"] \
                or {k: one[k] for k in ("channelize", "noise_est")} != {"channelize": MH_LOCAL,
                                                                        "noise_est": MH_LOCAL}:
            fail(f"multihost rank {w['rank']}: launches {w['main_path']}")
    out = {"phase": "multihost", "card": card, "processes": MH_NPROC,
           "shards_per_process": MH_LOCAL, "transport": ranks[0]["transport"],
           "nccl": "not run: NCCL refuses two processes on one card (it waits for a machine "
                   "with several cards)",
           "label": "2 processes x 2 shards of one H100 over gloo: the cost of the "
                    "cross-process code, not a multi-GPU speed",
           "ms_per_block": [w["timed"]["wall_ms_per_block"] for w in ranks],
           "one_process_4_shards_ms_per_block": one_process_ms,
           "cross_process_bytes_per_block": [w["timed"]["cross_process_bytes_per_block"]
                                             for w in ranks],
           "cross_process_host_ms_per_block": [w["timed"]["cross_process_host_ms_per_block"]
                                               for w in ranks],
           "ranks": ranks, "seconds": time.perf_counter() - t0}
    return out, ranks[0]["per_kernel"]


CHURN_S = 45.0  # the churn phase's soak, after its warm-up
CHURN_DYN_SLOTS = 4  # spares a class: creates drain the pools, so restocks swap in


def run_churn(card: str, out_dir: Path) -> dict:
    """tools/churn_soak_torch.py on the card for CHURN_S seconds (its
    config, time-shards 16 and a 1m024 complex sig_gen, with CHURN_DYN_SLOTS
    spares a class instead of 24; creates, removes, preset moves and
    retunes at restocking pace), RTP and status on 127.0.0.1. Fails unless
    its invariants hold (no foreground rebuild after warm-up, no dropped
    block, RSS and device memory on a plateau) and at least one background
    restock, built on the side stream, swapped in under the churn."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "churn_soak_torch.py"),
                        "--seconds", str(CHURN_S), "--device", "cuda", "--loopback",
                        "--dyn-slots", str(CHURN_DYN_SLOTS),
                        "--rss-out", str(out_dir / "churn_rss.jsonl")],
                       cwd=ROOT, capture_output=True, text=True, timeout=CHURN_S + 300)
    (out_dir / "churn.log").write_text(r.stderr)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if not last.startswith("{"):
        fail(f"churn: the soak printed no result (exit {r.returncode}): {r.stderr[-2000:]}")
    soak = json.loads(last)
    if r.returncode != 0 or not soak["ok"]:
        fail(f"churn: invariants failed (exit {r.returncode}): {soak}")
    if soak["restock_swaps"] < 1:
        fail(f"churn: no background restock swapped in: {soak}")
    return {"phase": "churn", "card": card, "tool": "tools/churn_soak_torch.py",
            "soak_seconds": CHURN_S, **soak, "seconds": time.perf_counter() - t0}


# ------------------------------------------------- the RTP A/D front end
INGEST_FPP = 8192  # frames a packet on loopback (see ingest_config's `reduced`)
INGEST_RAW_S = 2.0  # the raw run's stream seconds at 8,192 frames a packet
INGEST_RAW_MTU_S = 0.25  # and at 704 (an Ethernet MTU), flat-out-limited by the loopback
INGEST_WARM, INGEST_DISPATCHES = 1, 8  # the flagship's dispatches (8 blocks each)
VHF_INGEST_WARM, VHF_INGEST_BLOCKS = 4, 50  # the 2 m feed's (one block each)


def tool_module(name: str):
    """tools/<name>.py as a module (tools/ is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ingest_config(conf: Path, section: str, port: int, dport: int, sport: int,
                  status: str, data: str) -> tuple[str, list[str], dict]:
    """`conf` with its [section] RTP stream pointed at 127.0.0.1:port (fed
    by ingest_blast), its data and status on local ports (a section's own
    `data =` stream on a port of its own) and no SAP or mDNS: (config text,
    the changes for `reduced`, {each section's stream: its port})."""
    import re

    text = conf.read_text()
    pat = rf"(\[{re.escape(section)}\][^\[]*?\nstream\s*=\s*)(\S+)"
    m = re.search(pat, text)
    if m is None:
        fail(f"ingest: no `stream =` in {conf.name}'s [{section}]")
    text = text[:m.start(2)] + f"127.0.0.1:{port}" + text[m.end(2):]
    text = text.replace(f"status = {status}", f"status = 127.0.0.1:{sport}")
    text = text.replace(f"data = {data}", f"data = 127.0.0.1:{dport}")
    streams: dict[str, int] = {}

    def own_port(m):
        streams[m.group(2)] = _free_port()
        return f"{m.group(1)}127.0.0.1:{streams[m.group(2)]}"

    text = re.sub(r"(?m)^(data\s*=\s*)(?!127\.0\.0\.1:)(\S+)", own_port, text)
    text = text.replace("[global]\n", "[global]\nsap = no\nadvertise = no\n", 1)
    return text, [
        f"[{section}] stream: {m.group(2)} -> 127.0.0.1:{port}, fed by ingest_blast (the port's "
        "native paced sender: the s16be ramp ((frame & 0x3fff) - 0x2000) on every sample)",
        f"data, status: {data}, {status} -> 127.0.0.1:{dport}, 127.0.0.1:{sport}",
        *(f"data: {n} -> 127.0.0.1:{p}" for n, p in streams.items()),
        "sap = no, advertise = no: no SAP or mDNS announcements (the run has no network)"], streams


def fused_groups(eng) -> int:
    """The engine's groups that launch the linear tail kernel each block
    (`_Group.fused_tail`, with rows)."""
    return sum(1 for g in eng.groups.values() if g.fused_tail and g.C > 0)


def expected_launches(eng, j0: int, j1: int) -> dict:
    """Kernel A, B and linear tail launches of the engine's groups over
    blocks j0..j1-1, every group made with the engine: A each block in a
    group that takes the tiled kernel, B on the N0 cadence in each group
    that estimates N0 (and on the first 2 blocks, the groups' warm-up), the
    linear tail each block in each fused group."""
    due = sum(1 for b in range(j0, j1)
              if b < 2 or eng.noise_every == 1 or b % eng.noise_every == 0)
    n_a = n_b = 0
    for g in eng.groups.values():
        if g.spec.demod == "spectrum" and (g.spectrum_wide or not g.host["armed"]):
            continue
        n_b += 1
        n_a += int(g.tiled and not g.spec.beam and g.tile_E is not None)
    return {"channelize": (j1 - j0) * n_a, "noise_est": due * n_b,
            "linear_tail": (j1 - j0) * fused_groups(eng)}


def leaves_finite(tree) -> tuple[bool, int]:
    """Whether every float or complex tensor (or array) in a nest of dicts,
    lists and tuples is finite, and how many values were checked."""
    ok, n = True, 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif torch.is_tensor(x) and (x.is_floating_point() or x.is_complex()):
            ok, n = ok and bool(torch.isfinite(x).all()), n + x.numel()
        elif isinstance(x, np.ndarray) and x.dtype.kind in "fc":
            ok, n = ok and bool(np.isfinite(x).all()), n + x.size
    return ok, n


def step_outputs_finite(eng, out) -> tuple[bool, int]:
    """leaves_finite of a step's outputs, less the `snr` readout of linear
    channels with neither SNR squelch nor a PLL, which models/linear.py
    sets to +inf by design (the status then leaves PLL_SNR out)."""
    trimmed = {}
    for g, o in out.items():
        grp = eng.groups.get(g)
        hd = grp.host.get("demod", {}) if grp is not None else {}
        if "snr_squelch_enable" not in hd or grp.spec.enable_pll or "snr" not in o["info"]:
            trimmed[g] = o
            continue
        keep = torch.as_tensor(np.asarray(hd["snr_squelch_enable"], bool),
                               device=o["info"]["snr"].device)
        trimmed[g] = {**o, "info": {**o["info"], "snr": o["info"]["snr"][..., keep]}}
    return leaves_finite(trimmed)


def ingest_daemon(card: str, device, conf: Path, section: str, status: str, data: str,
                  fs: float, width: int, fpp: int, warm: int, dispatches: int, trace: bool,
                  tool) -> tuple[dict, dict]:
    """`conf` through the port's Radiod on `device`, its [section] RTP
    stream fed by ingest_blast at fs in fpp-frame packets (width samples a
    frame): warm dispatches, then `dispatches` timed, then (trace) one under
    the profiler. Holds the first timed dispatch's block, copied back from
    the card, to the ramp bit for bit; A and B to their counts; every float
    output of that dispatch to finite; the RTP audio to the channels' own
    SSRCs; and the frames sent to those read, dropped and still buffered.
    Returns (the run's JSON, kernels A and B checked at its shapes)."""
    import select
    import socket
    import threading

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.native import ingest_blast
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    port, dport, sport = _free_port(), _free_port(), _free_port()
    text, reduced, streams = ingest_config(conf, section, port, dport, sport, status, data)
    rxs = {}
    for p in (dport, *streams.values()):
        rxs[p] = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        rxs[p].setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
        rxs[p].bind(("127.0.0.1", p))
        rxs[p].setblocking(False)
    t0 = time.perf_counter()
    rd = Radiod(load_config(text), use_network=True, data_port=dport, status_port=sport,
                device=device)
    t_init = time.perf_counter() - t0
    fe, eng = rd.frontend, rd.engine
    st_fe = fe.stats()
    if not st_fe["native"]:
        fail(f"ingest {conf.name}: the RTP source is not the native reader: "
             f"{fe.fallback_reason}")
    L, D = eng.L, rd._time_shards or 1
    per = L * D  # frames a dispatch
    nsend = (warm + dispatches + int(trace) + 2) * per
    sender: dict = {}

    def tx():
        t = time.perf_counter()
        sender["frames"] = ingest_blast(("127.0.0.1", port), encoding=tool.S16BE, width=width,
                                        frames_per_pkt=fpp, nframes=nsend, pace_fps=int(fs))
        sender["s"] = time.perf_counter() - t

    ssrcs = {c.ssrc for c in rd.chans.values()}
    heard: dict[int, int] = {}
    heard_on: dict[int, set] = {}  # ssrc -> the ports it arrived on
    # each channel's stream: its section's own `data =`, else the global one
    own = {c.ssrc: (int(str(eng.groups[c.group].spec.data).rsplit(":", 1)[1])
                    if eng.groups[c.group].spec.data else dport) for c in rd.chans.values()}

    def drain():
        for p, rx in rxs.items():
            while select.select([rx], [], [], 0)[0]:
                h, _ = RtpHeader.unpack(rx.recv(65536))
                heard[h.ssrc] = heard.get(h.ssrc, 0) + 1
                heard_on.setdefault(h.ssrc, set()).add(p)

    kept: dict = {}
    to_device, step = rd._to_device, rd.step

    def keep_block(block):
        t = to_device(block)
        if "block" not in kept:
            kept["block"] = t.clone()
        return t

    def keep_out(state, params, block):
        state, out = step(state, params, block)
        if "finite" not in kept:
            kept["finite"] = step_outputs_finite(eng, out)
        return state, out

    th = threading.Thread(target=tx, daemon=True)
    try:
        bind_s = tool.wait_bound(("127.0.0.1", port), fe.stats)
        th.start()
        t0 = time.perf_counter()
        for _ in range(warm):
            rd.step_block()
            drain()
        t_warm = time.perf_counter() - t0
        rd._to_device, rd.step = keep_block, keep_out
        rd.frontend_host = dict.fromkeys(rd.frontend_host, 0)
        rd._t_n = 0
        cc.reset_launches()
        heard.clear()
        j0, b0, drops0, ovf0 = (rd.state["host"]["jobnum"], rd.blocks, rd.block_drops,
                                rd.egress_overflows)
        t0 = time.perf_counter()
        for _ in range(dispatches):
            rd.step_block()
            drain()
        if device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rd._to_device, rd.step = to_device, step
        time.sleep(0.05)  # the last dispatch's packets on the loopback
        drain()
        opened = {c.ssrc for c in rd.chans.values() if c.sending}  # after the last timed block
        heard_timed = set(heard)
        overflowed = rd.egress_overflows - ovf0
        launches = {k: cc.launches[k] for k in MAIN_KERNELS}
        want = expected_launches(eng, j0, rd.state["host"]["jobnum"])
        blocks, split = rd.blocks - b0, rd.frontend_split()
        p50, p99 = rd.latency_percentiles()
        busy = None
        if trace:
            _, kern, twall, note = traced(lambda: (rd.step_block(), drain()), f"ingest {conf.name}")
            dev_ms = sum(ev.time_range.elapsed_us() for ev in kern) / 1e3
            busy = {"traced_dispatches": 1, "device_busy_ms_per_dispatch": dev_ms,
                    "wall_ms_per_dispatch_traced": twall, "device_idle_share": 1.0 - dev_ms / twall,
                    "kernel_in_daemon_ms": per_launch_ms(kern, KERNEL_NAMES), **note}
        th.join(timeout=nsend / fs + 30.0)
        st = tool.settle(fe.stats)
        drain()
    finally:
        fe.close()
        for edge_, _ in rd.edges.values():
            edge_.close()
        for rx in rxs.values():
            rx.close()
    # the first timed dispatch's block on the card against the ramp, bit for bit
    host_blk = kept["block"].cpu()
    frames = (torch.view_as_real(host_blk) if host_blk.is_complex() else host_blk[..., None])
    frames = frames.reshape(-1, width).numpy()
    k0 = int(np.rint(float(frames[0, 0]) * 32767.0)) + 0x2000
    ramp = tool.ramp_value(((k0 + np.arange(frames.shape[0])) & 0x3fff) - 0x2000, tool.S16BE)
    off_ramp = int((frames.view(np.uint32) != ramp.view(np.uint32)[:, None]).any(1).sum())
    reads = (warm + dispatches + int(trace)) * per
    acc = tool.accounting(sender.get("frames", -1), (reads - st["starve_frames"]) * width, st,
                          width)
    finite, n_finite = kept["finite"]
    out = {"config": str(conf.relative_to(ROOT) if conf.is_relative_to(ROOT) else conf),
           "reduced": reduced, "init_s": t_init,
           "fs_msps": fs / 1e6, "width": width, "frames_per_pkt": fpp, "L": L,
           "time_shards": D, "channels": len(rd.chans), "bind_wait_s": bind_s,
           "warm_dispatches": warm,
           "warm_s": t_warm, "dispatches": dispatches, "blocks": blocks, "wall_s": wall,
           "achieved_msps": blocks * L / wall / 1e6,
           "realtime_margin": (blocks * L / fs) / wall, "p50_ms": p50 * 1e3, "p99_ms": p99 * 1e3,
           "block_drops": rd.block_drops - drops0, "host_ms_per_dispatch": split,
           "h2d_bytes_per_dispatch": split["h2d_bytes"],
           "sender": {**sender, "msps": sender["frames"] / sender["s"] / 1e6
                      if "frames" in sender else None},
           "ingest": {k: v for k, v in st.items() if k != "native"},
           "native_reader": bool(st["native"]), **acc,
           "ramp_first_dispatch": {"frames": int(frames.shape[0]), "off_ramp": off_ramp,
                                   "first_k": k0},
           "launches": launches, "want_launches": want,
           "finite": finite, "finite_values_checked": n_finite,
           "rtp_packets": sum(heard.values()), "rtp_ssrcs": len(heard),
           "rtp_foreign_ssrcs": sorted(set(heard) - ssrcs)[:10],
           "rtp_streams": len(rxs),
           "rtp_off_stream": sorted(s for s, ps in heard_on.items() if ps != {own.get(s)})[:10],
           "open_last_timed_block": len(opened),
           "open_not_heard": len(opened - heard_timed),
           "egress_overflows_timed": overflowed, **(busy or {})}
    what = f"ingest {conf.name}"
    if off_ramp:
        fail(f"{what}: the first timed dispatch's block is off the ramp on {off_ramp} frames")
    if launches != want:
        fail(f"{what}: launches {launches}, want {want}")
    if not finite or not n_finite:
        fail(f"{what}: non-finite outputs ({n_finite} values checked)")
    # every channel open at the last timed block sent audio on the socket
    # (all of them unless the egress slots overflowed), and no other SSRC did
    if out["rtp_foreign_ssrcs"] or (opened - heard_timed and not overflowed) \
            or len(heard_timed) < min(len(opened), 1):
        fail(f"{what}: RTP audio from {len(heard)} SSRCs (foreign "
             f"{out['rtp_foreign_ssrcs']}); {len(opened)} channels open at the last timed "
             f"block, {len(opened - heard_timed)} of them not heard, {overflowed} overflows")
    if out["rtp_off_stream"]:
        fail(f"{what}: RTP of SSRCs {out['rtp_off_stream']} off their sections' own streams")
    if not acc["accounting_ok"]:
        fail(f"{what}: frames do not add up: {acc}")
    if not out["native_reader"]:
        fail(f"{what}: the reader was not native")
    # A and B against their plain versions on the master spectrum of the
    # ramp's first block, at the daemon's shapes
    _, F = master_fft(eng.master, eng.init_state()["master"], kept["block"].reshape(-1, L)[0])
    group = next((n for n, g in eng.groups.items() if g.tiled and g.tile_E is not None), None)
    at = {k["name"]: k for k in check_kernels(eng, rd.params, F, group)} if group else {}
    return out, {name: {"group": group, "C": eng.groups[group].C, "launches": launches[name],
                        "in_daemon_ms": (busy or {}).get("kernel_in_daemon_ms", {}).get(name),
                        **{x: at[name][x] for x in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                    "library_ms", "max_abs_err", "max_rel_err",
                                                    "err_bound") if x in at[name]}}
                 for name in at}


def run_ingest(card: str, device) -> tuple[dict, dict]:
    """The RTP A/D front end on the card: (a) the raw loopback ceiling,
    paced 8,192-frame packets at 129.6 Msps, then 704-frame ones, every
    frame held to the ramp; the host-to-card copy of one flagship dispatch,
    pinned and pageable; (b) the flagship config fed at 129.6 Msps; (c)
    the 2 m config's complex 5.12 Msps feed (the I/Q framing). Returns (the
    phase's JSON, A and B at the flagship's ingest)."""
    tool = tool_module("bench_ingest_torch")
    t_phase = time.perf_counter()
    out = {"phase": "ingest", "card": card}
    raw = {"paced_8192": tool.bench_raw(FS, INGEST_RAW_S, False, INGEST_FPP),
           "paced_704": tool.bench_raw(FS, INGEST_RAW_MTU_S, False, 704)}
    for name, r in raw.items():
        if not (r["ramp_accounted"] and r["accounting_ok"]) or r["ramp_frames_checked"] == 0:
            fail(f"ingest raw {name}: ramp or frame accounting off: {r}")
    out["raw"] = raw
    blk = torch.zeros(8 * 2_592_000, dtype=torch.float32)
    pinned = blk.pin_memory()
    out["h2d"] = {"bytes": blk.numel() * 4,
                  "pinned_ms": event_ms(lambda: pinned.to(device, non_blocking=True), n=10,
                                        what="h2d pinned"),
                  # a pageable copy synchronises the host: no capture
                  "pageable_ms": _back_to_back_ms(lambda: blk.to(device), n=5, warm=3)}
    out["h2d"]["pinned_gbs"] = out["h2d"]["bytes"] / out["h2d"]["pinned_ms"] / 1e6
    out["h2d"]["pageable_gbs"] = out["h2d"]["bytes"] / out["h2d"]["pageable_ms"] / 1e6
    del blk, pinned
    mtu = raw["paced_704"]["rx_msps"]
    flag, at = ingest_daemon(card, device, WSPR_CONF, "adc", "hffarm.local", "hffarm-pcm.local",
                             FS, 1, INGEST_FPP, INGEST_WARM, INGEST_DISPATCHES, True, tool)
    flag["reduced"].append(
        f"the stream in {INGEST_FPP:,}-frame packets, not an SDR host's 704 (an Ethernet MTU): "
        f"the raw 704-frame run here carried {mtu:.1f} Msps on the loopback (gVisor's packet "
        "rate), under the 129.6 Msps the config runs at")
    flag["reduced"].append(
        f"{INGEST_DISPATCHES} timed dispatches ({INGEST_DISPATCHES * 8} blocks) after "
        f"{INGEST_WARM} warm one and before 1 traced; the sender stops after that many "
        "dispatches' frames and 2 more")
    out["flagship"] = {**flag, "kernels": at}
    torch.cuda.empty_cache()
    vhf, at_vhf = ingest_daemon(card, device, VHF_CONF, "vhf-feed", "2m.local", "2m-pcm.local",
                                VHF_FEED_FS, 2, 704, VHF_INGEST_WARM, VHF_INGEST_BLOCKS, False,
                                tool)
    vhf["reduced"].append(f"{VHF_INGEST_BLOCKS} timed blocks after {VHF_INGEST_WARM} warm ones")
    out["vhf"] = {**vhf, "kernels": at_vhf}
    out["seconds"] = time.perf_counter() - t_phase
    return out, at


# ------------------------------------------------- the compiled dispatch
GRAPH_CELLS = ("rx888", "rx888x4", "nbfm400", "wfm", "odd_master", "hf32000", "linear8")
GRAPH_CHECK = 12  # blocks held bit for bit, replay against the eager step
# blocks timed each way (the engine phases time 64: the cut keeps the script
# inside its time) and graph dispatches traced (the trace's first block
# loses its events: with 8, a later block is N0-due and B is seen)
GRAPH_TIMED, GRAPH_TRACED = 32, 8


def graph_summary(stats: dict) -> dict:
    """What a phase's line keeps of GraphStep.graph_stats(): the dispatch,
    captures and their ms, replays, eager blocks by reason, copies in, and
    per graph its pool MB and launches a replay."""
    return {"dispatch": stats["dispatch"], "captures": stats["captures"],
            "capture_ms": stats["capture_ms"], "replays": stats["replays"],
            "eager_blocks": stats["eager_blocks"], "state_copies_in": stats["state_copies_in"],
            "pool_mb": {k: None if g["pool_bytes"] is None else g["pool_bytes"] / 2**20
                        for k, g in stats["graphs"].items()},
            "launches_per_replay": {k: g["launches"] for k, g in stats["graphs"].items()}}


def daemon_graphs(rd) -> dict:
    """A daemon's graph_summary, with the totals of its engines before
    (rebuilds and restocks)."""
    st = rd.graph_stats()
    return {**graph_summary(st["current"]),
            "engines_before": st["before"]}


def graph_vs_eager(eng, device, what: str, D: int = 0, n_check: int = GRAPH_CHECK,
                   n_timed: int = GRAPH_TIMED, n_traced: int = GRAPH_TRACED) -> dict:
    """An engine eager and as CUDA graph replays (GraphStep(eng, D)), from
    the same state, params and noise blocks: n_check dispatches side by side
    (a retune after a third of them, the sweep disarmed from the half on
    for a sixth where there is one) held bit for bit, outputs, state (made
    whole on a mesh) and host mirrors, with the launch counters equal; then
    n_timed dispatches each way under sync-debug "error" (CUDA events: ms a
    block; the host's clock: the enqueue), and n_traced graph dispatches
    under the profiler for the device's busy ms (the same kernels as the
    eager step's: both idle shares use it) and kernels A's and B's device ms
    a launch inside the replays. D blocks a dispatch with time shards (a
    time-sharded mesh engine's step_time), one without."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.parallel.sharding import full_tree
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep, _flatten

    per = max(D, 1)
    n0 = N0_SCENE if eng.master.real else NBFM_N0
    blocks = noise_blocks(eng, (n_check + n_timed + n_traced) * per, n0, device, 41)
    if D:
        blocks = blocks.reshape((-1, D) + tuple(blocks.shape[1:]))
    params = eng.init_params()
    gs = GraphStep(eng, D)
    se, sg = eng.init_state(), eng.init_state()
    launches = {"eager": dict.fromkeys(cc.launches, 0), "graph": dict.fromkeys(cc.launches, 0)}
    differ = []

    def leaves(out, state):
        state = full_tree({k: v for k, v in state.items() if k != "host"})
        return ([(("out",) + p, v) for p, v in _flatten(out)]
                + [(("state",) + p, v) for p, v in _flatten(state)])

    off, on = n_check // 2, n_check // 2 + max(1, n_check // 6)
    t0 = time.perf_counter()
    for b in range(n_check):
        if b == n_check // 3:
            g0 = next(iter(eng.groups.values()))
            eng.retune(params, g0.spec.name, 0, float(g0.spec.channels[0].freq) + 500.0)
        if "sweep" in eng.groups and b in (off, on):
            eng.set_armed(params, "sweep", b == on)
        for mode in ("eager", "graph"):
            cc.reset_launches()
            if mode == "eager":
                se, oe = gs.eager(se, params, blocks[b])
            else:
                sg, og = gs(sg, params, blocks[b])
            torch.cuda.synchronize()
            for k, v in cc.launches.items():
                launches[mode][k] += v
        got, want = leaves(og, sg), dict(leaves(oe, se))
        if [w for w, _ in got] != list(want):
            differ.append([b, "tree structure", None])
        for w, a in got:
            c = want.get(w)
            if c is None or a.shape != c.shape or not torch.equal(a, c):
                differ.append([b, w, None if c is None or a.shape != c.shape
                               else float((a.to(c.dtype) - c).abs().max())])
        if sg["host"] != se["host"]:
            differ.append([b, "host", None])
    check_s = time.perf_counter() - t0
    if differ or launches["eager"] != launches["graph"]:
        fail(f"graphs {what}: replay differs from the eager step at {differ[:8]}; launches "
             f"{launches}")

    def timed(step, st):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t = time.perf_counter()
            e0.record()
            for b in range(n_check, n_check + n_timed):
                st, out = step(st, params, blocks[b])
            e1.record()
            host = (time.perf_counter() - t) * 1e3 / (n_timed * per)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return st, out, e0.elapsed_time(e1) / (n_timed * per), host

    se, oe, eager_ms, eager_enq = timed(gs.eager, se)
    sg, og, graph_ms, graph_enq = timed(gs, sg)
    finite = outputs_finite(og) and outputs_finite(oe)
    j = n_check + n_timed

    def body():
        nonlocal sg
        for b in range(j, j + n_traced):
            sg, _ = gs(sg, params, blocks[b])

    _, kern, _, note = traced(body, f"graphs {what}")
    busy = sum(ev.time_range.elapsed_us() for ev in kern) / 1e3 / (n_traced * per)
    stats = gs.graph_stats()
    out = {"channels": sum(g.C for g in eng.groups.values()), "inputs": eng.n_inputs,
           "blocks_per_dispatch": per, "check_s": check_s, "bit_equal_blocks": n_check * per,
           "launches": launches["graph"], "eager_launches": launches["eager"],
           "ms_per_block": {"graph": graph_ms, "eager": eager_ms},
           "enqueue_ms_per_block": {"graph": graph_enq, "eager": eager_enq},
           "msps": {"graph": eng.n_inputs * eng.L / graph_ms / 1e3,
                    "eager": eng.n_inputs * eng.L / eager_ms / 1e3},
           "busy_ms_per_block": busy, "kernels_per_block": len(kern) / (n_traced * per),
           "kernel_in_graph_ms": per_launch_ms(kern, KERNEL_NAMES),
           "device_idle_share": {"graph": 1.0 - busy / graph_ms if kern else None,
                                 "eager": 1.0 - busy / eager_ms if kern else None},
           "finite": finite, **graph_summary(stats), **note}
    if not finite or stats["replays"] < n_check + n_timed - 2:
        fail(f"graphs {what}: finite {finite}, {stats['replays']} replays, eager blocks "
             f"{stats['eager_blocks']}")
    gs.reset()
    return out


def graph_cell(rt, config: str, device, out_dir: Path) -> dict:
    """One engine cell of GRAPH_CELLS eager and as CUDA graph replays
    (graph_vs_eager: GRAPH_CHECK blocks held bit for bit, GRAPH_TIMED timed
    each way, GRAPH_TRACED traced)."""
    import bench_torch

    t0 = time.perf_counter()
    if config == "odd_master":
        eng, source = (rt.Engine(samprate=ODD_FS, real=False, groups=odd_master_groups(rt)),
                       "bench.py nbfm400 layout at 2.4 Msps (the odd_master phase's)")
    else:
        eng, source = bench_torch.build_engine(config)[0], f"bench.py {config}"
    build_s = time.perf_counter() - t0
    return {"source": source, "engine_s": build_s, **graph_vs_eager(eng, device, config)}


def run_graphs(rt, card: str, device, out_dir: Path) -> tuple[dict, dict]:
    """The compiled dispatch on the card: each engine cell of GRAPH_CELLS
    eager and as CUDA graph replays (graph_cell), then
    profile_latency_torch's daemon at time-shards 0, 4 and 16 (the tool's
    own dispatch counts), its dispatch as graph replays. Returns (the
    phase's JSON, per kernel its launches in the cells' graph runs)."""
    import profile_latency_torch

    t_phase = time.perf_counter()
    out = {"phase": "graphs", "card": card, "cells": {},
           "reduced": {"timed_blocks": f"{GRAPH_TIMED} each way (the engine phases: 64)"}}
    total = {"channelize": 0, "noise_est": 0}
    for config in GRAPH_CELLS:
        out["cells"][config] = cell = graph_cell(rt, config, device, out_dir)
        for k in total:
            total[k] += cell["launches"][k]
        torch.cuda.empty_cache()
    out["profile_latency"] = [
        profile_latency_torch.measure(ts, profile_latency_torch.DISPATCHES.get(ts, 20), device,
                                      loopback=True) for ts in (0, 4, 16)]
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out, total


# ------------------------------------------- the measuring kit (the twins)
TOOLS_CONFIGS = ("rx888", "rx888x16", "hf32000", "nbfm400", "wfm", "linear8")
TOOLS_REPS = 2  # R of bench_torch.measure here (bench_torch.py runs 64)
# what the kernels line keeps of each check at the tools' shapes
TOOLS_KEYS = ("max_abs_err", "err_bound", "max_rel_err", "keys_equal", "ms", "plain_ms",
              "bound_ms", "bound_by", "library_ms", "library_call", "shape")
TOOLS_HIGHC_S = 10.0  # stream seconds of tools/bench_highc_torch.py (its default: 60)
TOOLS_MASTER_K, TOOLS_MASTER_REPS = 4, 2  # prof_master_torch's blocks and passes here


def run_tools(card: str, device) -> tuple[dict, dict]:
    """The port's measuring kit on the card, each tool through the function
    its command line runs: bench_torch.measure (R = TOOLS_REPS, K = 8) on
    six of bench.py's configurations (finite checksums, A's and B's launches
    by the port's counters equal to what R x K blocks and the N0 cadence
    need, the peak device memory; the step as CUDA graph replays),
    tools/bench_highc_torch.py in a subprocess (32,768 channels,
    TOOLS_HIGHC_S s paced: it must exit 0: the tap's tone within 20 Hz of
    700, no drop, no overflow after warm-up) and prof_master_torch's
    ablation of the distributed master on make_mesh() and 4 shards of the
    card. Each configuration's groups also hold A and B against their plain
    versions at their own shapes (check_kernels on one noise block). Returns
    (the phase's JSON, per kernel: its launches over the benches and its
    checks by "config/group")."""
    import bench_torch
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    out = {"phase": "tools", "card": card, "reps": TOOLS_REPS, "bench": {}}
    total = dict.fromkeys(MAIN_KERNELS, 0)
    at: dict = {"channelize": {}, "noise_est": {}}
    for config in TOOLS_CONFIGS:
        t0 = time.perf_counter()
        eng, _, baseline = bench_torch.build_engine(config)
        build_s = time.perf_counter() - t0
        cc.reset_launches()
        r = bench_torch.measure(eng, reps=TOOLS_REPS)
        got = {k: cc.launches[k] for k in total}
        want = expected_launches(eng, 0, r["steps"])
        out["bench"][config] = {**r, "vs_baseline": r["msps"] / baseline, "engine_s": build_s,
                                "launches": got, "want_launches": want,
                                "channels": sum(g.C for g in eng.groups.values())}
        if got != want or not np.isfinite(r["checksum"]):
            fail(f"tools bench {config}: launches {got}, want {want}, checksum {r['checksum']}")
        for k in total:
            total[k] += got[k]
        # A and B against their plain versions at this configuration's own
        # shapes: every group that launches them, on one noise block's F
        params = eng.init_params()
        _, F = eng.master_step(eng.init_state()["master"],
                               noise_blocks(eng, 1, N0_SCENE, device, 30)[0])
        for name, g in eng.groups.items():
            if g.spec.demod == "spectrum" and (g.spectrum_wide or not g.host["armed"]):
                continue
            for chk in check_kernels(eng, params, F, name):
                if chk["name"] == "channelize" and not (g.tiled and not g.spec.beam):
                    continue
                at[chk["name"]][f"{config}/{name}"] = {k: chk[k] for k in TOOLS_KEYS if k in chk}
        out["bench"][config]["kernels"] = {kn: {gk: {k: v[k] for k in ("max_abs_err", "ms",
                                                                       "plain_ms", "bound_ms")}
                                                for gk, v in per.items()
                                                if gk.startswith(config + "/")}
                                           for kn, per in at.items()}
        del eng, params, F
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "bench_highc_torch.py"),
                        "--secs", str(TOOLS_HIGHC_S), "--device", "cuda", "--loopback"],
                       cwd=ROOT, capture_output=True, text=True, timeout=TOOLS_HIGHC_S + 240)
    last = r.stdout.strip().splitlines()[-1] if r.stdout.strip() else ""
    if r.returncode != 0 or not last.startswith("{"):
        fail(f"tools: bench_highc_torch.py exited {r.returncode}: {last} {r.stderr[-2000:]}")
    out["bench_highc"] = {**json.loads(last), "seconds": time.perf_counter() - t0}
    if not out["bench_highc"]["chan_kernel"]:
        fail(f"tools: kernel A did not carry bench_highc's group: {out['bench_highc']}")
    pm = tool_module("prof_master_torch")
    out["prof_master"] = {
        label: pm.profile(mesh, k=TOOLS_MASTER_K, reps=TOOLS_MASTER_REPS)
        for label, mesh in (("make_mesh()", make_mesh()), ("4 shards", make_mesh([device] * 4)))}
    for label, rec in out["prof_master"].items():
        if not all(np.isfinite(v) and v > 0 for v in rec["ms"].values()):
            fail(f"tools: prof_master on {label}: {rec['ms']}")
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out, {k: {"launches": total[k], "checks": at.get(k, {})} for k in total}


# ------------------------------------------------------- the control plane
# tests/test_control_plane.py's config, copied (the tests import JAX): a
# 1.024 Msps complex sig_gen; usb, pm, cwu and a lazy spectrum channel;
# dyn-slots 3
CONTROL_CONF = """
[global]
hardware = sig_gen
mode = usb
update = 5
dyn-slots = 3

[sig_gen]
device = sig_gen
carrier = 201k0
amplitude = -20
noise = -130
samprate = 1m024
real = no

[hf]
mode = usb
samprate = 16k
freq = 200k0

[vhf]
mode = pm
freq = 300k0

[cw]
mode = cwu
freq = 150k0

[spect]
mode = spectrum
freq = 0
resolution-bw = 100
bin-count = 32
idle-timeout = 0.2
"""
CONTROL_FS = 1_024_000
# the commands of tests/test_control_plane.py, in its order: (ssrc, fields,
# blocks stepped after); every class of key: runtime keys, the restart
# classes, the spectrum's geometry, encodings, aggregation, doppler,
# dynamic creates (a foreground rebuild, then restocks), parking, a poll
CONTROL_SCRIPT = [
    (200, {"SQUELCH_OPEN": 9.5, "SQUELCH_CLOSE": 8.5, "HEADROOM": -12.0, "AGC_HANGTIME": 0.5,
           "AGC_RECOVERY_RATE": 30.0, "AGC_THRESHOLD": -12.0, "SNR_SQUELCH": True,
           "SHIFT_FREQUENCY": 100.0, "STATUS_INTERVAL": 7}, 2),
    (200, {"GAIN": 20.0}, 2),
    (200, {"AGC_ENABLE": True, "KAISER_BETA": 5.0}, 2),
    (300, {"PL_TONE": 100.0, "THRESH_EXTEND": True}, 1),
    (150, {"FILTER2_KAISER_BETA": 3.0}, 1),
    (200, {"PRESET": "pm"}, 2),
    (200, {"PRESET": "usb"}, 2),
    (300, {"DEMOD_TYPE": 0}, 1),
    (300, {"DEMOD_TYPE": 1}, 1),
    (200, {"OUTPUT_SAMPRATE": 24_000}, 2),
    (200, {"INDEPENDENT_SIDEBAND": True}, 2),
    (200, {"PLL_ENABLE": True, "PLL_BW": 25.0, "PLL_SQUARE": True}, 2),
    (200, {"OUTPUT_CHANNELS": 2}, 1),
    (200, {"OUTPUT_CHANNELS": 1}, 1),
    (200, {"FILTER2": 2}, 1),
    (0, {"SPECTRUM_BASE": -100.0, "SPECTRUM_STEP": 1.0}, 1),
    (0, {"RESOLUTION_BW": 50.0, "BIN_COUNT": 64, "SPECTRUM_AVG": 4, "WINDOW_TYPE": 5,
         "SPECTRUM_OVERLAP": 0.5}, 6),
    (200, {"OUTPUT_ENCODING": 4}, 2),  # F32LE
    (200, {"MAXDELAY": 3}, 6),
    (200, {"DOPPLER_FREQUENCY": 50.0, "DOPPLER_FREQUENCY_RATE": 10.0, "LIFETIME": 100,
           "SETOPTS": 10}, 3),
    (200, {"DOPPLER_FREQUENCY": 0.0, "DOPPLER_FREQUENCY_RATE": 0.0, "CLEAROPTS": 2}, 1),
    (7001, {"PRESET": "am", "RADIO_FREQUENCY": 100_000.0}, 1),
    (7002, {"PRESET": "am", "RADIO_FREQUENCY": 101_000.0}, 1),
    (7003, {"PRESET": "am", "RADIO_FREQUENCY": 102_000.0}, 1),
    (7004, {"PRESET": "am", "RADIO_FREQUENCY": 103_000.0}, 1),
    (7100, {"PRESET": "cwu", "RADIO_FREQUENCY": 150_500.0}, 1),
    (200, {"RADIO_FREQUENCY": 900_000_000.0}, 1),  # out of coverage: parked
    (200, {"GAIN": 14.0}, 1),
    (200, {"RADIO_FREQUENCY": 200_000.0}, 2),
    (0, {}, 3),  # a bare poll arms the spectrum
]
CONTROL_PITCH = 1362.5  # Hz: 27.25 cycles a block, so a repeated block is a phase step
CONTROL_DOPPLER_HZ_S = -1000.0  # the ramp: the tone walks up 160 Hz a dispatch of 8 blocks
CONTROL_RAMP = 5  # dispatches of the ramp
CONTROL_MAXDELAY_DISPATCHES = 2  # held after the first (the retune's turn-on)


def control_scene(b: int, L: int, rng) -> np.ndarray:
    """tests/test_torch_control_plane.py's scene: a carrier 1 kHz above the
    usb dial, an FM carrier on the pm channel, a tone in the cwu passband,
    -60 dBFS noise."""
    t = np.arange(b * L, (b + 1) * L) / CONTROL_FS
    x = 0.1 * np.exp(2j * np.pi * 201_000 * t)
    x += 0.05 * np.exp(1j * (2 * np.pi * 300_000 * t + 2.5 * np.sin(2 * np.pi * 1000 * t)))
    x += 0.02 * np.exp(2j * np.pi * 150_050 * t)
    x += 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def same_status(a: bytes, b: bytes) -> list:
    """Fields of two status packets that differ beyond the CPU twins'
    bounds (tests/torch_parity.py): integers exact, floats rtol 2e-5 (dB
    powers as linear ones), BIN_DATA within 2e-4 of its largest bin; the
    wall-clock GPS time and the block-time test point left out."""
    from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status

    db = {T.IF_POWER, T.BASEBAND_POWER, T.NOISE_DENSITY, T.OUTPUT_LEVEL, T.GAIN, T.PLL_SNR}
    (ka, fa, _), (kb, fb, _) = decode_status(a), decode_status(b)
    if ka != kb or set(fa) != set(fb):
        return [["fields", sorted(k.name for k in set(fa) ^ set(fb))]]
    bad = []
    for k, x in fa.items():
        y = fb[k]
        if k in (T.GPS_TIME, T.TP1):
            continue
        if isinstance(x, float):
            x, y = (10.0 ** (x / 10), 10.0 ** (y / 10)) if k in db else (x, y)
            ok = abs(x - y) <= 2e-5 * abs(x) + 1e-12
        elif isinstance(x, list):
            w = np.asarray(x, np.float64)
            ok = np.abs(np.asarray(y) - w).max(initial=0) <= 2e-4 * np.abs(w).max(initial=0)
        else:
            ok = x == y
        if not ok:
            bad.append([k.name, str(x)[:40], str(y)[:40]])
    return bad


def same_wire(sa: list, sb: list, registry) -> dict:
    """Two daemons' packets in order: RTP headers equal and payloads by
    encoding (s16 within 1 LSB, F32 within one s16 LSB of full scale, the
    rest exact), status by same_status. Returns counts and the first
    differences."""
    from ka9q_radio_tpu_torch.net.rtp import Encoding, RtpHeader

    out = {"packets": len(sa), "data": 0, "status": 0, "bytes_equal": 0, "s16_max_lsb": 0,
           "f32_max_abs": 0.0, "differ": []}
    if [k for k, _ in sa] != [k for k, _ in sb]:
        out["differ"].append(["kinds", len(sa), len(sb)])
        return out
    for i, ((kind, a), (_, b)) in enumerate(zip(sa, sb)):
        out[kind] += 1
        out["bytes_equal"] += a == b
        if kind == "status":
            d = same_status(a, b)
            if d:
                out["differ"].append([i, "status", d[:4]])
            continue
        (ha, pa), (hb, pb) = RtpHeader.unpack(a), RtpHeader.unpack(b)
        if (ha.ssrc, ha.seq, ha.timestamp, ha.type, ha.marker) != \
                (hb.ssrc, hb.seq, hb.timestamp, hb.type, hb.marker) or len(pa) != len(pb):
            out["differ"].append([i, "header", ha.ssrc])
            continue
        enc = registry.table[ha.type][2]
        if enc in (Encoding.S16BE, Encoding.S16LE):
            dt = ">i2" if enc == Encoding.S16BE else "<i2"
            d = int(np.abs(np.frombuffer(pa, dt).astype(np.int32)
                           - np.frombuffer(pb, dt).astype(np.int32)).max(initial=0))
            out["s16_max_lsb"] = max(out["s16_max_lsb"], d)
            ok = d <= 1
        elif enc == Encoding.F32LE:
            d = float(np.abs(np.frombuffer(pa, "<f4") - np.frombuffer(pb, "<f4")).max(initial=0))
            out["f32_max_abs"] = max(out["f32_max_abs"], d)
            ok = d <= 2.0 ** -15
        else:
            ok = pa == pb
        if not ok:
            out["differ"].append([i, "payload", ha.ssrc, enc.name])
    return out


def eager_radiod(cls):
    """The daemon whose _mk_step gives the eager Engine.step (GraphStep.eager):
    every dispatch eager, nothing captured before it."""

    class EagerRadiod(cls):
        def _mk_step(self, eng, stepper=None):
            return super()._mk_step(eng, stepper).eager

        def _prepare_step(self):
            pass

    return EagerRadiod


def control_graph_vs_eager(device) -> dict:
    """CONTROL_CONF run by two daemons on the card, one dispatching as the
    daemon does (GraphStep: graph replays) and one eagerly, fed the same
    blocks and CONTROL_SCRIPT's commands (a background restock landed in
    both before each block): their packets held to each other (same_wire),
    kernel A's and B's launches counted per daemon and equal, graph_stats()
    of the graph daemon (no eager block but the spectrum's warm-up frames)."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    t0 = time.perf_counter()
    rg = Radiod(load_config(CONTROL_CONF), use_network=False)
    re_ = eager_radiod(Radiod)(load_config(CONTROL_CONF), use_network=False)
    init_s = time.perf_counter() - t0
    daemons = {"graph": rg, "eager": re_}
    for rd in daemons.values():
        rd._pool_need = lambda gname: 0  # restocks sized by dyn-slots alone
    launches = {m: dict.fromkeys(cc.launches, 0) for m in daemons}
    rng = np.random.default_rng(91)
    blocks = [0]

    def step(n: int):
        for _ in range(n):
            x = control_scene(blocks[0], rg.engine.L, rng)
            blocks[0] += 1
            for m, rd in daemons.items():
                rd._finish_restock(wait=True)
                before = dict(cc.launches)
                rd.step_block(block=x)
                torch.cuda.synchronize()
                for k in before:
                    launches[m][k] += cc.launches[k] - before[k]

    step(1)
    for ssrc, fields, n in CONTROL_SCRIPT:
        pkt = encode_status({T.OUTPUT_SSRC: ssrc, **{T[k]: v for k, v in fields.items()}},
                            cmd=True)
        for rd in daemons.values():
            rd.handle_packet(pkt)
        step(n)
    for rd in daemons.values():
        rd._finish_restock(wait=True)
    wire = same_wire(re_._sent, rg._sent, rg.registry)
    tables = {m: {s: (c.group, c.idx, c.freq, c.samprate, c.encoding, c.maxdelay, c.parked)
                  for s, c in rd.chans.items()} for m, rd in daemons.items()}
    stats = rg.graph_stats()
    eager_why = {**stats["before"]["eager_blocks"]}
    for why, n in stats["current"]["eager_blocks"].items():
        eager_why[why] = eager_why.get(why, 0) + n
    out = {"config": "tests/test_control_plane.py CONF", "init_s": init_s,
           "blocks": blocks[0], "commands": len(CONTROL_SCRIPT), "wire": wire,
           "tables_equal": tables["graph"] == tables["eager"],
           "launches": launches["graph"], "eager_launches": launches["eager"],
           "groups": {n: g.C for n, g in rg.engine.groups.items()},
           "graphs": daemon_graphs(rg),
           "eager_daemon_replays": sum(st["replays"] for st in re_.graph_stats().values())}
    if wire["differ"] or not out["tables_equal"] or wire["data"] == 0:
        fail(f"control: the graph daemon differs from the eager one: {wire['differ'][:6]}, "
             f"tables equal {out['tables_equal']}")
    if launches["graph"] != launches["eager"] or not launches["graph"]["channelize"] \
            or not launches["graph"]["noise_est"] or out["eager_daemon_replays"]:
        fail(f"control: launches graph {launches['graph']}, eager {launches['eager']}")
    if any("spectrum warm-up" not in why for why in eager_why) \
            or stats["current"]["dispatch"] != "cuda graph" \
            or stats["current"]["replays"] + stats["before"]["replays"] < blocks[0] // 2:
        fail(f"control: graph daemon dispatch {stats['current']['dispatch']}, eager blocks "
             f"{eager_why}, replays {stats['current']['replays']} + {stats['before']['replays']}")
    # both kernels against their plain versions at the usb group's shapes
    eng = rg.engine
    _, F = master_fft(eng.master, eng.init_state()["master"],
                      torch.as_tensor(control_scene(0, eng.L, rng), device=device))
    out["kernels"] = {k["name"]: k for k in check_kernels(eng, rg.params, F, "hf")}
    return out


def control_flagship(device, conf_text: str, dial: float, k: int) -> tuple[dict, object]:
    """The flagship daemon (the `daemon` phase's config, every dispatch a
    graph replay) driven through the control plane on the carrier's channel
    k: a doppler ramp (the tone's pitch walks CONTROL_DOPPLER_HZ_S, ±10 Hz a
    dispatch, and comes back to 1,500 Hz when the ramp is cancelled);
    KAISER_BETA and GAIN (the same engine, the level the gain sets);
    MAXDELAY = 3 with the channel retuned to a pitch of CONTROL_PITCH (the
    group leaves the native edge; each flush carries 3 x 240 samples, the
    tone's phase continuous over every join); a preset switch to lsb (a
    rebuild, a new graph, the tone at 1,500 Hz)."""
    import select
    import socket

    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    dport = int(conf_text.split("data = 127.0.0.1:", 1)[1].split()[0])
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 20)
    rx.bind(("127.0.0.1", dport))
    rx.setblocking(False)
    t0 = time.perf_counter()
    rd = Radiod(load_config(conf_text), use_network=True)
    init_s = time.perf_counter() - t0
    ch = next(c for c in rd.chans.values() if c.group == "hf" and c.idx == k)
    ssrc, D, L = ch.ssrc, max(rd._time_shards, 1), rd.engine.L
    rate = rd.engine.groups["hf"].spec.samprate
    pkts: list = []
    expect = {"channelize": 0, "noise_est_due": 0}
    tag = [0]

    def drain() -> list:
        got = []
        while select.select([rx], [], [], 0)[0]:
            h, payload = RtpHeader.unpack(rx.recv(65536))
            if h.ssrc == ssrc:
                got.append((h.seq, h.timestamp, payload))
        return got

    def dispatch(n: int = 1) -> list:
        got = []
        for _ in range(n):
            j0 = rd.state["host"]["jobnum"]
            tiled = sum(1 for g in rd.engine.groups.values() if g.tiled and g.tile_E is not None)
            rd.step_block()
            expect["channelize"] += D * tiled
            expect["noise_est_due"] += sum(1 for b in range(j0, j0 + D)
                                           if b % rd.engine.noise_every == 0)
            got += drain()
        pkts.extend(got)
        return got

    def audio(got) -> np.ndarray:
        return np.concatenate([np.frombuffer(p, ">i2") for _, _, p in sorted(got)]
                              or [np.zeros(0, ">i2")]).astype(np.float64)

    def command(**kv):
        tag[0] += 1
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: ssrc, T.COMMAND_TAG: tag[0],
                                        **{T[key]: v for key, v in kv.items()}}, cmd=True))

    def info(key):
        return float(rd._ginfo[ch.group][key][ch.idx]) if ch.group in rd._ginfo \
            else float(ch.last_info[key][ch.idx])

    dispatch(4)  # warm-up: cuFFT plans, the AGC
    cc.reset_launches()
    expect.update(channelize=0, noise_est_due=0)
    out = {"config": str(WSPR_CONF.relative_to(ROOT)), "init_s": init_s, "channels":
           rd.engine.groups["hf"].C, "time_shards": D, "carrier_ssrc": ssrc,
           "tone_hz": peak_hz(audio(dispatch(2)), rate)}
    if abs(out["tone_hz"] - 1500.0) > 10.0:
        fail(f"control: the carrier's channel peaks at {out['tone_hz']} Hz, want 1500")
    eng0 = rd.engine

    # the doppler ramp: the tuning walks CONTROL_DOPPLER_HZ_S, a step a dispatch
    command(DOPPLER_FREQUENCY=0.0, DOPPLER_FREQUENCY_RATE=CONTROL_DOPPLER_HZ_S)
    ramp = []
    for d in range(1, CONTROL_RAMP + 1):
        want = 1500.0 - CONTROL_DOPPLER_HZ_S * rd.cfg.blocktime * D * d
        ramp.append([want, peak_hz(audio(dispatch()), rate)])
    command(DOPPLER_FREQUENCY=0.0, DOPPLER_FREQUENCY_RATE=0.0)
    dispatch()  # the retune's turn-on
    back = peak_hz(audio(dispatch()), rate)
    out["doppler"] = {"rate_hz_s": CONTROL_DOPPLER_HZ_S, "hz_per_dispatch":
                      -CONTROL_DOPPLER_HZ_S * rd.cfg.blocktime * D,
                      "want_got_hz": ramp, "after_cancel_hz": back}
    if any(abs(w - g) > 10.0 for w, g in ramp) or abs(back - 1500.0) > 10.0 or rd.doppler:
        fail(f"control: doppler ramp {ramp}, after the cancel {back} Hz")

    # KAISER_BETA and GAIN act on the same engine, its graphs as they were
    g = rd.engine.groups["hf"]
    resp0 = g.host["responses"][k].copy()
    n_graphs = len(rd._stepper.graphs)
    command(KAISER_BETA=3.0)
    dispatch()
    beta_hz = peak_hz(audio(dispatch()), rate)
    command(GAIN=20.0)
    dispatch()
    a = audio(dispatch()) / 32768.0
    bb = info("baseband_power")
    gain_db = 10 * np.log10(np.mean(a * a) / max(bb, 1e-30))
    out["kaiser_gain"] = {
        "responses_changed": not np.array_equal(resp0, g.host["responses"][k]),
        "tone_hz_after_beta": beta_hz, "agc_enable": bool(g.host["demod"]["agc_enable"][k]),
        "manual_gain": float(g.host["demod"]["manual_gain"][k]),
        "output_over_baseband_db": gain_db, "same_engine": rd.engine is eng0,
        "graphs_before": n_graphs, "graphs_after": len(rd._stepper.graphs)}
    kg = out["kaiser_gain"]
    # GAIN = 20 dB on the real part of a complex tone: output = baseband
    # power x 100 / 2, 16.99 dB
    if not (kg["responses_changed"] and kg["same_engine"] and abs(beta_hz - 1500.0) <= 10.0
            and not kg["agc_enable"] and abs(kg["manual_gain"] - 10.0) < 1e-4
            and abs(gain_db - (20.0 - 10 * np.log10(2.0))) <= 1.0
            and kg["graphs_after"] == n_graphs):
        fail(f"control: KAISER_BETA / GAIN: {kg}")

    # MAXDELAY = 3 (the gain left manual: a steady level to fit the tone to) at a pitch whose block is not whole cycles: the group
    # leaves the native edge, each flush carries 3 blocks, no block
    # repeated or replaced
    command(MAXDELAY=3, RADIO_FREQUENCY=dial + 1500.0 - CONTROL_PITCH)
    if "hf" in rd.edges:
        fail("control: MAXDELAY = 3 left the group on the native edge")
    dispatch()  # the retune's turn-on
    t_md = time.perf_counter()
    got = sorted(dispatch(CONTROL_MAXDELAY_DISPATCHES))
    md_s = time.perf_counter() - t_md
    x = audio(got)
    seqs = [s for s, _, _ in got]
    sizes = [len(p) // 2 for _, _, p in got]
    ts = [t for _, t, _ in got]
    contiguous = (seqs == list(range(seqs[0], seqs[0] + len(seqs)))
                  and all(t1 - t0 == n for t0, t1, n in zip(ts, ts[1:], sizes)))
    flush = 3 * rd.engine.groups["hf"].olen
    n = np.arange(x.size)
    w = 2 * np.pi * CONTROL_PITCH / rate
    basis = np.stack([np.cos(w * n), np.sin(w * n), np.ones_like(x)], 1)
    coef = np.linalg.lstsq(basis, x, rcond=None)[0]
    amp = float(np.hypot(coef[0], coef[1]))
    resid = x - basis @ coef
    # each block's residual RMS over the tone's: the noise gives about 0.02,
    # a block repeated or replaced (a quarter cycle off) about 1.4
    per_block = (np.sqrt(np.mean(resid[: x.size // 240 * 240].reshape(-1, 240) ** 2, 1))
                 / max(amp / np.sqrt(2.0), 1e-9))
    out["maxdelay"] = {"packets": len(got), "samples": int(x.size), "flush_samples": flush,
                       "packet_samples": sorted(set(sizes)), "contiguous": contiguous,
                       "tone_hz": peak_hz(x, rate), "amplitude_lsb": amp,
                       "worst_block_residual_rms": float(per_block.max()),
                       "native_edge": "hf" in rd.edges,
                       "ms_per_dispatch_python_path": md_s * 1e3 / CONTROL_MAXDELAY_DISPATCHES}
    # whole flushes: the dispatches' blocks, give or take the 2 a flush
    # can hold over a dispatch's end
    if not (contiguous and x.size % flush == 0
            and abs(x.size - CONTROL_MAXDELAY_DISPATCHES * D * 240) <= 2 * 240
            and sum(sizes[:2]) == flush and amp > 100 and per_block.max() < 0.25):
        fail(f"control: MAXDELAY = 3: {out['maxdelay']}")

    # a preset switch: the channel moves to an lsb class (a rebuild and its
    # graphs), tuned 1,500 Hz above the carrier
    engines0 = rd.graph_stats()["before"]["engines"]
    command(PRESET="lsb", RADIO_FREQUENCY=dial + 3000.0, MAXDELAY=0)
    ch = rd.chans[ssrc]
    dispatch()
    lsb_hz = peak_hz(audio(dispatch()), rate)
    after = rd.graph_stats()
    out["preset"] = {"group": ch.group, "demod": rd.engine.groups[ch.group].spec.demod,
                     "tone_hz": lsb_hz, "engines_before": after["before"]["engines"],
                     "captures": after["current"]["captures"],
                     "capture_ms": after["current"]["capture_ms"],
                     "replays": after["current"]["replays"]}
    if (ch.group == "hf" or ch.preset != "lsb" or abs(lsb_hz - 1500.0) > 10.0
            or after["before"]["engines"] != engines0 + 1
            or after["current"]["captures"] == 0 or after["current"]["replays"] < 2):
        fail(f"control: the preset switch: {out['preset']}")
    launches = dict(cc.launches)
    out.update(launches=launches, expected=expect, graphs=daemon_graphs(rd),
               block_drops=rd.block_drops)
    if launches["channelize"] != expect["channelize"] \
            or launches["noise_est"] < expect["noise_est_due"]:
        fail(f"control: launches {launches}, want channelize {expect['channelize']}, "
             f"noise_est at least {expect['noise_est_due']}")
    for edge, _ in rd.edges.values():
        edge.close()
    rx.close()
    return out, rd


def run_control(card: str, device) -> tuple[dict, dict]:
    """The control plane on the card: (a) the flagship through doppler,
    KAISER_BETA, GAIN, MAXDELAY and a preset switch as graph replays; (b)
    tests/test_control_plane.py's config and script, graph daemon against
    eager daemon. Returns (the phase's JSON, per kernel its launches and
    checks)."""
    t_phase = time.perf_counter()
    text, reduced, dial = daemon_config(_free_port(), _free_port())
    flag, rd = control_flagship(device, text, dial, DAEMON_K)
    # A and B at the flagship's shapes, on the engine the phase left
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft

    blk = float(np.sqrt(1.585e-14 * rd.engine.samprate / 2.0)) * torch.randn(
        rd.engine.L, generator=torch.Generator(device=device).manual_seed(8), device=device)
    _, F = master_fft(rd.engine.master, rd.engine.init_state()["master"], blk)
    at_flag = {k["name"]: k for k in check_kernels(rd.engine, rd.params, F)}
    del rd, F
    torch.cuda.empty_cache()
    small = control_graph_vs_eager(device)
    keys = ("max_abs_err", "err_bound", "max_rel_err", "keys_equal", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call", "shape")
    per_kernel = {}
    for name in ("channelize", "noise_est"):
        per_kernel[name] = {
            "launches": flag["launches"][name] + small["launches"][name],
            "flagship": {"launches": flag["launches"][name],
                         **{k: at_flag[name][k] for k in keys if k in at_flag[name]}},
            "control_conf": {"launches": small["launches"][name],
                             **{k: small["kernels"][name][k] for k in keys
                                if k in small["kernels"][name]}}}
    small["kernels"] = {n: v["control_conf"] for n, v in per_kernel.items()}
    out = {"phase": "control", "card": card, "flagship": {"reduced": reduced, **flag},
           "graph_vs_eager": small, "kernels": per_kernel,
           "seconds": time.perf_counter() - t_phase}
    return out, per_kernel


# ---------------------------------------------- the radio's calibration
CAL_N0 = 1e-13  # the calibration scene's noise density, power/Hz (-130 dBFS/Hz)
CAL_C = 32  # channels of each calibration group
CAL_BLOCKS = 25  # blocks of the scene, tests/test_engine.py:125's (the first CAL_SKIP: turn-on)
CAL_SKIP = 4
CAL_SNR_AMP = 0.01  # the SNR carrier's amplitude (tests/test_engine.py:160's)
CAL_STOP_AMP = 0.3  # the stopband pair's amplitude: in band and 3 kHz past the edge
CAL_IQ_BW, CAL_STOP_EDGE, CAL_STOP_OFFSET = 12_000.0, 5_000.0, 8_000.0
CAP_FS, CAP_C, CAP_BLOCKS = 2_048_000, 2000, 6  # tests/test_engine.py:143's capacity group
SPECTRUM_FMT_CONF = """
[global]
hardware = sig_gen
update = 2
spectrum-format = {fmt}
[sig_gen]
device = sig_gen
carrier = 250k0
amplitude = -6
noise = -120
samprate = 1m024
real = no
[sweep]
mode = spectrum
samprate = 32k
resolution-bw = 2k
bin-count = 64
freq = 240k0
"""  # tests/test_spectrum.py:79's config, the format filled in


def calibration_groups(rt):
    """bench.py's rx888 groups, and beside them the calibration groups
    built to the JAX tests' filters: `iq` (tests/test_engine.py:125, :160:
    16 kHz, AGC off, +/-6 kHz) and `stop` (tests/test_filterbank.py:112:
    +/-5 kHz at 12 kHz, Kaiser beta 11), CAL_C channels each across the
    band, every dial on a master bin centre (fs/N = 40 Hz)."""
    from ka9q_radio_tpu_torch.ops.filterbank import MasterConfig

    hz = FS / MasterConfig.from_rate(FS).N

    def dials(lo, hi):
        return [float(np.round(f / hz) * hz) for f in np.linspace(lo * FS, hi * FS, CAL_C)]

    ch = rt.ChannelSpec
    return rx888_groups(rt) + [
        rt.GroupSpec(name="iq", demod="iq", samprate=16_000, agc=False,
                     channels=tuple(ch(freq=f, low=-CAL_IQ_BW / 2, high=CAL_IQ_BW / 2, gain_db=0.0)
                                    for f in dials(0.03, 0.46))),
        rt.GroupSpec(name="stop", demod="iq", samprate=12_000, agc=False, kaiser_beta=11.0,
                     channels=tuple(ch(freq=f, low=-CAL_STOP_EDGE, high=CAL_STOP_EDGE, gain_db=0.0)
                                    for f in dials(0.035, 0.465))),
    ]


def calibration_scene(eng, device, seed: int = 31):
    """The scene: real noise of density CAL_N0, the SNR carrier at iq
    channel 5's dial, a CAL_STOP_AMP carrier at stop channel 9's dial (in
    band) and one CAL_STOP_OFFSET above stop channel 21's dial (3 kHz past
    its +/-5 kHz edge), each on a master bin centre. Returns (block maker
    b -> [L] float32 on the card, the carriers' channels)."""
    m, L = eng.master, eng.L
    hz = eng.samprate / m.N
    iq = [c.freq for c in eng.groups["iq"].spec.channels]
    stop = [c.freq for c in eng.groups["stop"].spec.channels]
    where = {"snr": ("iq", 5), "inband": ("stop", 9), "outband": ("stop", 21)}
    bins = {"snr": round(iq[5] / hz), "inband": round(stop[9] / hz),
            "outband": round((stop[21] + CAL_STOP_OFFSET) / hz)}
    amps = {"snr": CAL_SNR_AMP, "inband": CAL_STOP_AMP, "outband": CAL_STOP_AMP}
    gen = torch.Generator(device=device).manual_seed(seed)
    std = float(np.sqrt(CAL_N0 * eng.samprate / 2.0))  # real stream: fs/2 of bandwidth

    def block(b: int) -> torch.Tensor:
        n = torch.arange(L, dtype=torch.int64, device=device) + b * L
        sig = sum(amps[k] * torch.cos((2 * np.pi / m.N)
                                      * torch.remainder(n * bins[k], m.N).to(torch.float64))
                  for k in bins)
        return sig.to(torch.float32) + std * torch.randn(L, generator=gen, device=device)

    return block, where


def calibration_engine(rt, device) -> dict:
    """The rx888 master with the calibration groups through GraphStep (as
    CUDA graph replays): N0 on every calibration channel against CAL_N0,
    the iq channels' white-noise gain against 2 B/fs x the input variance,
    the stopband, the SNR and the carrier's baseband power; kernels A and B
    at both groups' shapes against their plain versions, their launches by
    the counters."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

    t0 = time.perf_counter()
    eng = rt.Engine(samprate=FS, real=True, groups=calibration_groups(rt))
    params = eng.init_params()
    block, where = calibration_scene(eng, device)
    _, F = master_fft(eng.master, eng.init_state()["master"], block(0))
    checks = {g: {k["name"]: k for k in check_kernels(eng, params, F, g)} for g in ("iq", "stop")}
    del F
    build_s = time.perf_counter() - t0
    gs = GraphStep(eng)
    state = eng.init_state()
    cc.reset_launches()
    bb = {g: [] for g in ("iq", "stop")}
    for b in range(CAL_BLOCKS):
        state, out = gs(state, params, block(b))
        if b >= CAL_SKIP:  # the graph's outputs are overwritten by the next replay: copies
            for g in bb:
                bb[g].append(out[g]["info"]["baseband_power"].double().cpu())
    torch.cuda.synchronize()
    launches = {k: cc.launches[k] for k in MAIN_KERNELS}
    expect = expected_launches(eng, 0, CAL_BLOCKS)
    n0 = {g: out[g]["info"]["n0"].double().cpu().numpy() for g in bb}
    finite = outputs_finite(out)
    stats = gs.graph_stats()
    pw = {g: torch.stack(v).mean(0).numpy() for g, v in bb.items()}
    # N0 on every channel of both groups
    dev = {g: 10 * np.log10(n0[g] / CAL_N0) for g in n0}
    worst_g = max(dev, key=lambda g: np.abs(dev[g]).max())
    worst_i = int(np.argmax(np.abs(dev[worst_g])))
    # white-noise gain: the iq channels without a carrier against N0 B
    # (2 B/fs x the input variance N0 fs/2)
    quiet = [i for i in range(CAL_C) if i != where["snr"][1]]
    gain_want = 2.0 * CAL_IQ_BW / eng.samprate * (CAL_N0 * eng.samprate / 2.0)
    gain_got = float(pw["iq"][quiet].mean())
    # the stopband: stop channel 21's output over stop channel 9's
    stop_db = float(10 * np.log10(pw["stop"][where["outband"][1]] / pw["stop"][where["inband"][1]]))
    # SNR of the carrier's channel: baseband power over N0 B, against
    # analytic (a real cosine of amplitude a: a^2/2 at baseband)
    g, i = where["snr"]
    p_sig = CAL_SNR_AMP**2 / 2.0
    bb_db = float(10 * np.log10(pw[g][i]))
    snr_db = bb_db - float(10 * np.log10(n0[g][i] * CAL_IQ_BW))
    snr_want = float(10 * np.log10(p_sig / (CAL_N0 * CAL_IQ_BW)))
    # the carrier alone: the channel's power less its noise N0 B
    carrier_db = float(10 * np.log10(pw[g][i] - CAL_N0 * CAL_IQ_BW))
    return {
        "engine_s": build_s, "blocks": CAL_BLOCKS, "skip": CAL_SKIP, "n0_scene": CAL_N0,
        "groups": {n: {"C": gg.C, "n_bins": gg.n_bins, "olen": gg.olen, "samprate":
                       gg.spec.samprate, "kaiser_beta": gg.spec.kaiser_beta}
                   for n, gg in eng.groups.items() if n in ("iq", "stop", "hf")},
        "n0_worst": {"group": worst_g, "channel": worst_i,
                     "freq": eng.groups[worst_g].spec.channels[worst_i].freq,
                     "dev_db": float(dev[worst_g][worst_i])},
        "n0_max_abs_dev_db": {g: float(np.abs(v).max()) for g, v in dev.items()},
        "n0_median_dev_db": {g: float(np.median(v)) for g, v in dev.items()},
        "noise_gain": {"got": gain_got, "want": gain_want, "rel_err": gain_got / gain_want - 1.0,
                       "channels": len(quiet)},
        "stopband_db": stop_db,
        "snr": {"got_db": snr_db, "want_db": snr_want, "err_db": snr_db - snr_want,
                "baseband_db": bb_db, "baseband_want_db": float(10 * np.log10(p_sig + CAL_N0
                                                                                * CAL_IQ_BW)),
                "carrier_db": carrier_db, "carrier_want_db": float(10 * np.log10(p_sig))},
        "launches": launches, "expected": expect, "finite": finite,
        "graphs": graph_summary(stats), "kernels": checks}


def capacity_engine(rt, device) -> dict:
    """tests/test_engine.py:143's 2,000 FM channels on a 2.048 Msps complex
    master (the reference's cap, radio.h:343-344) as CUDA graph replays:
    FM carriers in every 100th channel over noise; [2000, 160] finite
    audio every block, the kernels by the counters and at its shapes."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.graphs import GraphStep

    freqs = np.linspace(-0.45 * CAP_FS, 0.45 * CAP_FS, CAP_C)
    eng = rt.Engine(samprate=CAP_FS, real=False, groups=[rt.GroupSpec(
        name="scan", demod="fm", samprate=8000,
        channels=tuple(rt.ChannelSpec(freq=float(f), low=-3000.0, high=3000.0) for f in freqs))])
    params = eng.init_params()
    L = eng.L
    gen = torch.Generator(device=device).manual_seed(33)
    fc = torch.as_tensor(freqs[::100], dtype=torch.float64, device=device)[:, None]

    def block(b: int) -> torch.Tensor:
        t = (torch.arange(L, dtype=torch.float64, device=device) + b * L) / CAP_FS
        ph = 2 * np.pi * fc * t + 1.5 * torch.sin(2 * np.pi * 1000.0 * t)
        x = 0.02 * torch.polar(torch.ones_like(ph), ph).sum(0)
        n = 1e-3 * torch.randn((L, 2), generator=gen, device=device, dtype=torch.float64)
        return (x + torch.complex(n[:, 0], n[:, 1])).to(torch.complex64)

    _, F = eng.master_step(eng.init_state()["master"], block(0))
    checks = {k["name"]: k for k in check_kernels(eng, params, F, "scan")}
    del F
    gs = GraphStep(eng)
    state = eng.init_state()
    cc.reset_launches()
    shapes, finite = set(), True
    for b in range(CAP_BLOCKS):
        state, out = gs(state, params, block(b))
        shapes.add(tuple(out["scan"]["audio"].shape))
        finite = finite and outputs_finite(out)
    torch.cuda.synchronize()
    stats = gs.graph_stats()
    return {"C": eng.groups["scan"].C, "fs": CAP_FS, "blocks": CAP_BLOCKS,
            "audio_shapes": sorted(shapes), "finite": finite,
            "launches": {k: cc.launches[k] for k in MAIN_KERNELS},
            "expected": expected_launches(eng, 0, CAP_BLOCKS), "graphs": graph_summary(stats),
            "kernels": checks}


def spectrum_formats(device) -> dict:
    """tests/test_spectrum.py's config on the card twice, spectrum-format =
    byte and = rice, the same blocks into each (a -6 dBFS carrier at 250
    kHz over -120 dBFS/Hz, made on the card from one seed) and the sweep
    polled: the last beacon's decoded levels, SPECTRUM_BASE and
    SPECTRUM_STEP equal between the two."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rice import dequantize_bins, rice_decode
    from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status, encode_status
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    fs, n0 = 1_024_000, 10 ** (-120 / 10)
    daemons = {f: Radiod(load_config(SPECTRUM_FMT_CONF.format(fmt=f)), use_network=False,
                         device=device) for f in ("byte", "rice")}
    L = daemons["byte"].engine.L
    gen = torch.Generator(device=device).manual_seed(34)
    std = float(np.sqrt(n0 * fs / 2.0))
    for rd in daemons.values():
        rd.handle_packet(encode_status({T.OUTPUT_SSRC: 240}, cmd=True))
    for b in range(8):
        t = (torch.arange(L, dtype=torch.float64, device=device) + b * L) / fs
        ph = 2 * np.pi * 250e3 * t
        x = 10 ** (-6 / 20) * torch.polar(torch.ones_like(ph), ph)
        nz = std * torch.randn((L, 2), generator=gen, device=device, dtype=torch.float64)
        x = (x + torch.complex(nz[:, 0], nz[:, 1])).to(torch.complex64)
        for rd in daemons.values():
            rd.step_block(block=x)
    out = {}
    for f, rd in daemons.items():
        _, fields, _ = decode_status([p for k, p in rd._sent if k == "status"][-1])
        if f == "byte":
            lv = np.frombuffer(fields.get(T.BIN_BYTE_DATA, b""), np.uint8).astype(np.int64)
        else:
            raw = bytes(fields.get(T.BIN_RICE_DATA, b""))
            lv = rice_decode(raw, 64) if raw else np.zeros(0, np.int64)
        base, step = fields.get(T.SPECTRUM_BASE), fields.get(T.SPECTRUM_STEP)
        db = dequantize_bins(lv, base, step) if lv.size else np.zeros(0)
        out[f] = {"levels": lv, "base": base, "step": step,
                  "bytes": len(fields.get(T.BIN_BYTE_DATA if f == "byte" else T.BIN_RICE_DATA,
                                          b"")),
                  "peak_db": float(db.max()) if db.size else None,
                  "dispatch": rd.graph_stats()["current"]["dispatch"]}
    equal = (out["byte"]["levels"].shape == out["rice"]["levels"].shape == (64,)
             and bool(np.array_equal(out["byte"]["levels"], out["rice"]["levels"])))
    return {"levels_equal": equal,
            "base_step_equal": (out["byte"]["base"], out["byte"]["step"])
            == (out["rice"]["base"], out["rice"]["step"]),
            **{f: {k: v for k, v in o.items() if k != "levels"} for f, o in out.items()}}


def run_calibration(rt, card: str, device) -> tuple[dict, dict]:
    """The radio's calibration on the card (calibration_engine,
    capacity_engine, spectrum_formats); every check fails the run through
    fail(). Returns (the phase's JSON, per kernel its launches and checks
    at the phase's shapes)."""
    t_phase = time.perf_counter()
    cal = calibration_engine(rt, device)
    torch.cuda.empty_cache()
    cap = capacity_engine(rt, device)
    torch.cuda.empty_cache()
    spec = spectrum_formats(device)
    keys = ("max_abs_err", "err_bound", "max_rel_err", "keys_equal", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "library_call", "bytes", "ops", "shape")
    per_kernel = {}
    for name in ("channelize", "noise_est"):
        per_kernel[name] = {
            "launches": cal["launches"][name] + cap["launches"][name],
            **{f"at_{g}": {k: cal["kernels"][g][name][k] for k in keys
                           if k in cal["kernels"][g][name]} for g in ("iq", "stop")},
            "at_capacity": {k: cap["kernels"][name][k] for k in keys
                            if k in cap["kernels"][name]}}
    cal["kernels"] = {g: {n: v[f"at_{g}"] for n, v in per_kernel.items()} for g in ("iq", "stop")}
    cap["kernels"] = {n: v["at_capacity"] for n, v in per_kernel.items()}
    out = {"phase": "calibration", "card": card, "config": "bench.py rx888 + calibration groups",
           "engine": cal, "capacity": cap, "spectrum_formats": spec,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    w = cal["n0_worst"]
    if abs(w["dev_db"]) > 1.0:
        fail(f"calibration: N0 of {w['group']}[{w['channel']}] is {w['dev_db']} dB off the scene")
    if abs(cal["noise_gain"]["rel_err"]) > 0.05:
        fail(f"calibration: white-noise gain {cal['noise_gain']}")
    if not cal["stopband_db"] <= -60.0:
        fail(f"calibration: stopband {cal['stopband_db']} dB, want <= -60")
    if abs(cal["snr"]["err_db"]) > 0.75 or abs(cal["snr"]["carrier_db"]
                                               - cal["snr"]["carrier_want_db"]) > 0.1:
        fail(f"calibration: SNR {cal['snr']}")
    for what, r in (("engine", cal), ("capacity", cap)):
        eager = r["graphs"]["eager_blocks"]
        if not r["finite"] or r["launches"] != r["expected"] \
                or r["graphs"]["dispatch"] != "cuda graph" \
                or r["graphs"]["replays"] + sum(eager.values()) != r["blocks"] \
                or r["graphs"]["replays"] < r["blocks"] - 1 \
                or any("spectrum warm-up" not in why for why in eager):
            fail(f"calibration {what}: finite {r['finite']}, launches {r['launches']} want "
                 f"{r['expected']}, graphs {r['graphs']}")
    if cap["audio_shapes"] != [(CAP_C, 160)]:
        fail(f"calibration capacity: audio shapes {cap['audio_shapes']}")
    if not (spec["levels_equal"] and spec["base_step_equal"]) \
            or abs(spec["byte"]["peak_db"] - (-6.0)) >= 2.5 \
            or not 0 < spec["rice"]["bytes"] < 64:
        fail(f"calibration spectrum formats: {spec}")
    return out, per_kernel


# ------------------------------------------ the shipped example deployments
EX_SEED = 41  # every scene's numpy generator
EX_N0 = 1e-14  # the file scenes' noise density, power/Hz (-140 dBFS/Hz)
EX_TONE = 1000.0  # Hz: the tone each scene's known answer listens for
EX_WARM = 2  # blocks of the filters' turn-on, left out of every known answer
# aviation: an AM carrier with EX_TONE on the tower's 118.300 MHz that
# stops at block EX_BLOCKS["aviation"] // 2, over complex noise
EX_AV_FREQ, EX_AV_AMP, EX_AV_DEPTH = 118_300_000.0, 0.01, 0.5
# hf-generic: USB tones 1,500 Hz above the 20 m WSPR dial and 1,000 Hz above
# the 20 m FT8 dial, an NBFM tone on 29.62 MHz (10m-FM), unmodulated carriers
# on the other 10m-FM channels, a CW carrier on W1AW's disabled 14.0475 MHz
EX_HF_STD = 1e-4  # real noise, per sample (N0 = 2 std^2 / fs)
EX_HF_AMP = 5e-4  # each carrier (the wspr preset: gain 60 dB, AGC off)
EX_HF_USB = {"wspr": (14_095_600.0, 1500.0), "ft8": (14_074_000.0, 1000.0)}
EX_HF_FM, EX_HF_FM_DEV = 29_620_000.0, 2500.0
EX_HF_CARRIERS = (29_640_000.0, 29_660_000.0, 29_680_000.0)
EX_HF_W1AW = (3_581_500.0, 14_047_500.0, 21_067_500.0, 28_067_500.0)  # its own dials
EX_HF_CW = 14_047_500.0 + 700.0
# fm: jazz (88.3 MHz) the stereo composite + RDS, npr (89.5 MHz, channels =
# 1) a mono tone, unmodulated carriers on classical and news
EX_FM_AMP, EX_FM_DEV = 0.1, 75_000.0
EX_FM_PI, EX_FM_PS = 0x72D1, "KA9QJAZZ"
EX_FM_RDS = 0.04  # the RDS subcarrier's share of the composite: 3 kHz of deviation
EX_FM_RDS_UP = 16  # rds_modulate runs at fs / 16 (1.92 Msps), held 16 samples
EX_FM_NPR_TONE = 600.0
# spectrum: a carrier inside survey channel 14.5 MHz over noise of density
# EX_SPEC_N0_DB, both from the sig_gen
EX_SPEC_CARRIER, EX_SPEC_AMP_DB, EX_SPEC_N0_DB = 14_623_400.0, -40.0, -130.0
EX_SPEC_CHANNEL = 14_500_000.0
EXAMPLE_BLOCKS = {"siggen": 16, "aviation": 32, "hf-generic": 24, "spectrum": 12, "fm": 48}
EXAMPLE_FORMATS = {"aviation": "cf32le", "hf-generic": "s16be", "fm": "cs16le"}
# the RTP-fed examples through ingest_daemon: (the [hardware] section,
# status, data, fs, frames' width)
EXAMPLE_FEEDS = {
    "aviation": ("airband-feed", "aviation.local", "aviation-pcm.local", 20_480_000.0, 2),
    "hf-generic": ("rx888-feed", "hf.local", "hf-pcm.local", 64_800_000.0, 1),
    "spectrum": ("hf-feed", "survey.local", "survey-pcm.local", 64_800_000.0, 1),
    "fm": ("vhf-feed", "fm.local", "fm-pcm.local", 30_720_000.0, 2),
}
EX_INGEST_WARM, EX_INGEST_BLOCKS = 4, 25


def example_text(name: str, front_end: "list[str] | None" = None) -> str:
    """examples/radiod@<name>.conf as shipped, its `device = rtp` front end
    replaced by the lines of `front_end` (the section's rate, centre and
    other keys kept, the rtp-only ones dropped); every channel, group and
    option as it is."""
    import re

    text = (ROOT / "examples" / f"radiod@{name}.conf").read_text()
    if front_end is None:
        return text
    out, n = re.subn(r"(?m)^device\s*=\s*rtp\b.*$", "\n".join(front_end), text)
    if n != 1:
        fail(f"examples {name}: no `device = rtp` front end to replace")
    return re.sub(r"(?m)^(stream|encoding)\s*=.*$", "", out)


def carriers(fs: float, L: int, rows: list) -> "callable":
    """Carriers whose modulation makes whole cycles in a block (every tone
    here is a multiple of 50 Hz, so it repeats each 20 ms block): rows of
    (RF offset from the centre in Hz, amplitude, modulation [L] complex or
    None). Returns b -> block b's complex sum, each carrier's [L] ramp made
    once and turned by its phase at sample b L (exact in float64)."""
    n = np.arange(L, dtype=np.float64)
    f = np.array([r[0] for r in rows])
    M = np.stack([a * np.exp(2j * np.pi * np.remainder(fk / fs * n, 1.0))
                  * (1.0 if m is None else m) for fk, a, m in rows])

    def block(b: int) -> np.ndarray:
        return np.exp(2j * np.pi * np.remainder(f / fs * (b * L), 1.0)) @ M

    return block


def aviation_scene(L: int, fs: float, center: float, n: int, seed: int = EX_SEED):
    """n blocks of complex noise of density EX_N0, and for the first n // 2
    an AM carrier (depth EX_AV_DEPTH, EX_TONE) on the tower's EX_AV_FREQ."""
    rng = np.random.default_rng(seed)
    std = float(np.sqrt(EX_N0 * fs / 2.0))
    k = np.arange(L, dtype=np.float64)
    env = 1.0 + EX_AV_DEPTH * np.cos(2 * np.pi * (EX_TONE / fs) * k)
    am = carriers(fs, L, [(EX_AV_FREQ - center, EX_AV_AMP, env)])
    for b in range(n):
        x = std * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        yield x + am(b) if b < n // 2 else x


def hf_scene(L: int, fs: float, n: int, seed: int = EX_SEED):
    """n real blocks: EX_HF_USB's tones, the NBFM tone on EX_HF_FM (EX_TONE
    at EX_HF_FM_DEV), the other 10m-FM carriers and W1AW's CW carrier, each
    a cosine of amplitude EX_HF_AMP, over noise of EX_HF_STD a sample."""
    rng = np.random.default_rng(seed)
    k = np.arange(L, dtype=np.float64)
    fm = np.exp(1j * EX_HF_FM_DEV / EX_TONE * np.sin(2 * np.pi * EX_TONE / fs * k))
    tones = carriers(fs, L, [(dial + off, EX_HF_AMP, None) for dial, off in EX_HF_USB.values()]
                     + [(f, EX_HF_AMP, None) for f in (*EX_HF_CARRIERS, EX_HF_CW)]
                     + [(EX_HF_FM, EX_HF_AMP, fm)])
    for b in range(n):
        yield EX_HF_STD * rng.standard_normal(L) + tones(b).real


def rds_groups(n: int) -> list:
    """n RDS 0A groups of station EX_FM_PI carrying the PS name EX_FM_PS, a
    segment each (tests/test_rds.py's layout)."""
    out = []
    for i in range(n):
        seg = i % 4
        b = (0 << 12) | (0 << 11) | (5 << 5) | seg
        out.append((EX_FM_PI, b, 0xE0CD, (ord(EX_FM_PS[2 * seg]) << 8) | ord(EX_FM_PS[2 * seg + 1])))
    return out


def fm_scene(L: int, fs: float, center: float, stations: dict, n: int, seed: int = EX_SEED):
    """n blocks of the FM band: `stations` (name -> RF) at EX_FM_AMP each;
    jazz carries stereo_composite (1 kHz on L, the 19 kHz pilot) plus RDS
    (rds_modulate of rds_groups, on 57 kHz = 3 x the pilot's phase), npr a
    mono EX_FM_NPR_TONE, the rest no modulation; EX_FM_DEV peak deviation,
    the FM phase the running sum of the composite; complex noise of EX_N0.
    The tones' part of the phase repeats each block; RDS's is summed on."""
    from ka9q_radio_tpu_torch.daemons.rds import RDS_BAUD, rds_modulate

    rng = np.random.default_rng(seed)
    std = float(np.sqrt(EX_N0 * fs / 2.0))
    k = np.arange(L, dtype=np.float64)
    rad = 2 * np.pi * EX_FM_DEV / fs  # radians a sample at full deviation
    sps = fs / EX_FM_RDS_UP / RDS_BAUD
    ngroups = int(np.ceil(n * L / EX_FM_RDS_UP / (104 * sps))) + 1
    rds = np.repeat(rds_modulate(rds_groups(ngroups), fs=fs / EX_FM_RDS_UP), EX_FM_RDS_UP)
    sub57 = EX_FM_RDS * np.sin(3 * 2 * np.pi * 19_000.0 / fs * k)
    mods = {"jazz": np.cumsum(rad * stereo_composite(L, fs).astype(np.float64)),
            "npr": np.cumsum(rad * 0.9 * np.cos(2 * np.pi * EX_FM_NPR_TONE / fs * k))}
    rest = carriers(fs, L, [(rf - center, EX_FM_AMP, np.exp(1j * mods[s]) if s in mods else None)
                            for s, rf in stations.items() if s != "jazz"])
    jazz = carriers(fs, L, [(stations["jazz"] - center, EX_FM_AMP, np.exp(1j * mods["jazz"]))])
    rds_phase = 0.0
    for b in range(n):
        dev = rds_phase + np.cumsum(rad * rds[b * L:(b + 1) * L] * sub57)
        rds_phase = float(dev[-1])
        x = std * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
        yield x + rest(b) + jazz(b) * np.exp(1j * dev)


def write_capture(path: Path, fmt: str, blocks) -> int:
    """numpy blocks to a raw capture in `fmt`, as runtime/frontends.py
    FileSource reads it back (s16be real; cs16le and cf32le complex, I/Q
    interleaved; s16 at 32,767 to full scale). Returns the bytes written."""
    nbytes = 0
    with open(path, "wb") as fh:
        for x in blocks:
            if np.iscomplexobj(x):
                v = np.empty(2 * x.size)
                v[0::2], v[1::2] = x.real, x.imag
            else:
                v = x
            if fmt == "cf32le":
                y = v.astype("<f4")
            else:
                y = np.clip(np.rint(v * 32767.0), -32767, 32767).astype(
                    ">i2" if fmt == "s16be" else "<i2")
            fh.write(y.tobytes())
            nbytes += y.nbytes
    return nbytes


def example_capture(name: str, cfg, out_dir: Path, nblocks: int) -> "Path | None":
    """The file scene of `name` (None for the sig_gen ones), written under
    out_dir at the config's rate and centre, nblocks blocks of its L."""
    if name not in EXAMPLE_FORMATS:
        return None
    fs, L = cfg.samprate, int(round(cfg.samprate * cfg.blocktime))
    center = float(getattr(cfg, "center", 0.0))
    if name == "aviation":
        blocks = aviation_scene(L, fs, center, nblocks)
    elif name == "hf-generic":
        blocks = hf_scene(L, fs, nblocks)
    else:
        stations = {g.name: g.channels[0].freq for g in cfg.groups}
        blocks = fm_scene(L, fs, center, stations, nblocks)
    path = out_dir / f"{name}.{EXAMPLE_FORMATS[name]}"
    write_capture(path, EXAMPLE_FORMATS[name], blocks)
    return path


def example_config(name: str, out_dir: Path, nblocks: int) -> tuple[str, list[str]]:
    """(config text, `reduced`) of `name`'s scene: the shipped text with its
    rtp front end replaced by a file capture in the example's own format
    (written first) or, for the spectrum survey, a sig_gen; siggen keeps
    its own sig_gen."""
    from ka9q_radio_tpu_torch.config import load_config

    if name == "siggen":
        return example_text(name), []
    shipped = load_config(example_text(name, ["device = sig_gen"]))  # its rate and centre
    capture = example_capture(name, shipped, out_dir, nblocks)
    if capture is not None:
        fe = ["device = file", f"path = {capture}", f"format = {EXAMPLE_FORMATS[name]}"]
        what = (f"a {EXAMPLE_FORMATS[name]} capture of {nblocks} blocks written by numpy from "
                f"seed {EX_SEED}")
    else:  # the spectrum survey: one carrier over noise of a known density
        fe = ["device = sig_gen", f"carrier = {EX_SPEC_CARRIER}", f"amplitude = {EX_SPEC_AMP_DB}",
              f"n0 = {EX_SPEC_N0_DB}"]
        what = "a sig_gen"
    return example_text(name, fe), [f"the rtp front end -> {what}, at the example's rate and "
                                    "centre: " + "; ".join(fe)]


def rtp_audio(rd, ssrc: int, start: int = 0, stop: "int | None" = None):
    """The audio of ssrc's data packets in rd._sent[start:stop]: (samples
    [n, channels] of the packets' last channel count, its rate, the channel
    count of each packet)."""
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader, decode_samples

    chunks, counts, rate = [], [], 0
    for kind, pkt in rd._sent[start:stop]:
        if kind != "data":
            continue
        h, payload = RtpHeader.unpack(pkt)
        if h.ssrc != ssrc:
            continue
        rate, nch, enc = rd.registry.table[h.type]
        counts.append(nch)
        chunks.append(decode_samples(payload, enc).reshape(-1, nch))
    if not chunks:
        return np.zeros((0, 1), np.float32), rate, counts
    last = [c for c in chunks if c.shape[1] == counts[-1]]
    return np.concatenate(last), rate, counts


def tone_prominence_db(audio: np.ndarray, f0: float, rate: float) -> float:
    """dB of the tone near f0 (tone_amp_db) over the audio's median bin
    amplitude (the same window and scale): 30 dB and more for a clean tone,
    a few dB for noise alone."""
    a = np.asarray(audio, np.float64)
    w = np.hanning(a.size)
    X = np.abs(np.fft.rfft(a * w))
    ref = float(20 * np.log10(2.0 * 3.0 * np.median(X) / np.sqrt(a.size * np.sum(w ** 2))
                              + 1e-15))
    return tone_amp_db(a, f0, rate) - ref


def drive_example(text: str, device, nblocks: int, keep: int,
                  polls: "dict[int, list[int]] | None" = None) -> dict:
    """`text` through two daemons as radiod-torch builds them, one
    dispatching as the daemon does (GraphStep: CUDA graph replays) and one
    eagerly, each from its own front end (the same capture, or sig_gen from
    the same seed), nblocks blocks each; `polls` {block: [ssrc]}: bare polls
    sent to both before that block. Returns the daemons, the graph daemon's
    packet marks a block, its launches and the eager one's, the block it
    read at `keep` (a copy) and the data packets' groups."""
    from ka9q_radio_tpu_torch.config import load_config
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader
    from ka9q_radio_tpu_torch.net.status import StatusType as T, encode_status
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.runtime.radiod import Radiod

    t0 = time.perf_counter()
    rg = Radiod(load_config(text), use_network=False, device=device)
    init_s = time.perf_counter() - t0
    re_ = eager_radiod(Radiod)(load_config(text), use_network=False, device=device)
    daemons = {"graph": rg, "eager": re_}
    launches = {m: dict.fromkeys(MAIN_KERNELS, 0) for m in daemons}
    kept: dict = {}
    to_device, send_data = rg._to_device, rg._send_data
    groups_of: dict[int, set] = {}

    def keep_block(block):
        t = to_device(block)
        if rg.blocks == keep:
            kept["block"] = t.clone()
        return t

    def record_group(pkt, sock=None, group=None):
        groups_of.setdefault(RtpHeader.unpack(pkt)[0].ssrc, set()).add(group)
        send_data(pkt, sock, group)

    rg._to_device, rg._send_data = keep_block, record_group
    marks, walls = [0], {m: 0.0 for m in daemons}
    for b in range(nblocks):
        for m, rd in daemons.items():
            for ssrc in (polls or {}).get(b, []):
                rd.handle_packet(encode_status({T.OUTPUT_SSRC: ssrc}, cmd=True))
            before = {k: cc.launches[k] for k in launches[m]}
            t = time.perf_counter()
            rd.step_block()
            if device.type == "cuda":
                torch.cuda.synchronize()
            walls[m] += time.perf_counter() - t
            for k in before:
                launches[m][k] += cc.launches[k] - before[k]
            if b == EX_WARM - 1:
                rd._t_n = 0  # block times from the first block after the turn-on
        marks.append(len(rg._sent))
    rg._to_device, rg._send_data = to_device, send_data
    p50, p99 = rg.latency_percentiles()
    ep50, ep99 = re_.latency_percentiles()
    return {"graph": rg, "eager": re_, "marks": marks, "launches": launches, "kept": kept,
            "groups_of": groups_of, "init_s": init_s,
            "block_ms": {"p50": p50 * 1e3, "p99": p99 * 1e3,
                         "eager_p50": ep50 * 1e3, "eager_p99": ep99 * 1e3,
                         "graph_wall_ms_a_block": walls["graph"] * 1e3 / nblocks,
                         "eager_wall_ms_a_block": walls["eager"] * 1e3 / nblocks}}


def example_wire(name: str, run: dict) -> dict:
    """The graph daemon's packets against the eager daemon's (same_wire),
    every data packet byte for byte; its launches against the eager one's
    and expected_launches; its dispatches as graph replays."""
    rg, re_ = run["graph"], run["eager"]
    wire = same_wire(re_._sent, rg._sent, rg.registry)
    data_equal = sum(a == b for (k, a), (_, b) in zip(re_._sent, rg._sent) if k == "data")
    blocks = len(run["marks"]) - 1
    want = expected_launches(rg.engine, 0, blocks)
    stats = rg.graph_stats()["current"]
    out = {"wire": {**wire, "data_bytes_equal": data_equal}, "launches": run["launches"]["graph"],
           "eager_launches": run["launches"]["eager"], "want_launches": want,
           "graphs": daemon_graphs(rg)}
    if wire["differ"] or data_equal != wire["data"]:
        fail(f"examples {name}: the graph daemon's packets differ from the eager daemon's: "
             f"{wire['differ'][:6]}, data byte for byte {data_equal} of {wire['data']}")
    if run["launches"]["graph"] != want or run["launches"]["eager"] != want:
        fail(f"examples {name}: launches graph {run['launches']['graph']}, eager "
             f"{run['launches']['eager']}, want {want}")
    eager_why = stats["eager_blocks"]
    if stats["dispatch"] != "cuda graph" or stats["replays"] + sum(eager_why.values()) != blocks \
            or any("spectrum warm-up" not in why for why in eager_why):
        fail(f"examples {name}: graph daemon dispatch {stats['dispatch']}, replays "
             f"{stats['replays']}, eager blocks {eager_why} over {blocks} blocks")
    return out


def example_kernels(name: str, run: dict) -> dict:
    """A and B against their plain versions at each of the example's
    groups' shapes (check_kernels), on the master spectrum of the block the
    graph daemon read at `keep`; spectrum groups launch neither."""
    from ka9q_radio_tpu_torch.ops.filterbank import master_fft

    rd = run["graph"]
    eng = rd.engine
    if "block" not in run["kept"]:
        fail(f"examples {name}: no block kept for the kernels")
    _, F = master_fft(eng.master, eng.init_state()["master"], run["kept"]["block"])
    return {g: {k["name"]: k for k in check_kernels(eng, rd.params, F, g)}
            for g, grp in eng.groups.items() if grp.spec.demod != "spectrum"}


def check_siggen_example(run: dict) -> dict:
    """test_examples.py's test_siggen_example_end_to_end on the card: the AM
    channel (ssrc 500) hears the generator's tone above 100 Hz (the JAX
    test's cut of the envelope's DC term), within 10 Hz."""
    rg = run["graph"]
    audio, rate, _ = rtp_audio(rg, 500, run["marks"][EX_WARM])
    pk = peak_hz(audio[:, 0], rate, above=100.0) if audio.size else None
    out = {"am_peak_hz": pk, "am_samples": int(audio.shape[0]), "rate": rate}
    if pk is None or abs(pk - EX_TONE) > 10.0:
        fail(f"examples siggen: the AM channel peaks at {pk} Hz, want {EX_TONE}")
    return out


def check_aviation_example(run: dict) -> dict:
    """The tower's 118.300 MHz opens on its carrier and hears the tone; the
    other amsq channels send nothing after the turn-on; the guard (am, no
    squelch, as configured) sends its noise without the tone; the tower's
    channel sends no audio after the block the carrier ends in (the
    overlap carries its last samples into block nblocks // 2) and its last
    packet within squelch_tail + 3 blocks of that block (models/linear.py:
    the sequencer counts down from squelch_tail + 4 a closed block, sending
    zeros while above 0); the dynamic pool that prealloc = amsq built sends
    nothing."""
    from ka9q_radio_tpu_torch.net.rtp import RtpHeader

    rg, marks = run["graph"], run["marks"]
    nblocks = len(marks) - 1
    stop = nblocks // 2
    static = {c.ssrc: c for c in rg.chans.values()}

    def blocks_sending(ssrc, nonzero=False):
        out = []
        for b in range(nblocks):
            audio, _, _ = rtp_audio(rg, ssrc, marks[b], marks[b + 1])
            if audio.shape[0] and (not nonzero or np.abs(audio).max() > 0):
                out.append(b)
        return out

    tower = 118_300
    sends = blocks_sending(tower)
    audible = blocks_sending(tower, nonzero=True)
    audio, rate, _ = rtp_audio(rg, tower, marks[EX_WARM], marks[stop])
    pk = peak_hz(audio[:, 0], rate) if audio.size else None
    tail = int(rg.engine.groups["tower"].host["demod"]["squelch_tail"][0])
    others = {s: blocks_sending(s) for s, c in static.items()
              if s != tower and c.group != "guard"}
    guard, grate, _ = rtp_audio(rg, 121_500, marks[EX_WARM], marks[stop])
    g = rg.engine.groups["tower"]
    pool = sorted(rg.free_slots.get("tower", []))
    foreign = sorted({RtpHeader.unpack(p)[0].ssrc for k, p in rg._sent if k == "data"}
                     - set(static))
    out = {"tower_peak_hz": pk, "tower_blocks_sending": sends, "tower_blocks_audible": audible,
           "carrier_blocks": stop, "squelch_tail": tail,
           "others_blocks_sending": {str(s): v for s, v in others.items()},
           "guard_packets": sum(1 for k, p in rg._sent if k == "data"
                                and RtpHeader.unpack(p)[0].ssrc == 121_500),
           "guard_tone_prominence_db": tone_prominence_db(guard[:, 0], EX_TONE, grate)
           if guard.size else None,
           "tower_tone_prominence_db": tone_prominence_db(audio[:, 0], EX_TONE, rate)
           if audio.size else None,
           "groups": {n: gg.C for n, gg in rg.engine.groups.items()},
           "pool_free_slots": pool, "pool_C": g.C, "foreign_ssrcs": foreign}
    if pk is None or abs(pk - EX_TONE) > 10.0:
        fail(f"examples aviation: the tower channel peaks at {pk} Hz, want {EX_TONE}")
    if [b for b in range(EX_WARM, stop) if b not in sends]:
        fail(f"examples aviation: the tower's squelch did not hold open on the carrier: {sends}")
    if not sends or sends[-1] > stop + tail + 3 or not audible or audible[-1] > stop:
        fail(f"examples aviation: the squelch did not close within {tail + 3} blocks of the "
             f"carrier's end at block {stop}: packets in {sends}, audio in {audible}")
    if any(b >= EX_WARM for v in others.values() for b in v):
        fail(f"examples aviation: quiet amsq channels sent: {out['others_blocks_sending']}")
    if not out["guard_packets"] or out["guard_tone_prominence_db"] is None \
            or out["guard_tone_prominence_db"] > 10.0:
        fail(f"examples aviation: the guard (am, open) sent {out['guard_packets']} packets, "
             f"the tone {out['guard_tone_prominence_db']} dB over its noise")
    if len(pool) != g.C - 3 or len(pool) < int(rg.dyn_spare) or foreign:
        fail(f"examples aviation: the amsq pool {pool} in C {g.C} (dyn-slots "
             f"{rg.dyn_spare}), packets from SSRCs outside the table {foreign}")
    return out


def check_hf_example(run: dict) -> dict:
    """Each tone heard within 10 Hz on its own channel, sent under its own
    section's group, whose data stream is the section's own; W1AW (disable
    = yes) built nothing and sent nothing."""
    rg = run["graph"]
    start = run["marks"][EX_WARM]
    want = {(g, round(dial / 1000.0)): off for g, (dial, off) in EX_HF_USB.items()}
    want[("10m-fm", round(EX_HF_FM / 1000.0))] = EX_TONE
    heard = {}
    for (grp, ssrc), f0 in want.items():
        audio, rate, _ = rtp_audio(rg, ssrc, start)
        ch = rg.chans.get(ssrc)
        heard[grp] = {"ssrc": ssrc, "peak_hz": peak_hz(audio[:, 0], rate) if audio.size else None,
                      "want_hz": f0, "rate": rate, "channel_group": ch.group if ch else None,
                      "sent_under": sorted(str(x) for x in run["groups_of"].get(ssrc, ())),
                      "data_stream": rg.engine.groups[ch.group].spec.data if ch else None}
    w1aw = [s for s, c in rg.chans.items() if c.freq in EX_HF_W1AW]
    out = {"heard": heard, "groups": {n: g.C for n, g in rg.engine.groups.items()},
           "w1aw_channels": w1aw,
           "streams": {n: g.spec.data for n, g in rg.engine.groups.items()}}
    for grp, h in heard.items():
        if h["peak_hz"] is None or abs(h["peak_hz"] - h["want_hz"]) > 10.0 \
                or h["channel_group"] != grp or h["sent_under"] != [grp]:
            fail(f"examples hf-generic: {grp}: {h}")
    if heard["wspr"]["data_stream"] != "wspr-pcm.local" \
            or heard["ft8"]["data_stream"] != "ft8-pcm.local" or heard["10m-fm"]["data_stream"]:
        fail(f"examples hf-generic: data streams {out['streams']}")
    if w1aw or "w1aw" in rg.engine.groups:
        fail(f"examples hf-generic: the disabled W1AW section built channels {w1aw}")
    return out


def check_spectrum_example(run: dict) -> dict:
    """The survey's last byte-format sweep of each channel: the carrier's
    channel peaks within one bin of its index; every other channel's median
    byte, through spectrum-base and -step, within 2 steps of the scene's
    density over the channel's noise bandwidth; the group is the wide
    algorithm's."""
    from ka9q_radio_tpu_torch.net.status import StatusType as T, decode_status

    rg = run["graph"]
    g = rg.engine.groups["survey"]
    last = {}
    for kind, pkt in rg._sent:
        if kind != "status":
            continue
        _, f, _ = decode_status(pkt)
        if T.BIN_BYTE_DATA in f:
            last[f[T.OUTPUT_SSRC]] = f
    chans = sorted(c.ssrc for c in rg.chans.values() if c.group == "survey")
    n0_db = EX_SPEC_N0_DB
    ssrc_c = round(EX_SPEC_CHANNEL / 1000.0)
    per = {}
    for s in chans:
        f = last.get(s)
        if f is None:
            continue
        lv = np.frombuffer(f[T.BIN_BYTE_DATA], np.uint8).astype(np.int64)
        base, step, nbw = f[T.SPECTRUM_BASE], f[T.SPECTRUM_STEP], f[T.NOISE_BW]
        rbw = f[T.RESOLUTION_BW]
        per[s] = {"bins": int(lv.size), "peak_index": int(np.argmax(lv)),
                  "peak_db": float(base + lv.max() * step),
                  "median_db": float(base + np.median(lv) * step),
                  "density_db_hz": float(base + np.median(lv) * step - 10 * np.log10(nbw)),
                  "step": step, "rbw": rbw, "noise_bw": nbw}
    want_idx = int(round((EX_SPEC_CARRIER - EX_SPEC_CHANNEL) / per.get(ssrc_c, {}).get("rbw", 1e3)))
    want_idx += g.spec.bin_count // 2
    out = {"channels": len(chans), "answered": len(per), "wide": bool(g.spectrum_wide),
           "carrier_ssrc": ssrc_c, "carrier_index": want_idx, "scene_n0_db_hz": n0_db,
           "per_channel": {str(s): v for s, v in per.items()}}
    if not g.spectrum_wide or len(per) != len(chans) or not chans:
        fail(f"examples spectrum: wide {g.spectrum_wide}, {len(per)} of {len(chans)} channels "
             "answered with BIN_BYTE_DATA")
    c = per[ssrc_c]
    if abs(c["peak_index"] - want_idx) > 1:
        fail(f"examples spectrum: the carrier's channel peaks at bin {c['peak_index']}, "
             f"want {want_idx}")
    bad = {s: v["density_db_hz"] for s, v in per.items()
           if s != ssrc_c and abs(v["density_db_hz"] - n0_db) > 2 * v["step"]}
    if bad:
        fail(f"examples spectrum: noise floors off the scene's {n0_db} dB/Hz: {bad}")
    return out


def check_fm_example(run: dict) -> dict:
    """jazz: L peaks at 1 kHz, separation at least 30 dB (the wfm phase's
    bound), the RDS companion stream decodes to EX_FM_PI; npr (channels =
    1) sends one channel and hears its tone."""
    from ka9q_radio_tpu_torch.daemons.rds import RdsDecoder

    rg = run["graph"]
    start = run["marks"][EX_WARM]
    jazz = next(c for c in rg.chans.values() if c.group == "jazz" and not c.rds)
    rds = next(c for c in rg.chans.values() if c.group == "jazz" and c.rds)
    npr = next(c for c in rg.chans.values() if c.group == "npr" and not c.rds)
    stereo, rate, counts = rtp_audio(rg, jazz.ssrc, start)
    lpk, sep = separation(stereo, rate) if stereo.shape[1] == 2 and stereo.size else (None, None)
    bb, _, _ = rtp_audio(rg, rds.ssrc, start)
    dec = RdsDecoder(48_000.0)
    st = dec.feed(bb[:, 0]) if bb.size else dec.station
    mono, mrate, mcounts = rtp_audio(rg, npr.ssrc, start)
    out = {"jazz": {"ssrc": jazz.ssrc, "channels_per_packet": sorted(set(counts)),
                    "left_peak_hz": lpk, "separation_db": sep,
                    "stereo_samples": int(stereo.shape[0])},
           "rds": {"ssrc": rds.ssrc, "samples": int(bb.shape[0]), "pi": st.pi,
                   "want_pi": EX_FM_PI, "ps": st.ps_name, "groups": st.groups,
                   "block_errors": st.block_errors},
           "npr": {"ssrc": npr.ssrc, "channels_per_packet": sorted(set(mcounts)),
                   "peak_hz": peak_hz(mono[:, 0], mrate) if mono.size else None,
                   "want_hz": EX_FM_NPR_TONE}}
    if lpk is None or abs(lpk - EX_TONE) > 10.0 or sep < 30.0:
        fail(f"examples fm: jazz L peak {lpk} Hz, separation {sep} dB (want {EX_TONE}, >= 30)")
    if st.pi != EX_FM_PI or not st.groups:
        fail(f"examples fm: RDS decoded PI {st.pi:#06x} over {st.groups} groups, want "
             f"{EX_FM_PI:#06x}")
    if set(mcounts) != {1} or out["npr"]["peak_hz"] is None \
            or abs(out["npr"]["peak_hz"] - EX_FM_NPR_TONE) > 10.0:
        fail(f"examples fm: npr {out['npr']}")
    return out


EXAMPLE_CHECKS = {"siggen": check_siggen_example, "aviation": check_aviation_example,
                  "hf-generic": check_hf_example, "spectrum": check_spectrum_example,
                  "fm": check_fm_example}


EXAMPLE_KERNEL_KEYS = ("max_abs_err", "err_bound", "max_rel_err", "keys_equal", "ms", "plain_ms",
                       "call_ms", "bound_ms", "bound_by", "library_ms", "library_call", "bytes",
                       "ops", "shape")


def run_example(name: str, device, tmp: Path) -> tuple[dict, dict]:
    """One shipped example on the card: its scene through the graph and the
    eager daemon (drive_example), its known answers, the two daemons' wires
    and launches (example_wire), A and B at its groups' shapes
    (example_kernels). Returns (its JSON, per kernel the checks by group)."""
    t0 = time.perf_counter()
    n = EXAMPLE_BLOCKS[name]
    text, reduced = example_config(name, tmp, n)
    scene_s = time.perf_counter() - t0
    polls = None
    if name == "spectrum":  # a bare poll arms the lazy survey (spectrum.c:54-77), then reads it
        from ka9q_radio_tpu_torch.config import load_config

        ssrcs = [c.resolved_ssrc() for g in load_config(text).groups for c in g.channels]
        polls = {0: ssrcs, n - 1: ssrcs}
    keep = n // 4  # inside the aviation carrier's run, past every turn-on
    run = drive_example(text, device, n, keep, polls)
    rg = run["graph"]
    L = int(round(rg.cfg.samprate * rg.cfg.blocktime))
    if rg.engine.L != L:
        fail(f"examples {name}: engine L {rg.engine.L}, the capture's {L}")
    answers = EXAMPLE_CHECKS[name](run)
    wire = example_wire(name, run)
    kernels = example_kernels(name, run)
    eng = rg.engine
    out = {"config": f"examples/radiod@{name}.conf", "reduced": reduced, "blocks": n,
           "fs": rg.cfg.samprate, "real": eng.master.real, "L": eng.L, "N": eng.master.N,
           "scene_s": scene_s, "init_s": run["init_s"],
           "groups": {g: {"C": grp.C, "demod": grp.spec.demod, "tiled": bool(grp.tiled),
                          "kernel_a": grp.tile_E is not None, "n_bins": grp.n_bins,
                          "olen": grp.olen, "noise_bins": getattr(grp, "noise_bins", None)}
                      for g, grp in eng.groups.items()},
           "channels": len(rg.chans), "answers": answers, **wire,
           "block_ms": run["block_ms"], "host_ms_per_dispatch": rg.frontend_split(),
           "kernels": {g: {k: {x: v[x] for x in EXAMPLE_KERNEL_KEYS if x in v}
                           for k, v in ks.items()} for g, ks in kernels.items()}}
    if name == "spectrum" and (wire["launches"]["channelize"] or wire["launches"]["noise_est"]
                               or kernels):
        fail(f"examples spectrum: the wide survey launched {wire['launches']}")
    if name == "fm" and (wire["launches"]["channelize"] or not wire["launches"]["noise_est"]
                         or any("channelize" in ks for ks in kernels.values())):
        fail(f"examples fm: launches {wire['launches']}: want B alone (the FFT-IDFT channelizer)")
    for rd in (run["graph"], run["eager"]):
        if rd.frontend is not None:
            rd.frontend.close()
    return out, kernels


def example_kernel_row(per: dict, name: str) -> dict:
    """A kernels-line row of the examples phase run alone: the contract's
    keys from the example and group where the kernel took the longest,
    the phase's launches, and every example's checks."""
    best = max(((ex, g, v) for ex, by in per["by_example"].items()
                for g, v in by.items() if isinstance(v, dict)), key=lambda t: t[2]["ms"])
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc

    return {"route": "cuda", "source": cc.SOURCES[name], "replaces": cc.REPLACES[name],
            **{k: best[2][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
            "at": f"{best[0]} {best[1]}", "launches": per["launches"],
            "at_examples": per["by_example"]}


def example_ingest(card: str, device, name: str, tool) -> dict:
    """`name`'s RTP front end fed by ingest_blast at its own rate, width and
    encoding (s16be), through ingest_daemon: frames accounted, outputs
    finite, every section's RTP on its own stream; achieved Msps and the
    host split reported, real time not gated."""
    section, status, data, fs, width = EXAMPLE_FEEDS[name]
    out, _ = ingest_daemon(card, device, ROOT / "examples" / f"radiod@{name}.conf", section,
                           status, data, fs, width, INGEST_FPP, EX_INGEST_WARM,
                           EX_INGEST_BLOCKS, False, tool)
    out["reduced"].append(f"{EX_INGEST_BLOCKS} timed blocks after {EX_INGEST_WARM} warm ones, "
                          f"{INGEST_FPP:,}-frame packets")
    return out


def run_examples(card: str, device) -> tuple[dict, dict]:
    """The `examples` phase: siggen, aviation, hf-generic, spectrum and fm
    from examples/ (run_example), then the four RTP-fed ones through their
    RTP front end (example_ingest). Captures go to a temporary directory,
    removed after. Returns (the phase's JSON, per kernel its launches and
    checks by example and group)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    results, kernels = {}, {}
    try:
        for name in ("siggen", "aviation", "hf-generic", "spectrum", "fm"):
            if device.type == "cuda":
                import threading

                free, total = torch.cuda.mem_get_info()
                print(f"chip_smoke: examples {name}: device free {free / 2**30:.2f} of "
                      f"{total / 2**30:.2f} GiB, reserved {torch.cuda.memory_reserved() / 2**30:.2f}"
                      f", threads {sorted(t.name for t in threading.enumerate())}",
                      file=sys.stderr, flush=True)
            results[name], kernels[name] = run_example(name, device, tmp)
            for f in tmp.iterdir():
                f.unlink()
            if device.type == "cuda":
                torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tool = tool_module("bench_ingest_torch")
    ingest = {}
    for name in EXAMPLE_FEEDS:
        ingest[name] = example_ingest(card, device, name, tool)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    per_kernel = {}
    for kname in MAIN_KERNELS:
        per_kernel[kname] = {
            "launches": sum(r["launches"][kname] for r in results.values()),
            "by_example": {ex: {"launches": results[ex]["launches"][kname],
                                **{g: {x: ks[kname][x] for x in EXAMPLE_KERNEL_KEYS
                                       if x in ks[kname]}
                                   for g, ks in kernels[ex].items() if kname in ks}}
                           for ex in results}}
    out = {"phase": "examples", "card": card, "examples": results, "ingest": ingest,
           "reduced": [f"{EXAMPLE_BLOCKS[n]} blocks of {n}'s scene" for n in EXAMPLE_BLOCKS],
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    return out, per_kernel


# ----------------------------------------------------- the linear tail kernel
# (C, N): hf-farm's usb group; hf-generic's WSPR, FT8 and FT4 groups
TAIL_SHAPES = (("hf-farm usb", 32_728, 240), ("hf-generic WSPR", 12, 240),
               ("hf-generic FT8", 10, 240), ("hf-generic FT4", 8, 240))
TAIL_ROW_BYTES = 118  # the [C] inputs and outputs a row: 19 + 9 words and 6 bools


def check_linear_tail(card: str, device) -> dict:
    """The linear tail kernel (csrc/linear_tail.cu) against its plain chain
    (linear_tail_plain on the card) at hf-farm's usb group and hf-generic's
    three usb groups, on the card tests' mixed rows (tests/test_torch_cuda.py
    `_tail_rows`: the AGC, the CW shift and the SNR squelch each on about
    half the rows, every AGC branch and squelch state) and held as those
    tests hold it (`_tail_against_plain`: audio within 1e-5 of the row
    peak, the NCO words equal, every decision equal off its knife edge).
    Then its ms (event_ms, a graph of 20 calls) beside the plain chain's,
    its bound by bytes and the share of it reached. Returns the kernel's
    row of the kernels line."""
    from ka9q_radio_tpu_torch.ops import cuda_channelize as cc
    from ka9q_radio_tpu_torch.ops.cuda_tail import cuda_linear_tail, linear_tail_plain

    sys.path.insert(0, str(ROOT / "tests"))
    from test_torch_cuda import _AGC_BRANCHES, _tail_against_plain, _tail_rows

    kw = dict(samprate=12_000, blocktime=0.02)
    rows = []
    for at, C, N in TAIL_SHAPES:
        args = _tail_rows(C, N, device, seed=C)
        try:
            dec = _tail_against_plain(args)
        except AssertionError as e:
            fail(f"linear_tail at {at}: the kernel differs from its plain chain: {e!r}")
        got, want = cuda_linear_tail(*args, **kw), linear_tail_plain(*args, **kw)
        off = torch.as_tensor(~dec["edge"], device=device)
        peak = want[3].abs().amax(-1).clamp(min=1e-30)
        err = ((got[3] - want[3]).abs().amax(-1) / peak)[off]
        ms = event_ms(lambda: cuda_linear_tail(*args, **kw), what=f"linear_tail {at}")
        plain_ms = event_ms(lambda: linear_tail_plain(*args, **kw), what=f"plain tail {at}")
        b = C * (12 * N + TAIL_ROW_BYTES) / HBM_BYTES_S * 1e3
        branch = dec["branch"][~dec["edge"]]
        rows.append({"at": at, "C": C, "N": N, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
                     "bound_by": "bytes", "share_of_bound": b / ms,
                     "max_err_of_row_peak": float(err.max()) if err.numel() else 0.0,
                     "knife_edge_rows": int(dec["edge"].sum()),
                     "agc_branches": {name: int((branch == k).sum())
                                      for k, name in enumerate(("off",) + _AGC_BRANCHES, -1)},
                     "open_rows": int(got[4]["send"].sum())})
        emit({"phase": "linear_tail", "card": card, **rows[-1], **timing_note()})
    return {"name": "linear_tail", "route": "cuda", "source": cc.SOURCES["linear_tail"],
            "replaces": cc.REPLACES["linear_tail"], "at": rows}


def main(only: str | None = None) -> None:
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
    watch_empty_graphs()
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
    if only == "calibration":  # the calibration phase alone
        _, at_cal = run_calibration(rt, card, device)
        finish([{"name": n, **v} for n, v in at_cal.items()], card)
        return
    if only == "examples":  # the examples phase alone
        _, at_ex = run_examples(card, device)
        finish([{**example_kernel_row(at_ex[n], n), "name": n} for n in at_ex], card)
        return

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
    # the linear tail kernel against its plain chain at the cells' usb
    # groups; its row joins the kernels line last, with its launches on the
    # main path below
    tail = check_linear_tail(card, device)

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
    nf = fused_groups(eng)
    if sc["launches"] != {"channelize": sc["blocks"], "noise_est": sc["due_blocks"],
                          "linear_tail": sc["blocks"] * nf}:
        fail(f"launch counts {sc['launches']}: want channelize {sc['blocks']}, "
             f"noise_est {sc['due_blocks']}, linear_tail {sc['blocks'] * nf}")
    if not sc["sweep_finite"] or sc["sweep_shape"] != [16, 128]:
        fail("sweep bins not finite or of the wrong shape")
    if abs(sc["retune_peak_hz"] - sc["retune_expected_hz"]) > 10.0:
        fail(f"retuned channel peaks at {sc['retune_peak_hz']} Hz, want {sc['retune_expected_hz']}")
    if sc["retune_rebuilt"]:
        fail(f"retune reallocated {sc['retune_rebuilt']}")
    for kern in kernels:
        kern["launches"] = sc["launches"][kern["name"]]
    tail["launches"] = sc["launches"]["linear_tail"]

    # phase 4: sustained rate over distinct random blocks, no host syncs
    tr = timed_run(eng, params, device)
    emit({"phase": "timed", "card": card, **tr})
    if tr["launches"] != {"channelize": tr["blocks"], "noise_est": tr["due_blocks"],
                          "linear_tail": tr["blocks"] * nf} or not tr["finite"]:
        fail(f"timed run: launches {tr['launches']}, finite {tr['finite']}")
    # where the time goes: each stage alone (CUDA events), then the device's
    # kernel time inside the step (profiler) against the block time above
    split = stage_split(eng, params, device)
    busy = device_busy(eng, params, device, out_dir)
    emit({"phase": "stages", "card": card, **split, **busy,
          "device_idle_share": 1.0 - busy["busy_ms_per_block"] / tr["ms_per_block"]})
    for kern in kernels:
        kern["in_step_ms"] = busy["kernel_in_step_ms_per_launch"][kern["name"]]
    tail.update(timed_launches=tr["launches"]["linear_tail"],
                in_step_ms=busy["kernel_in_step_ms_per_launch"]["linear_tail"])

    # phase 5: the daemon at full width (the port's Radiod over its Engine)
    dmn, at_daemon, farm = run_daemon(card, device)
    emit(dmn)
    for kern in kernels:
        kern["daemon_launches"] = at_daemon[kern["name"]]["launches"]
        kern["at_daemon"] = at_daemon[kern["name"]]
    tail.update(daemon_launches=at_daemon["linear_tail"]["launches"],
                at_daemon=at_daemon["linear_tail"])
    torch.cuda.empty_cache()

    # phase 6: the kernels at the VHF shapes: A and B at nbfm400 (complex
    # master, n = 600), B at wfm (W = 9,600), the two recurrences at a
    # stand-in C = 400 (phase 9 holds them at the 2 m daemon's own shapes)
    t0 = time.perf_counter()
    veng = rt.Engine(samprate=VHF_FS, real=False, groups=nbfm400_groups(rt))
    weng = rt.Engine(samprate=WFM_FS, real=False, groups=wfm_groups(rt))
    vparams, wparams = veng.init_params(), weng.init_params()
    t_build = time.perf_counter() - t0
    _, F = master_fft(veng.master, veng.init_state()["master"],
                      noise_blocks(veng, 1, NBFM_N0, device, 12)[0])
    at_nbfm = {k["name"]: k for k in check_kernels(veng, vparams, F, "nbfm")}
    _, F = master_fft(weng.master, weng.init_state()["master"],
                      noise_blocks(weng, 1, NBFM_N0, device, 13)[0])
    at_wfm = {k["name"]: k for k in check_kernels(weng, wparams, F, "wfm")}
    if set(at_wfm) != {"noise_est"}:
        fail(f"wfm: kernels {sorted(at_wfm)}, want noise_est alone (the FFT-IDFT channelizer)")
    del F
    recur_c400 = check_recurrences(recurrence_stand_in(device))
    keys = ("max_abs_err", "err_bound", "max_rel_err", "keys_equal", "ms", "plain_ms", "call_ms",
            "bound_ms", "bound_by", "library_ms", "library_call", "bytes", "ops", "shape")
    emit({"phase": "vhf_kernels", "card": card, "engines_s": t_build,
          "nbfm400": {n: {k: v[k] for k in keys if k in v} for n, v in at_nbfm.items()},
          "wfm": {n: {k: v[k] for k in keys if k in v} for n, v in at_wfm.items()},
          "recurrences_c400": recur_c400})
    for kern in kernels:
        kern["at_nbfm400"] = {k: at_nbfm[kern["name"]][k] for k in keys if k in at_nbfm[kern["name"]]}
    kernels[1]["at_wfm"] = {k: at_wfm["noise_est"][k] for k in keys if k in at_wfm["noise_est"]}

    # phase 7: nbfm400 through Engine.step: a 1 kHz FM tone, a quiet channel,
    # then 64 timed blocks and the device's busy share
    sc = nbfm400_scene(veng, vparams, device)
    check_nbfm400_scene(sc)
    if sc["launches"]["channelize"] != sc["blocks"] or sc["launches"]["noise_est"] != sc["due_blocks"]:
        fail(f"nbfm400: launches {sc['launches']}, want channelize {sc['blocks']}, "
             f"noise_est {sc['due_blocks']}")
    tv = timed_run(veng, vparams, device, n0=NBFM_N0)
    busy = device_busy(veng, vparams, device, out_dir, n0=NBFM_N0, trace="nbfm400_trace.json")
    emit({"phase": "nbfm400", "card": card, "config": "bench.py nbfm400", "scene": sc,
          "timed": tv, **busy,
          "device_idle_share": 1.0 - busy["busy_ms_per_block"] / tv["ms_per_block"]})
    if not tv["finite"] or tv["launches"]["channelize"] != tv["blocks"]:
        fail(f"nbfm400 timed run: launches {tv['launches']}, finite {tv['finite']}")
    for kern in kernels:
        kern["at_nbfm400"].update(launches=sc["launches"][kern["name"]],
                                  in_step_ms=busy["kernel_in_step_ms_per_launch"][kern["name"]])
    del veng, vparams
    torch.cuda.empty_cache()

    # phase 8: wfm through Engine.step: stereo separation, the mono fallback
    ws = wfm_scene(weng, wparams, device)
    check_wfm_scene(ws)
    if ws["launches"]["noise_est"] != ws["due_blocks"] or ws["launches"]["channelize"] != 0:
        fail(f"wfm: launches {ws['launches']}, want noise_est {ws['due_blocks']} and the "
             "FFT-IDFT channelizer")
    tw = timed_run(weng, wparams, device, n0=NBFM_N0)
    busy = device_busy(weng, wparams, device, out_dir, n0=NBFM_N0, trace="wfm_trace.json")
    emit({"phase": "wfm", "card": card, "config": "bench.py wfm", "scene": ws, "timed": tw,
          **busy, "device_idle_share": 1.0 - busy["busy_ms_per_block"] / tw["ms_per_block"]})
    if not tw["finite"]:
        fail("wfm timed run: non-finite audio")
    kernels[1]["at_wfm"].update(launches=ws["launches"]["noise_est"],
                                in_step_ms=busy["kernel_in_step_ms_per_launch"]["noise_est"])
    del weng, wparams
    torch.cuda.empty_cache()

    # phase 9: the 2 m daemon: CTCSS, a sam lock, ISB, a narrowband spectrum;
    # then the recurrences against their plain loops on the inputs of their
    # last launches there (the daemon's own C and T)
    vd, seen = vhf_daemon(device)
    check_vhf_daemon(vd)
    recur = check_recurrences(seen)
    emit({"phase": "vhf_daemon", "card": card, "config": str(VHF_CONF.relative_to(ROOT)), **vd,
          "recurrences_at_daemon": recur})
    for kern in kernels:
        kern["vhf_daemon_launches"] = vd["launches"][kern["name"]]
        kern["vhf_daemon_in_ms"] = vd["kernel_in_daemon_ms"][kern["name"]]
        kern["at_vhf_daemon"] = vd["kernels"][kern["name"]]
    for name, kern in recur.items():
        kern.update(launches=vd["launches"][name], in_daemon_ms=vd["kernel_in_daemon_ms"][name],
                    at_c400=recur_c400[name])
    kernels += list(recur.values())
    torch.cuda.empty_cache()

    # phase 10: bench.py's rx888x4 (four 129.6 Msps real streams, one group
    # of 4,000 SSB channels over all four, the sweep on stream 0): both
    # kernels with input offsets against their plain versions, the known
    # answer, 64 timed steps and a trace of 8
    t0 = time.perf_counter()
    meng = rt.Engine(samprate=FS, real=True, groups=rx888_groups(rt, MULTI_B), n_inputs=MULTI_B)
    mparams = meng.init_params()
    t_build = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(20)
    _, F = meng.master_step(meng.init_state()["master"],
                            0.05 * torch.randn((MULTI_B, meng.L), generator=gen, device=device))
    at_multi = {k["name"]: k for k in check_kernels(meng, mparams, F)}
    del F
    ms = multife_scene(meng, mparams, device)
    check_multife_scene(ms)
    tm = timed_run(meng, mparams, device)
    want_tail = tm["blocks"] * fused_groups(meng)
    if tm["launches"] != {"channelize": tm["blocks"], "noise_est": tm["due_blocks"],
                          "linear_tail": want_tail} \
            or not tm["finite"] or tm["if_power_shape"] != [MULTI_B]:
        fail(f"multife timed run: launches {tm['launches']}, finite {tm['finite']}, "
             f"if_power {tm['if_power_shape']}")
    busy = device_busy(meng, mparams, device, out_dir, trace="multife_trace.json")
    emit({"phase": "multife", "card": card, "config": "bench.py rx888x4", "engine_s": t_build,
          "inputs": MULTI_B, "L": meng.L, "bins": meng.master.bins, "ld": meng.ld,
          "groups": {n: {"C": g.C, "n_bins": g.n_bins, "olen": g.olen}
                     for n, g in meng.groups.items()},
          "kernels": {n: {k: v[k] for k in keys if k in v} for n, v in at_multi.items()},
          "scene": ms, "timed": tm, **busy,
          "device_idle_share": 1.0 - busy["busy_ms_per_block"] / tm["ms_per_block"]})
    for kern in kernels[:2]:
        kern["at_multife"] = {**{k: at_multi[kern["name"]][k] for k in keys
                                 if k in at_multi[kern["name"]]},
                              "launches": ms["launches"][kern["name"]],
                              "in_step_ms": busy["kernel_in_step_ms_per_launch"][kern["name"]]}
    del meng, mparams
    torch.cuda.empty_cache()

    # phase 11: an RTL-SDR's 2.4 Msps complex master (N 60,000, not whole
    # 128-bin tiles): the per-element channelizer on cuFFT and kernel B on
    # per-element windows; the FM known answer, 64 timed steps, a trace
    oeng = rt.Engine(samprate=ODD_FS, real=False, groups=odd_master_groups(rt))
    oparams = oeng.init_params()
    og = oeng.groups["nbfm"]
    if og.tiled:
        fail("odd_master: the group took the tiled channelizer")
    _, F = oeng.master_step(oeng.init_state()["master"],
                            noise_blocks(oeng, 1, NBFM_N0, device, 23)[0])
    at_odd = {k["name"]: k for k in check_kernels(oeng, oparams, F, "nbfm")}
    if set(at_odd) != {"noise_est"} or at_odd["noise_est"]["shape"]["window"] != "per-element":
        fail(f"odd_master: kernels {at_odd}")
    chan_ms = event_ms(lambda: og._channelize(oparams["nbfm"], F),
                       what="per-element channelize")
    del F
    osc = nbfm400_scene(oeng, oparams, device, k=ODD_K, quiet=ODD_QUIET)
    check_nbfm400_scene(osc, "odd_master", (80, 480))
    if osc["launches"]["channelize"] != 0 or osc["launches"]["noise_est"] != osc["due_blocks"]:
        fail(f"odd_master: launches {osc['launches']}, want no channelize and noise_est "
             f"{osc['due_blocks']}")
    to_ = timed_run(oeng, oparams, device, n0=NBFM_N0)
    busy = device_busy(oeng, oparams, device, out_dir, n0=NBFM_N0, trace="odd_master_trace.json")
    emit({"phase": "odd_master", "card": card, "config": "bench.py nbfm400 layout at 2.4 Msps",
          "N": oeng.master.N, "n_bins": og.n_bins, "olen": og.olen, "noise_bins": og.noise_bins,
          "channelize_per_element_ms": chan_ms,
          "kernels": {n: {k: v[k] for k in keys if k in v} for n, v in at_odd.items()},
          "scene": osc, "timed": to_, **busy,
          "device_idle_share": 1.0 - busy["busy_ms_per_block"] / to_["ms_per_block"]})
    if not to_["finite"]:
        fail("odd_master timed run: non-finite audio")
    kernels[1]["at_odd_master"] = {
        **{k: at_odd["noise_est"][k] for k in keys if k in at_odd["noise_est"]},
        "launches": osc["launches"]["noise_est"],
        "in_step_ms": busy["kernel_in_step_ms_per_launch"]["noise_est"]}
    del oeng, oparams

    # phase 12: dual-antenna beamforming (tests/test_beam.py's scene)
    bs = beam_scene(rt, device)
    check_beam_scene(bs)
    emit({"phase": "beam", "card": card, "pairs": bs["pairs"],
          "channelize_beam_ms": bs["channelize_beam_ms"],
          "kernels": {n: {k: v[k] for k in keys if k in v} for n, v in bs["kernels"].items()}})
    kernels[1]["beam_launches"] = sum(pr["launches"]["noise_est"] for pr in bs["pairs"])
    torch.cuda.empty_cache()

    # phase 13: the daemon on two front ends (the rx888-wspr farm on stream
    # 0, a usb section on stream 1)
    md = run_multife_daemon(card, device)
    check_multife_daemon(md)
    emit(md)
    for kern in kernels[:2]:
        kern["multife_daemon_launches"] = md["launches"][kern["name"]]

    # phase 14: the sharded engine on D shards of the card (the mesh is one
    # process over a list of devices; here every device is this card)
    mesh_out, at_mesh = run_mesh(rt, card, device)
    emit(mesh_out)
    for kern in kernels[:2]:
        kern["at_mesh"] = at_mesh[kern["name"]]
    torch.cuda.empty_cache()

    # phase 15: a mesh of two processes (2 x 2 shards of the card over gloo):
    # flagship parity, the halo, A and B per process, ms a block
    mh, at_mh = run_multihost(card, out_dir, mesh_out["d4"]["sharded_step"]["ms_per_block"])
    emit(mh)
    for kern in kernels[:2]:
        kern["at_multihost"] = at_mh[kern["name"]]
    torch.cuda.empty_cache()

    # phase 16: the port's churn soak on the card
    emit(run_churn(card, out_dir))

    # phase 17: the client side: fft-gen-torch's cold start of the daemon's
    # config, pcmrecord-torch on the daemon of phase 5, stereod-torch's
    # decode on the card
    cl = run_clients(card, device, farm)
    check_clients(cl)
    emit(cl)
    for edge_, _ in farm.edges.values():
        edge_.close()
    del farm
    torch.cuda.empty_cache()

    # phase 18: the RTP A/D front end: the raw loopback ceiling, the flagship
    # fed at 129.6 Msps through the native reader, the 2 m complex feed
    ing, at_ing = run_ingest(card, device)
    emit(ing)
    for kern in kernels[:2]:
        kern["at_ingest"] = at_ing[kern["name"]]
    torch.cuda.empty_cache()

    # phase 19: the compiled dispatch: each engine cell as CUDA graph
    # replays against its eager step, and the daemon's dispatch latency
    gr, at_graphs = run_graphs(rt, card, device, out_dir)
    emit(gr)
    for kern in kernels[:2]:
        kern["graph_launches"] = at_graphs[kern["name"]]
        kern["in_graph_ms"] = {c: v["kernel_in_graph_ms"][kern["name"]]
                               for c, v in gr["cells"].items()}

    # phase 20: the measuring kit: the bench, high-C daemon and
    # master-ablation twins
    tl, at_tools = run_tools(card, device)
    emit(tl)
    for kern in kernels[:2]:
        kern["tools_launches"] = at_tools[kern["name"]]["launches"]
        kern["at_tools"] = at_tools[kern["name"]]["checks"]
    tail["tools_launches"] = at_tools["linear_tail"]["launches"]

    # phase 21: the control plane: the flagship through doppler, KAISER_BETA,
    # GAIN, MAXDELAY and a preset switch as graph replays; the control-plane
    # tests' config and script, graph daemon against eager daemon
    ctl, at_ctl = run_control(card, device)
    emit(ctl)
    for kern in kernels[:2]:
        kern["control_launches"] = at_ctl[kern["name"]]["launches"]
        kern["at_control"] = at_ctl[kern["name"]]
    torch.cuda.empty_cache()

    # phase 22: the radio's calibration on the card: N0, white-noise gain,
    # stopband and SNR at the rx888 master, 2,000 FM channels as graph
    # replays, the byte and Rice spectrum formats
    _, at_cal = run_calibration(rt, card, device)
    for kern in kernels[:2]:
        kern["calibration_launches"] = at_cal[kern["name"]]["launches"]
        kern["at_calibration"] = at_cal[kern["name"]]
    torch.cuda.empty_cache()

    # phase 23: the shipped example deployments: siggen, aviation,
    # hf-generic, spectrum and fm through radiod-torch on known scenes, graph
    # daemon against eager daemon, A and B at their shapes, the RTP feeds
    _, at_ex = run_examples(card, device)
    for kern in kernels[:2]:
        kern["examples_launches"] = at_ex[kern["name"]]["launches"]
        kern["at_examples"] = at_ex[kern["name"]]["by_example"]
    tail["examples_launches"] = at_ex["linear_tail"]["launches"]
    finish(kernels + [tail], card)


def finish(kernels: list, card: str) -> None:
    """The run's last lines: the kernels line, the card, the result."""
    if "jax" in sys.modules or any(n == "ka9q_radio_tpu" or n.startswith("ka9q_radio_tpu.")
                                   for n in sys.modules):
        fail("the port pulled in jax or the JAX package")
    if EMPTY_GRAPHS:
        fail(f"{len(EMPTY_GRAPHS)} CUDA graph captures recorded nothing: {EMPTY_GRAPHS[:4]}")
    emit({"kernels": kernels, "card": card, "profiler": PROFILER,
          "empty_graph_captures": len(EMPTY_GRAPHS)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-worker"]:
        # python3 chip_smoke.py --multihost-worker RANK NPROC PORT: one process
        # of the multihost phase's mesh; its result is its last line
        if not torch.cuda.is_available():
            fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
        sys.path.insert(0, str(ROOT))
        torch.set_num_threads(2)
        emit(multihost_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                              torch.device("cuda", 0), FS))
    elif sys.argv[1:2] == ["--calibration"]:
        main(only="calibration")
    elif sys.argv[1:2] == ["--examples"]:
        main(only="examples")
    else:
        main()
