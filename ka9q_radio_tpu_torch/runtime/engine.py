"""The channelizer engine — radiod's core as one block function on the GPU.

    step(state, params, block) -> (state, outputs)

  * `state`  — everything carried across blocks (master FFT tail, fine-tune
    phase accumulators, smoothed noise floors, AGC/squelch state), a dict of
    tensors with the JAX package's key names, plus `state["host"]`: Python
    ints mirroring the block counter, each group's warm-up countdown and
    wide-spectrum frame count.
  * `params` — everything a retune modifies (bin shifts, tile-frame
    responses, NCO increments, squelch thresholds, gains), a dict of tensors
    with the JAX package's key names. A retune writes the changed channel's
    row into these tensors in place; nothing is rebuilt.
  * structure — channel-group membership, demod type, block geometry.

Where the JAX engine branches on device values with lax.cond (the spectrum
`armed` gate; the N0 cadence `warm | jobnum % noise_every == 0`), this
engine decides on host mirrors (the `host` ints of the state, the group's
host copy of `armed`), so no block reads a device value back to the host:
_Group.branch alone decides (the Engine docstring says how). The state
tensors keep the same values as the JAX engine's.

Per-block per-group pipeline (downconvert(), radio.c:1451-1562):
  master FFT (torch.fft, cuFFT on the card; B spectra for B inputs)
  -> tiled channelizer (CUDA kernel, ops/cuda_channelize.py); the
     per-element channelizer of small or odd complex masters, or the
     beamforming one (a gather and cuFFT)
  -> N0 estimate on its cadence (CUDA kernel) + EMA smoothing
  -> fine-tune Q32 NCO + Renfors block phase adjustment
  -> optional filter2 cascade (a second overlap-save stage at the output
     rate) with the ISB unpack
  -> demodulator: linear (SSB/CW, PLL for SAM/DSB, envelope for AM, stereo
     I/Q), NBFM with CTCSS, WFM stereo with RDS, or narrowband spectrum; a
     wide spectrum group takes windowed FFTs of the raw block instead.

Every demodulator of the JAX package runs, with squelch-gated egress
compaction and the daemon's table surgery (retune and set_edges write rows
in place; adopt_host_params and migrate_state carry a rebuilt channel
table's params and state), and adaptive spur notches on the master bins.
One engine serves B same-geometry inputs (n_inputs=B): step takes a [B, L]
block, the master FFT runs over the [B] axis and its spectra are padded to
rows of whole 128-bin tiles (the kernels' row stride); each channel reads
the input its ChannelSpec (or its group) names, so one batched group can
span every stream. Dual-antenna beamforming runs on complex masters.

On a mesh (parallel/: one process over a list of devices, or several
processes joined by torch.distributed, each over its own) the engine is
sharded: the master runs as the distributed digit-order transform
(parallel/master.py), each group's channels split into C/D rows a device
(a wide spectrum, which reads the raw block, replicated), and kernels A and B run on each device's rows of the all-gathered
natural-order spectrum; or, time-sharded, step_time runs D consecutive
blocks a dispatch, one a device (parallel/timeshard.py). On a mesh of
several processes every process steps with the same host values, and a
split group's outputs are the process's own channel rows (mesh.rows(C)).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..ops.cuda_channelize import (channelize_operand, channelize_plan, cuda_channelize,
                                   cuda_noise_est, fold_pad, sm_count)
from ..ops.cuda_tail import cuda_linear_tail
from ..ops.filter_design import design_bandpass_response, response_to_device_order
from ..ops.filterbank import (
    _CTILE,
    MasterConfig,
    block_phase_adjust_q32,
    build_tile_params,
    channelize,
    channelize_beam,
    compute_tuning,
    finish_channelize,
    fine_tune,
    isb_unpack,
    master_fft,
    master_init,
    tile_plan,
    tiled_channelize,
    tiled_idft_matrix,
)
from ..ops.noise import MIN_NOISE_BINS, POWER_ALPHA
from ..ops.osc import rev_to_q32
from ..models.fm import fm_demod, fm_init
from ..models.linear import linear_demod, linear_init
from ..models.spectrum import (spectrum_accumulate, spectrum_constants, spectrum_geometry,
                               spectrum_init, wide_accumulate, wide_constants, wide_extract,
                               wide_geometry, wide_init)
from ..models.wfm import AUDIO_SAMPRATE, wfm_constants, wfm_demod, wfm_design, wfm_geometry, wfm_init
from ..ops.noise import estimate_noise
from ..parallel.sharding import (Mesh, Sharded, all_gather, each, local_tree,
                                 place_like, reassemble, shard_engine_tree, write_row)
from ..utils.device import resolve_device, to_tensors
from ..utils.units import dB_to_power, dB_to_voltage

__all__ = ["ChannelSpec", "GroupSpec", "Engine", "DEFAULTS", "migrate_state"]

# Reference compiled defaults (modes.c:33-62)
DEFAULTS = dict(
    kaiser_beta=11.0,
    squelch_open_db=8.0,
    squelch_close_db=7.0,
    squelch_tail=1,
    headroom_db=-15.0,
    recovery_rate_db=20.0,
    threshold_db=-15.0,
    gain_db=50.0,
    hangtime_s=1.1,
    pll_bw_hz=10.0,
    nbfm_deemph_tc_us=530.5,
    nbfm_deemph_gain_db=12.0,
    wfm_deemph_tc_us=75.0,
    wfm_deemph_gain_db=0.0,
)

_COMPOSITE_SAMPRATE = 384_000  # WFM composite rate (wfm.c:22)
_IDFT_BYTES = 32 << 20  # above this [S, olen] constant, the FFT-IDFT channelizer
_SPUR_ALPHA = float(np.float32(0.01))  # the spur trackers' one-pole, ~10 s (filter.c:447)


@dataclasses.dataclass(frozen=True)
class ChannelSpec:
    """One receiver channel (a [section] with one freq in radiod.conf)."""

    freq: float  # RF carrier/center frequency, Hz
    low: float = -5000.0  # passband edges relative to carrier, Hz
    high: float = 5000.0
    ssrc: int | None = None  # RTP SSRC; default kHz of freq (radio.c:936)
    input: int | None = None  # front-end stream (multi-input engines)
    shift_hz: float = 0.0  # post-detection shift (CW offset)
    tone_freq: float = 0.0  # CTCSS tone, Hz (FM)
    squelch_open_db: float | None = None
    squelch_close_db: float | None = None
    gain_db: float | None = None  # manual gain when AGC off

    def resolved_ssrc(self) -> int:
        return self.ssrc if self.ssrc is not None else int(round(self.freq / 1000.0))


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """A rate class: channels sharing demod type, output rate and flags.

    demod: "fm" | "linear" | "iq" (linear with stereo I/Q out) |
           "envelope"/"am" (linear envelope) | "sam" (PLL AM) | "wfm" |
           "spectrum". Field meanings as in the JAX package's GroupSpec.
    """

    name: str
    demod: str
    samprate: int
    channels: tuple[ChannelSpec, ...]
    kaiser_beta: float = DEFAULTS["kaiser_beta"]
    squelch_open_db: float | None = None
    squelch_close_db: float | None = None
    squelch_tail: int | None = None
    headroom_db: float | None = None
    hangtime_s: float | None = None
    recovery_rate_db: float | None = None
    threshold_db: float | None = None
    gain_db: float | None = None
    pll_bw_hz: float | None = None
    enable_pll: bool = False
    pll_square: bool = False
    envelope: bool = False
    stereo: bool = False
    agc: bool = True
    snr_squelch: bool = False
    ctcss: bool = False
    threshold_extend: bool = False
    deemph_tc_us: float | None = None
    deemph_gain_db: float | None = None
    dc_cut_hz: float = 0.0
    filter2: int = 0
    filter2_kaiser_beta: float | None = None
    isb: bool = False
    beam: bool = False
    a_weight: complex = 1.0 + 0.0j
    b_weight: complex = 0.0 + 0.0j
    wfm_stereo: bool = True
    egress_slots: int = 0
    bin_bw: float = 200.0  # resolution bandwidth per bin, Hz
    bin_count: int = 64
    spectrum_window: str = "kaiser"
    spectrum_window_param: float = 7.0  # DEFAULT_SPECTRUM_KAISER_BETA
    fft_avg: int = 10
    spectrum_overlap: float = 0.0
    crossover: float = 200.0  # rbw at or above this -> wideband raw-A/D algorithm
    spectrum_lazy: bool = True
    spectrum_idle_s: float = 10.0
    input: int = 0
    encoding: str | None = None
    data: str | None = None
    update: int | None = None
    ttl: int | None = None

    def __post_init__(self):
        if self.demod in ("am", "envelope"):
            object.__setattr__(self, "demod", "linear")
            object.__setattr__(self, "envelope", True)
        elif self.demod == "sam":
            object.__setattr__(self, "demod", "linear")
            object.__setattr__(self, "enable_pll", True)
        elif self.demod == "iq":
            object.__setattr__(self, "demod", "linear")
            object.__setattr__(self, "stereo", True)
        elif self.demod == "wfm":
            object.__setattr__(self, "samprate", _COMPOSITE_SAMPRATE)
            object.__setattr__(self, "snr_squelch", True)


def takes_fused_tail(spec: GroupSpec, device) -> bool:
    """Whether a group runs its tail as the linear_tail kernel
    (ops/cuda_tail.py): a linear group without PLL, envelope, stereo,
    filter2 or ISB (usb, lsb, a cw offset), on the card. Every other group
    runs the plain chain."""
    return (spec.demod == "linear" and not (spec.enable_pll or spec.envelope or spec.stereo)
            and spec.filter2 <= 0 and not spec.isb and torch.device(device).type == "cuda")


def _tree_to(tree, dev: torch.device):
    """A tree of tensors (None leaves kept) on dev."""
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev, non_blocking=dev.type == "cuda") if torch.is_tensor(tree) else tree


def _copy_leaves(params, host) -> None:
    """Write a tree of host mirrors into the params placed from it, leaf by
    leaf in place (a tensor, or a Sharded leaf's shards)."""
    for k, v in host.items():
        if isinstance(v, dict):
            _copy_leaves(params[k], v)
        else:
            params[k].copy_(torch.from_numpy(np.asarray(v)))


class _Group:
    """Host-side geometry, host mirrors and device params of one GroupSpec."""

    def __init__(self, spec: GroupSpec, master: MasterConfig, samprate: float, blocktime: float,
                 centers: Sequence[float], noise_every: int, device: torch.device,
                 mesh: Mesh | None = None, split: bool = False, use_tiled: bool = True):
        self.spec = spec
        self.master = master
        self.fs_in = samprate
        self.blocktime = blocktime
        self.device = device
        # on a mesh: split=True puts C/D channel rows on each device (the
        # channel-sharded engine), split=False replicates the group on every
        # device (the time-sharded engine, and a wide spectrum group)
        self.mesh = mesh
        self.split = split
        if spec.demod not in ("linear", "fm", "wfm", "spectrum"):
            raise ValueError(f"group {spec.name}: unknown demod {spec.demod!r}")
        # per-channel front-end binding (ChannelSpec.input overrides the
        # group's): a host mirror, and on an engine of several inputs the
        # device tensor the gathers and kernels read
        self.inputs = np.array(
            [c.input if c.input is not None else spec.input for c in spec.channels], np.int32)
        self.multi = len(centers) > 1  # an engine of several inputs (a centre each)
        self.inputs_t = torch.as_tensor(self.inputs, device=device) if self.multi else None
        # front-end centre: dial RF -> IF is freq - center (Frontend.frequency,
        # radio.c:1479), each channel's from its own input
        self.center = float(centers[int(spec.input)])
        self.center_of = np.array([centers[i] for i in self.inputs], np.float64)
        r = int(spec.samprate)
        fs = int(round(samprate))
        N, L = master.N, master.L
        if (N * r) % fs or (L * r) % fs:
            raise ValueError(
                f"group {spec.name}: output rate {r} not commensurate with "
                f"master N={N} L={L} fs={fs} (round to multiples of "
                f"{fs // np.gcd(fs, N)} Hz)")
        self.n_bins = N * r // fs
        self.olen = L * r // fs
        self.C = len(spec.channels)
        if self.C == 0:
            raise ValueError(f"group {spec.name}: no channels")
        # the channel rows this process's outputs carry: all of them, but
        # for a split group on a mesh of several processes
        self.rows = (mesh.rows(self.C) if mesh is not None and split and mesh.multiproc
                     else slice(0, self.C))
        self.noise_bins = int(min(master.bins, max(self.n_bins, MIN_NOISE_BINS)))
        # N0 re-estimates every `noise_every`-th block (warm-up blocks always),
        # with the EMA coefficient compounded to keep the time constant
        self.noise_every = max(1, int(noise_every))
        self.noise_alpha = float(1.0 - (1.0 - POWER_ALPHA) ** self.noise_every)
        if spec.demod == "wfm":
            self.wfm_geo = wfm_geometry(blocktime)
            self.wfm_responses = wfm_design(self.wfm_geo, spec.kaiser_beta)
            self.wfm_consts = wfm_constants(self.wfm_geo, self.wfm_responses, device)
        if spec.filter2 > 0 or spec.isb:
            # filter2 cascade (radio.c:1543-1554): power-of-2 FFT at the output rate
            self.f2_L = self.olen
            self.f2_N = 1 << int(np.ceil(np.log2(max(2 * self.f2_L, 2))))
            self.f2_M = self.f2_N - self.f2_L + 1
        else:
            self.f2_N = 0
        # spectrum algorithm crossover (spectrum.c, modes.c:69): coarse rbw
        # reads the raw A/D block, fine rbw the downconverted baseband
        self.spectrum_wide = spec.demod == "spectrum" and spec.bin_bw >= spec.crossover
        if self.spectrum_wide and self.multi and np.any(self.inputs != spec.input):
            raise ValueError(
                f"group {spec.name}: wideband spectrum reads the raw "
                "A/D block — its channels cannot span inputs")
        self.sgeo = None  # a spectrum group's geometry (wide_geo or spectrum_geo)
        if self.spectrum_wide:
            # every process computes the whole sweep from the replicated raw
            # block, so its leaves replicate (no collective in its step);
            # its outputs are still the process's rows (self.rows)
            self.split = False
            self.sgeo = self.wide_geo = wide_geometry(
                self.fs_in, master.L, master.real, spec.bin_bw, spec.spectrum_window,
                spec.spectrum_window_param, spec.fft_avg, spec.spectrum_overlap)
            self.wide_consts = wide_constants(self.wide_geo, device)
        elif spec.demod == "spectrum":
            self.sgeo = self.spectrum_geo = spectrum_geometry(
                r, self.olen, spec.bin_bw, spec.bin_count, spec.spectrum_window,
                spec.spectrum_window_param, spec.fft_avg, spec.spectrum_overlap)
            self.spectrum_consts = spectrum_constants(self.spectrum_geo, device)
        # the tiled channelizer, where it is exact: kernel A with the
        # [S, olen] IDFT constant, or past _IDFT_BYTES of constant (WFM's
        # 9,600-bin slice) the FFT-IDFT form on cuFFT while its fold wraps
        # once. Beamforming keeps its mirror-combining gather; complex
        # masters that are not whole tiles, n_bins^2 >= 2^31 (the 32-bit
        # ramp) and a fold that would wrap twice take the per-element
        # channelizer (a gather and cuFFT)
        self.tiled = (use_tiled and not spec.beam and not self.spectrum_wide
                      and (master.real or N % _CTILE == 0) and self.n_bins * self.n_bins < 2**31)
        self.tile_E = self.tile_op = None
        if self.tiled:
            S = tile_plan(self.n_bins) * _CTILE
            if S * self.olen * 8 > _IDFT_BYTES:
                self.tiled = S - self.n_bins <= self.n_bins
            else:
                self.tile_E = torch.as_tensor(tiled_idft_matrix(self.n_bins, self.olen, S),
                                              device=device)
                # the channelizer kernel's form of tile_E (split real-block GEMM operand)
                self.tile_op = channelize_operand(self.tile_E, self.n_bins, self.olen)
        self.fused_tail = takes_fused_tail(spec, device)
        self.lcs = self._local_consts()
        self.params = self._build_params()

    def channelize_designs(self) -> list[tuple[int, str]]:
        """Kernel A's launches a block in this process: (channels,
        channelize_plan's design at them on the launch's card; "one-shot" off
        a card), one a local shard of a split group on a mesh; none where the
        group runs another channelizer."""
        if self.tile_E is None:
            return []
        mesh, C = self.mesh, self.C
        if mesh is None or not self.split:
            shards = [(C, self.device if mesh is None else mesh.devices[mesh.local[0]])]
        else:
            q = -(-C // mesh.size)
            shards = [(min(q, C - d * q), mesh.devices[d]) for d in mesh.local if d * q < C]
        return [(c, channelize_plan(c, fold_pad(self.n_bins), self.olen, sm_count(dev)))
                for c, dev in shards]

    def _local_consts(self) -> list:
        """Each shard's device constants (one entry off a mesh): the IDFT
        constant and its kernel operand, the channels' inputs (a split
        group's local rows), the demodulators' constant tables."""
        base = {"tile_E": self.tile_E, "tile_op": self.tile_op, "inputs": self.inputs_t,
                "wfm": getattr(self, "wfm_consts", None),
                "spectrum": getattr(self, "spectrum_consts", None),
                "wide": getattr(self, "wide_consts", None)}
        if self.mesh is None:
            return [base]
        D = self.mesh.size
        by_dev: dict = {}

        def local(d):
            dev = self.mesh.devices[d]
            if dev not in by_dev:
                by_dev[dev] = _tree_to(base, dev)
            lc = dict(by_dev[dev])
            if self.split and lc["inputs"] is not None:
                lc["inputs"] = torch.chunk(lc["inputs"], D)[d].contiguous()
            return lc

        return each(self.mesh, local)

    def _place(self, host_tree) -> dict[str, Any]:
        """Host mirrors -> device params: on one device, or on a mesh split
        into C/D channel rows (leaves led by C) or replicated."""
        p = to_tensors(host_tree, self.device)
        if self.mesh is None:
            return p
        C = self.C if self.split else None

        def place(t):
            if isinstance(t, dict):
                return {k: place(v) for k, v in t.items()}
            if C is not None and t.dim() >= 1 and t.shape[0] == C:
                return Sharded.split(t, self.mesh, 0)
            return Sharded.replicate(t, self.mesh)

        return place(p)

    # -- retunable params ---------------------------------------------------
    def _tuning_arrays(self, freqs: np.ndarray):
        N, L, fs = self.master.N, self.master.L, self.fs_in
        shifts = np.zeros(self.C, np.int32)
        incs = np.zeros(self.C, np.int32)
        adjs = np.zeros(self.C, np.int32)
        for i, f in enumerate(freqs):
            shift, rem, ok = compute_tuning(N, fs, float(f) - self.center_of[i])
            if not ok:
                raise ValueError(f"freq {f} outside front-end coverage")
            shifts[i] = shift
            incs[i] = rev_to_q32(-rem / self.spec.samprate)
            adjs[i] = block_phase_adjust_q32(shift, L, N)
        return shifts, incs, adjs

    def _design_main(self, low: float, high: float, kaiser_beta: float | None = None) -> np.ndarray:
        """Main channel response; widened into a roofing filter when the
        filter2 cascade is on (radio.c:1635-1643)."""
        r = self.spec.samprate
        lo, hi = min(low, high), max(low, high)
        if self.f2_N:
            V = self.master.overlap
            margin = 4.0 * (1.0 / self.blocktime) * (V - 1) / V
            lo, hi = max(lo - margin, -r / 2), min(hi + margin, r / 2)
        beta = kaiser_beta if kaiser_beta is not None else self.spec.kaiser_beta
        return response_to_device_order(design_bandpass_response(
            self.n_bins, self.olen, lo / r, hi / r, kaiser_beta=beta,
            real_master=self.master.real, master_points=self.master.N))

    def _design_f2(self, low: float, high: float, kaiser_beta: float | None = None) -> np.ndarray:
        """filter2 response at the exact edges (set_filter on filter2.out)."""
        r = self.spec.samprate
        lo, hi = max(min(low, high), -r / 2), min(max(low, high), r / 2)
        beta = kaiser_beta if kaiser_beta is not None else self.spec.filter2_kaiser_beta
        return response_to_device_order(design_bandpass_response(
            self.f2_N, self.f2_L, lo / r, hi / r,
            kaiser_beta=beta if beta is not None else self.spec.kaiser_beta,
            real_master=False, master_points=self.f2_N))

    def _build_params(self) -> dict[str, Any]:
        """Build the numpy host mirrors (`self.host`) and the device params."""
        spec = self.spec
        chans = spec.channels
        freqs = np.array([c.freq for c in chans], np.float64)
        shifts, incs, adjs = self._tuning_arrays(freqs)
        # channels sharing passband edges share ONE design
        designs: dict[tuple, np.ndarray] = {}
        for c in chans:
            if (c.low, c.high) not in designs:
                designs[(c.low, c.high)] = self._design_main(c.low, c.high)
        resp = np.stack([designs[(c.low, c.high)] for c in chans])
        f32 = lambda v: np.asarray(v, np.float32)  # noqa: E731
        i32 = lambda v: np.asarray(v, np.int32)  # noqa: E731

        def opt(field, default_key):
            v = getattr(spec, field)
            return v if v is not None else DEFAULTS[default_key]

        p: dict[str, Any] = {"responses": resp, "shifts": shifts, "inc_q32": incs,
                             "adj_q32": adjs}
        if self.tiled:
            p["resp_tiles"], p["tile_lo"], p["slope"] = build_tile_params(
                resp, shifts, self.master.real, self.master.N)
        if self.f2_N:
            p["responses2"] = np.stack([self._design_f2(c.low, c.high) for c in chans])
        if spec.beam:
            if self.master.real:
                raise ValueError("beamforming needs a complex master")
            p["beam_alpha"] = np.full(self.C, complex(spec.a_weight), np.complex64)
            p["beam_beta"] = np.full(self.C, complex(spec.b_weight), np.complex64)
        g_sq_open = opt("squelch_open_db", "squelch_open_db")
        g_sq_close = opt("squelch_close_db", "squelch_close_db")
        r = spec.samprate
        C = self.C
        d = {
            "bandwidth": f32([abs(c.high - c.low) for c in chans]),
            "headroom": f32(np.full(C, dB_to_voltage(opt("headroom_db", "headroom_db")))),
            "squelch_open": f32([dB_to_power(c.squelch_open_db if c.squelch_open_db is not None
                                             else g_sq_open) for c in chans]),
            "squelch_close": f32([dB_to_power(c.squelch_close_db if c.squelch_close_db is not None
                                              else g_sq_close) for c in chans]),
            "squelch_tail": i32(np.full(C, opt("squelch_tail", "squelch_tail"))),
            "snr_squelch_enable": np.full(C, spec.snr_squelch, bool),
        }

        def deemph(default_tc: str, default_gain: str, rate_hz: float) -> dict:
            tc = (spec.deemph_tc_us if spec.deemph_tc_us is not None else DEFAULTS[default_tc]) * 1e-6
            g_db = spec.deemph_gain_db if spec.deemph_gain_db is not None else DEFAULTS[default_gain]
            rate = -np.expm1(-1.0 / (tc * rate_hz)) if tc > 0 else 0.0
            return {"deemph_rate": f32(np.full(C, rate)),
                    "deemph_gain": f32(np.full(C, dB_to_voltage(g_db)))}

        if spec.demod == "spectrum":
            # poll-gating flag (spectrum.c:161-186): 1 = accumulate this block
            p["armed"] = np.float32(1.0)
            d = {}
        elif spec.demod == "wfm":
            # de-emphasis at the audio rate (modes.c:408-412); stereo by
            # default (wfm.c:38-41), the mono fallback is automatic
            d.update(deemph("wfm_deemph_tc_us", "wfm_deemph_gain_db", AUDIO_SAMPRATE),
                     stereo_enable=np.full(C, spec.wfm_stereo, bool))
        elif spec.demod == "fm":
            d.update(threshold_ext=np.full(C, spec.threshold_extend, bool),
                     **deemph("nbfm_deemph_tc_us", "nbfm_deemph_gain_db", r),
                     tone_freq=f32([c.tone_freq for c in chans]))
        else:
            g_gain = opt("gain_db", "gain_db")
            d.update({
                "agc_enable": np.full(C, spec.agc, bool),
                "hangtime_samples": i32(np.full(C, int(opt("hangtime_s", "hangtime_s") * r))),
                "recovery_per_sample": f32(np.full(C, dB_to_voltage(
                    opt("recovery_rate_db", "recovery_rate_db") / r))),
                "threshold": f32(np.full(C, dB_to_voltage(opt("threshold_db", "threshold_db")))),
                "manual_gain": f32([dB_to_voltage(c.gain_db if c.gain_db is not None else g_gain)
                                    for c in chans]),
                "shift_inc_q32": i32([rev_to_q32(c.shift_hz / r) for c in chans]),
                "pll_square": np.full(C, spec.pll_square, bool),
                "pll_loop_bw": f32(np.full(C, opt("pll_bw_hz", "pll_bw_hz"))),
                "dc_tau": f32(np.full(C, -np.expm1(-2.0 * np.pi * spec.dc_cut_hz / r)
                                      if spec.dc_cut_hz > 0 else 0.0)),
            })
        p["demod"] = d
        # build-time demod defaults: a freed dynamic slot is restored from these
        self.pristine_demod = {k: np.copy(v) for k, v in d.items()}
        self.host = p  # authoritative numpy mirrors for host-side surgery
        return self._place(p)

    def _refresh_tile_row(self, idx: int) -> None:
        """Recompute one channel's tile-frame layout from the host mirrors."""
        rt, tl, sl = build_tile_params(
            self.host["responses"][idx: idx + 1], self.host["shifts"][idx: idx + 1],
            self.master.real, self.master.N)
        self.host["resp_tiles"][idx] = rt[0]
        self.host["tile_lo"][idx] = tl[0]
        self.host["slope"][idx] = sl[0]

    def retune(self, params: dict[str, Any], idx: int, freq: float) -> dict[str, Any]:
        """Retune channel idx to freq (set_freq, radio.c:1140-1175): host
        arithmetic, then the channel's row written into the param tensors in
        place. Returns `params` itself."""
        N, L, fs = self.master.N, self.master.L, self.fs_in
        shift, rem, ok = compute_tuning(N, fs, float(freq) - self.center_of[idx])
        if not ok:
            raise ValueError(f"freq {freq} outside front-end coverage")
        h = self.host
        h["shifts"][idx] = np.int32(shift)
        h["inc_q32"][idx] = rev_to_q32(-rem / self.spec.samprate)
        h["adj_q32"][idx] = block_phase_adjust_q32(shift, L, N)
        keys = ["shifts", "inc_q32", "adj_q32"]
        if self.tiled:
            self._refresh_tile_row(idx)
            keys += ["tile_lo", "slope"]
            write_row(params["resp_tiles"], idx, h["resp_tiles"][idx])
        for k in keys:
            write_row(params[k], idx, int(h[k][idx]))
        return params

    def set_edges(self, params: dict[str, Any], idx: int, low: float, high: float,
                  kaiser_beta: float | None = None,
                  filter2_kaiser_beta: float | None = None) -> dict[str, Any]:
        """Redesign channel idx's filter (set_filter, filter.c:934-1007): host
        design, then the channel's rows of the responses, the tile-frame
        responses, the filter2 response and the bandwidth written into the
        params in place. Returns `params` itself."""
        h = self.host
        h["responses"][idx] = self._design_main(low, high, kaiser_beta)
        write_row(params["responses"], idx, h["responses"][idx])
        if self.tiled:
            self._refresh_tile_row(idx)
            write_row(params["resp_tiles"], idx, h["resp_tiles"][idx])
        if self.f2_N:
            h["responses2"][idx] = self._design_f2(low, high, filter2_kaiser_beta)
            write_row(params["responses2"], idx, h["responses2"][idx])
        if "bandwidth" in h["demod"]:
            self.set_demod(params, idx, "bandwidth", abs(high - low))
        return params

    def set_demod(self, params: dict[str, Any], idx: int, key: str, value) -> bool:
        """Write one channel's demod param (host mirror and device row in
        place). Returns False where the group has no such key."""
        d = self.host["demod"]
        if key not in d:
            return False
        d[key][idx] = value
        write_row(params["demod"][key], idx, d[key][idx].item())
        return True

    def set_armed(self, params: dict[str, Any], armed: bool) -> dict[str, Any]:
        """Arm or disarm a spectrum group's accumulation (the daemon's poll
        gating, spectrum.c:161-186), in the host mirror and the param."""
        self.host["armed"] = np.float32(1.0 if armed else 0.0)
        params["armed"].fill_(float(self.host["armed"]))
        return params

    # -- carried state ------------------------------------------------------
    def init_state(self) -> dict[str, Any]:
        dev = self.device
        dc = {
            "acc_q32": torch.zeros((self.C,), dtype=torch.int32, device=dev),
            "n0": torch.zeros((self.C,), dtype=torch.float32, device=dev),
            # master-filter warm-up countdown: while >0, N0 re-seeds instead
            # of EMA-smoothing (the first blocks see the turn-on transient)
            "warmup": torch.full((), 2, dtype=torch.int32, device=dev),
        }
        if self.f2_N:
            dc["tail2"] = torch.zeros((self.C, self.f2_M - 1), dtype=torch.complex64, device=dev)
        demod = self.spec.demod
        if demod == "fm":
            ds = fm_init(self.C, device=dev)
        elif demod == "wfm":
            ds = wfm_init(self.C, self.wfm_geo, device=dev)
        elif self.spectrum_wide:
            ds = wide_init(self.wide_geo, device=dev)
        elif demod == "spectrum":
            ds = spectrum_init(self.C, self.spectrum_geo, device=dev)
        else:
            ds = linear_init(self.C, device=dev)
        return {"dc": dc, "demod": ds}

    # -- per-block device program -------------------------------------------
    def _channelize(self, params, F, d: int = 0):
        """Master spectrum F ([m_bins], or [B, ld] on an engine of B inputs)
        -> [C, olen] baseband (pre fine-tune): kernel A, or for a slice past
        _IDFT_BYTES of IDFT constant the FFT-IDFT form; the beamforming or
        the per-element channelizer where the tiled form does not apply.
        d: the shard (its device constants; 0 off a mesh)."""
        m, lc = self.master, self.lcs[d]
        inp = lc["inputs"]
        if self.spec.beam:
            return channelize_beam(F, params["responses"], params["shifts"], self.olen, m.N,
                                   params["beam_alpha"], params["beam_beta"], inputs=inp)
        if not self.tiled:
            return channelize(F, params["responses"], params["shifts"], self.olen, m.real, m.N,
                              inputs=inp)
        args = (F, params["resp_tiles"], params["tile_lo"], params["slope"], params["shifts"],
                lc["tile_E"], self.n_bins, self.olen, m.real, m.N)
        if lc["tile_E"] is None:
            return tiled_channelize(*args, inputs=inp)
        return cuda_channelize(*args, E_op=lc["tile_op"], inputs=inp)

    def _noise_est(self, params, F, d: int = 0):
        """N0 estimate from the master bins around each channel (kernel B)."""
        m = self.master
        return cuda_noise_est(F, params["shifts"], self.noise_bins, m.real, m.N, self.fs_in,
                              inputs=self.lcs[d]["inputs"])[0]

    def branch(self, host: dict, jobnum: int) -> tuple[str, "str | None"]:
        """This group's branch on one block from its host mirrors (host:
        {"warmup", "frames"}; jobnum: the block counter), as a letter: i a
        disarmed spectrum (computes nothing), w a wide spectrum, W the
        master's warm-up (N0 re-seeds), N N0 due, . N0 not due; beside it
        the reason the block cannot be graphed, or None (a spectrum group's
        first fft_avg frames weigh each by 1/(n+1) from the host's count,
        models/spectrum.py _fold_frames). The one place the branch is
        worked out: step dispatches on it, Engine.branch keys graphs by it."""
        why = None
        if self.sgeo is not None:
            if not self.host["armed"]:
                return "i", None
            if host["frames"] < self.sgeo.fft_avg:
                why = f"{self.spec.name}: spectrum warm-up (frame weights 1/(n+1))"
            if self.spectrum_wide:
                return "w", why
        if host["warmup"] > 0:
            return "W", why
        return "N" if jobnum % self.noise_every == 0 else ".", why

    def host_after(self, host: dict) -> dict:
        """This group's host mirrors after one block, the one rule they
        advance by: a disarmed spectrum group keeps them, a wide one counts
        its frames, the rest count down the warm-up (and a narrowband
        spectrum its frames)."""
        if self.sgeo is not None and not self.host["armed"]:
            return host
        new = dict(host) if self.spectrum_wide else dict(host, warmup=max(host["warmup"] - 1, 0))
        if self.sgeo is not None:
            new["frames"] = host["frames"] + self.sgeo.frames_per_block
        return new

    def _wide(self, state, params, block, frames: int, d: int = 0):
        """A wide spectrum group's block: the raw block's windowed FFTs."""
        demod_state, pwr = wide_accumulate(state["demod"], block, self.wide_geo,
                                           self.lcs[d]["wide"], frames)
        bins = wide_extract(pwr, params["shifts"], self.master.N, self.wide_geo,
                            self.spec.bin_count)
        info = {"bin_data": bins, "baseband_power": bins.sum(-1),
                "n0": torch.zeros((self.C,), dtype=torch.float32, device=block.device)}
        return ({"dc": state["dc"], "demod": demod_state},
                torch.zeros((self.C, 0), dtype=torch.float32, device=block.device), info)

    def step(self, state, params, letters: str, frames: list, blocks: list, chan,
             stacked: bool = False):
        """len(letters) consecutive blocks of this group, each on the branch
        its letter names (branch()), in any placement. frames: the host's
        frame count a block; blocks: the raw blocks (a wide spectrum's
        input); chan(self, params, dues): the placement's (baseband, N0 or
        None) lists, a block's (the tails then run block after block on the
        first device) or, for a split group, a shard's (_split_tails).
        stacked: outputs [len(letters), ...] (step_time). Returns
        (new_state, audio, info), this process's rows on the engine's
        device."""
        mesh, rows, dev = self.mesh, self.rows, self.device
        n = rows.stop - rows.start
        lead = (len(letters),) if stacked else ()
        if letters[0] == "i":
            # poll-gated: a disarmed spectrum group computes nothing
            nb = self.spec.bin_count if self.spectrum_wide else self.sgeo.bin_count
            power = torch.zeros(lead + (n,), dtype=torch.float32, device=dev)
            n0 = state["dc"]["n0"] if mesh is None else state["dc"]["n0"].local_rows(dev)
            info = {"bin_data": torch.zeros(lead + (n, nb), dtype=torch.float32, device=dev),
                    "baseband_power": power,
                    "n0": power if self.spectrum_wide else n0.expand(lead + (n,))}
            return state, torch.zeros(lead + (n, 0), dtype=torch.float32, device=dev), info
        dues = [c != "." for c in letters]
        if self.split:
            return self._split_tails(state, params, letters[0], frames[0], *chan(self, params, dues))
        h = 0 if mesh is None else mesh.local[0]  # the first device's shard
        st, p = local_tree(state, h), local_tree(params, h)
        if not self.spectrum_wide:
            bb, n0 = chan(self, params, dues)
        outs = []
        for d, c in enumerate(letters):
            if self.spectrum_wide:
                st, audio, info = self._wide(st, p, blocks[d], frames[d], h)
            else:
                st, audio, info = self._demod_tail(st, p, bb[d], n0[d], dues[d], c == "W",
                                                   frames[d], h)
            outs.append((audio, info))
        if stacked:
            audio = torch.stack([o[0] for o in outs])
            info = {k: torch.stack([o[1][k] for o in outs]) for k in outs[0][1]}
        if n < self.C:  # a wide group's rows of this process, on a mesh of several
            info = {k: v[rows] if v.dim() >= 1 and v.shape[0] == self.C else v
                    for k, v in info.items()}
            audio = audio[rows]
        return (st if mesh is None else place_like(st, state, mesh)), audio, info

    def _split_tails(self, state, params, letter: str, frames: int, bb: list, n0: list):
        """The tails of one block of a group split over the mesh's channel
        axis, each shard on its own C/D rows of (bb, n0); the outputs of
        this process's rows joined on its first device, where egress
        compaction packs them."""
        mesh, dev = self.mesh, self.device
        outs = each(mesh, lambda d, b, n: self._demod_tail(
            local_tree(state, d), local_tree(params, d), b, n, letter != ".", letter == "W",
            frames, d, compact=False), bb, n0)
        new_state = reassemble(each(mesh, lambda d, o: o[0], outs), state, mesh)
        mine = [outs[d] for d in mesh.local]
        audio = torch.cat([o[1].to(dev) for o in mine])
        per = self.C // mesh.size
        info = {k: (torch.cat([o[2][k].to(dev) for o in mine])
                    if v.dim() >= 1 and v.shape[0] == per else v.to(dev))
                for k, v in mine[0][2].items()}
        if self.spec.egress_slots and audio.shape[1] > 0 and "send" in info:
            audio = self._compact(audio, info, self.rows.start)
        return new_state, audio, info

    def _chan_noise_mesh(self, params, Ff: list, due: bool) -> tuple[list, list]:
        """Kernels A and B on each device's local C/D rows of its whole
        spectrum Ff[d]: (baseband [C/D, olen], N0 [C/D] or None) a shard."""
        mesh = self.mesh
        lps = each(mesh, lambda d: local_tree(params, d))
        return (each(mesh, lambda d: self._channelize(lps[d], Ff[d], d)),
                each(mesh, lambda d: self._noise_est(lps[d], Ff[d], d)) if due
                else [None] * mesh.size)

    def _chan_noise_digit(self, params, spec, due: bool) -> tuple[list, list]:
        """The per-element and beamforming channelizers and their noise
        windows on a sharded master: DigitSpectrum's gathers (each device
        reads the bins it owns, one psum_scatter leaves its C/D rows), the
        responses, one batched inverse FFT a shard."""
        inputs = self.inputs_t
        if self.spec.beam:
            fd = spec.gather_beam(params["shifts"], self.n_bins, params["beam_alpha"],
                                  params["beam_beta"], inputs)
        else:
            fd = spec.gather(params["shifts"], self.n_bins, inputs)
        mesh = self.mesh
        bb = each(mesh, lambda d, f, r: finish_channelize(f * r, self.olen), fd.shards,
                  params["responses"].shards)
        if not due:
            return bb, [None] * len(bb)
        e = spec.gather_noise(params["shifts"], self.noise_bins, inputs)
        return bb, each(mesh, lambda d, x: estimate_noise(x, self.master.bins, self.fs_in),
                        e.shards)

    def _chan_noise_blocks(self, params, Fs: list, dues: list) -> tuple[list, list]:
        """Kernels A and B of a time-sharded group (replicated over the
        mesh): block d's on device d, on its own master spectrum Fs[d] (B
        where dues[d]); (baseband, N0 or None) a block on this process's
        first device. On a mesh of several processes each channelizes its
        own blocks, and one all-gather brings every block's to each."""
        mesh = self.mesh
        lps = each(mesh, lambda d: local_tree(params, d))
        bb = each(mesh, lambda d: self._channelize(lps[d], Fs[d], d))
        n0 = each(mesh, lambda d: self._noise_est(lps[d], Fs[d], d) if dues[d] else None)
        if mesh.multiproc:
            def stacked(xs):  # every block's [C, ...] on this process's first device
                return all_gather(each(mesh, lambda d, x: x[None], xs), mesh, 0)[mesh.local[0]]

            bb = list(stacked(bb))
            # a block off its N0 cadence sends zeros that nothing reads
            n0 = [n if dues[d] else None for d, n in enumerate(stacked(each(
                mesh, lambda d, n: torch.zeros((self.C,), dtype=torch.float32,
                                               device=mesh.devices[d]) if n is None else n,
                n0)))]
        return ([b.to(self.device) for b in bb],
                [None if n is None else n.to(self.device) for n in n0])

    def _demod_tail(self, state, params, bb, n0_est, due: bool, warm: bool, frames: int = 0,
                    d: int = 0, compact: bool = True):
        """N0 EMA on the cadence, fine-tune NCO, filter2 cascade, demod (a
        fused_tail group: all but the EMA as the linear_tail kernel).
        frames: a narrowband spectrum group's host frame count; d: the shard
        (its device constants); compact=False leaves egress compaction to
        the caller (a split group compacts its whole output)."""
        prev_n0 = state["dc"]["n0"]
        if not due:
            n0 = prev_n0
        elif warm:
            n0 = n0_est
        else:
            alpha = float(np.float32(self.noise_alpha))
            n0 = torch.where(prev_n0 <= 0, n0_est, prev_n0 + alpha * (n0_est - prev_n0))

        spec, lc = self.spec, self.lcs[d]
        C = bb.shape[0]
        new_dc = {"acc_q32": None, "n0": n0,
                  "warmup": torch.clamp(state["dc"]["warmup"] - 1, min=0)}
        if self.fused_tail:
            # fine tune to muted audio in one kernel (its CPU path: the chain)
            new_dc["acc_q32"], bb_power, demod_state, audio, info = cuda_linear_tail(
                bb, state["dc"]["acc_q32"], params["inc_q32"], params["adj_q32"], n0,
                state["demod"], params["demod"], samprate=spec.samprate,
                blocktime=self.blocktime)
        else:
            bb, new_dc["acc_q32"] = fine_tune(bb, state["dc"]["acc_q32"], params["inc_q32"],
                                              params["adj_q32"])
            if self.f2_N:
                # filter2 cascade (radio.c:1543-1554): a second overlap-save
                # stage at the output rate, exact passband edges
                buf = torch.cat([state["dc"]["tail2"], bb], dim=1)  # [C, f2_N]
                new_dc["tail2"] = buf[:, self.f2_L:]
                fd = torch.fft.fft(buf) * params["responses2"]
                if self.spec.isb:
                    fd = isb_unpack(fd)  # LSB/USB -> I/Q (filter.c:862-876)
                bb = torch.fft.ifft(fd)[:, self.f2_N - self.olen:]
            bb_power = (bb.real * bb.real + bb.imag * bb.imag).mean(-1)
            if spec.demod == "fm":
                demod_state, audio, info = fm_demod(
                    state["demod"], bb, bb_power, n0, params["demod"],
                    samprate=spec.samprate, blocktime=self.blocktime, ctcss=spec.ctcss)
            elif spec.demod == "wfm":
                demod_state, audio, info = wfm_demod(
                    state["demod"], bb, bb_power, n0, params["demod"], self.wfm_geo, lc["wfm"])
            elif spec.demod == "spectrum":
                demod_state, pwr = spectrum_accumulate(state["demod"], bb, self.spectrum_geo,
                                                       lc["spectrum"], frames)
                audio = torch.zeros((C, 0), dtype=torch.float32, device=bb.device)
                info = {"bin_data": pwr}
            else:
                demod_state, audio, info = linear_demod(
                    state["demod"], bb, bb_power, n0, params["demod"],
                    samprate=spec.samprate, blocktime=self.blocktime,
                    enable_pll=spec.enable_pll, envelope=spec.envelope, stereo=spec.stereo)
        info["baseband_power"] = bb_power
        info["n0"] = n0
        if compact and spec.egress_slots and audio.shape[1] > 0 and "send" in info:
            audio = self._compact(audio, info)
        return {"dc": new_dc, "demod": demod_state}, audio, info

    def _compact(self, audio, info, base: int = 0):
        """Squelch-gated egress compaction (audio.c:42-110): the open
        channels' audio rows, in channel order, into K = egress_slots rows,
        with egress_idx [K] (channel of each row, -1 past the count) and
        egress_count (open channels; above K means the extras were dropped
        this block). No device->host sync: muted and overflowing channels
        scatter into a dump slot K, which is then sliced off. audio holds
        the channel rows from `base` on (a process's rows of a split group,
        each process compacting its own into K slots)."""
        C = audio.shape[0]
        K = min(int(self.spec.egress_slots), C)
        act = info["send"].to(torch.int32)
        pos = torch.cumsum(act, 0) - 1
        slot = torch.where(info["send"], torch.clamp(pos, max=K), K).to(torch.int64)
        idx = torch.full((K + 1,), -1, dtype=torch.int32, device=audio.device)
        idx.scatter_(0, slot, torch.arange(base, base + C, dtype=torch.int32, device=audio.device))
        idx = idx[:K]
        info["egress_idx"] = idx
        info["egress_count"] = act.sum(dtype=torch.int32)
        return audio.index_select(0, torch.clamp(idx - base, min=0).to(torch.int64))


class Engine:
    """radiod-equivalent: master FFT + all channel groups, one step per block.

    Usage:
        eng = Engine(samprate=129_600_000, real=True, groups=[...])  # on CUDA
        state, params = eng.init_state(), eng.init_params()
        state, out = eng.step(state, params, block)   # block: [L] samples

    device: None runs on CUDA and raises where there is none; "cpu" runs
    the plain PyTorch versions of the kernels. n_inputs=B serves B
    same-geometry front-end streams: step then takes [B, L] blocks.

    mesh (parallel.make_mesh): the sharded engine. The master FFT runs as
    the distributed digit-order transform (parallel/master.py), each group's
    channels split into C/D rows a device, and step returns the outputs
    whole on the mesh's first device (on a mesh of several processes, each
    process's own rows on its first device). time_shards=D (with a mesh of
    D devices) instead runs D consecutive blocks a dispatch, one a device,
    through step_time. State and params are then trees of Sharded leaves.

    Each group's branch on a block (disarmed or wide spectrum, the master's
    warm-up, N0 due or not) is _Group.branch's letter: branch() spells a
    dispatch's letters as its compiled graph's key (runtime/graphs.py), the
    steps dispatch on the same letters (_step_groups), and the host mirrors
    advance only by advance_host.
    """

    def __init__(self, samprate: float, groups: Sequence[GroupSpec], real: bool = True,
                 blocktime: float = 0.02, overlap: int = 5,
                 center: float | Sequence[float] = 0.0, noise_every: int = 4,
                 spurs: Sequence[float] | None = None, fft: str = "auto",
                 fft_precision: str = "high", use_matmul: bool = False, n_inputs: int = 1,
                 device=None, mesh: Mesh | None = None, shard_axis: str = "c",
                 time_shards: int = 0, use_tiled: bool = True):
        """The JAX engine's keywords, where this port has their mechanism.
        fft "auto" or "monolithic" and fft_precision "high" or "exact" run
        cuFFT in FP32 (torch.fft); the MXU cascade and four-step split
        (fft "mxu"/"split"), its bf16 tier and the MXU matmul channelizer
        (use_matmul) are TPU mechanisms and raise. spurs: RF frequencies to
        notch adaptively on the master bins (DC always with them), on every
        input. n_inputs: the number of front-end streams (the reference
        needs one host per SDR); center: the front-end centre, one for all
        inputs or one per input. mesh, shard_axis, time_shards: the class
        docstring; with a mesh the engine lives on its devices (a device
        given beside it must be of the same type). use_tiled=False puts
        every group on the per-element channelizer (a gather and cuFFT, no
        kernel A), as JAX's does."""
        fft, fft_precision = str(fft).lower(), str(fft_precision).lower()
        if fft in ("mxu", "split"):
            raise ValueError(f"fft={fft!r} picks the TPU's matmul-cascade master FFT; the port's "
                             "master FFT is cuFFT (use fft=auto)")
        if fft not in ("auto", "monolithic"):
            raise ValueError(f"fft={fft!r}: expected auto|monolithic")
        if fft_precision == "bf16":
            raise ValueError("fft_precision='bf16' is a precision tier of the TPU's matmul "
                             "cascade; the port's cuFFT runs in FP32 (use high or exact)")
        if fft_precision not in ("high", "exact"):
            raise ValueError(f"fft_precision={fft_precision!r}: expected high|exact")
        if use_matmul:
            raise ValueError("use_matmul (matmul = yes) picks the TPU's MXU matmul channelizer; "
                             "the port's channelizer is its CUDA kernel")
        self.mesh = mesh
        self.shard_axis = shard_axis
        self.time_shards = int(time_shards)
        if self.time_shards:
            if mesh is None:
                raise ValueError("time_shards needs a mesh")
            if self.time_shards != mesh.shape[shard_axis]:
                raise ValueError(f"time_shards={time_shards} != mesh axis size "
                                 f"{mesh.shape[shard_axis]} (one block per device)")
        if mesh is not None:
            if device is not None and torch.device(device).type != mesh.home.type:
                raise ValueError(f"device={device} with a mesh of {mesh.home.type} devices")
            device = mesh.home
        self.device = resolve_device(device)
        self.master = MasterConfig.from_rate(samprate, blocktime, overlap, real)
        self.samprate = float(samprate)
        self.blocktime = blocktime
        self.n_inputs = int(n_inputs)
        if self.n_inputs < 1:
            raise ValueError(f"n_inputs={n_inputs}: need at least one input")
        if np.ndim(center) == 0:
            self.centers = [float(center)] * self.n_inputs
        else:
            self.centers = [float(c) for c in center]
            if len(self.centers) != self.n_inputs:
                raise ValueError(f"{len(self.centers)} centers for {self.n_inputs} inputs")
        self.center = self.centers[0]
        self.ld = -(-self.master.bins // _CTILE) * _CTILE  # master_step's row stride
        self.noise_every = max(1, int(noise_every))
        names = [g.name for g in groups]
        if len(set(names)) != len(names):
            raise ValueError("duplicate group names")
        for g in groups:
            if not 0 <= g.input < self.n_inputs:
                raise ValueError(f"group {g.name}: input {g.input} outside the engine's "
                                 f"{self.n_inputs} front-end stream(s)")
            for c in g.channels:
                if c.input is not None and not 0 <= c.input < self.n_inputs:
                    raise ValueError(f"group {g.name}: channel input {c.input} outside "
                                     f"{self.n_inputs} stream(s)")
        # the channel-sharded engine: the distributed master (a split that
        # does not fit raises) and every group split into C/D rows
        self.digit = None
        split = mesh is not None and not self.time_shards
        if split:
            from ..parallel.master import DigitMaster

            D = mesh.shape[shard_axis]
            for g in groups:
                if len(g.channels) % D:
                    raise ValueError(f"group {g.name}: C={len(g.channels)} not divisible by mesh "
                                     f"size {D} (pad the channel list for even sharding)")
            self.digit = DigitMaster.plan(mesh, shard_axis, self.master.N, real=self.master.real,
                                          precision=fft_precision)
        # column-layout master tail: when the block advance L and the tail
        # N-L are whole [*, n2] rows, the sample matrix is carried already in
        # the four-step transform's column layout and the first corner turn
        # leaves the per-block path (DigitMaster.fft_natural cols_in).
        # Flagship: L = 1,440 rows, tail = 360 rows of n2 = 1,800.
        self.digit_cols = (self.digit is not None
                           and self.master.L % self.digit.n2 == 0
                           and (self.master.N - self.master.L) % self.digit.n2 == 0)
        self.groups = {g.name: _Group(g, self.master, self.samprate, blocktime, self.centers,
                                      self.noise_every, self.device, mesh=mesh, split=split,
                                      use_tiled=use_tiled)
                       for g in groups}
        # blocks from a fresh state before the branches repeat on the N0
        # cadence alone (GraphStep.prepare): the master's warm-up, then the
        # longest spectrum frame warm-up
        self.warmup_blocks = 2 + max((-(-g.sgeo.fft_avg // g.sgeo.frames_per_block)
                                      for g in self.groups.values() if g.sgeo is not None),
                                     default=0)
        # adaptive spur notches on master bins (radio.c:662-683,
        # filter.c:441-453): per spur, a slow complex one-pole tracks the
        # coherent bin value and subtracts it; DC always included
        self.spur_bins = None
        if spurs:
            bins = [0]
            for f in spurs:
                shift, _rem, ok = compute_tuning(self.master.N, self.samprate, abs(float(f)))
                if ok and abs(shift) < self.master.bins and shift not in bins:
                    bins.append(abs(shift))
            self.spur_bins = np.asarray(sorted(set(bins)), np.int32)
            self._spur_idx = torch.as_tensor(self.spur_bins.astype(np.int64), device=self.device)
            if self.time_shards:
                self._spur_idx_d = Sharded.replicate(self._spur_idx, mesh).shards
            if self.digit is not None:
                self._spur_plan = self.digit.spur_plan(self.spur_bins)

    @property
    def L(self) -> int:
        return self.master.L

    @property
    def specs(self) -> list[GroupSpec]:
        return [g.spec for g in self.groups.values()]

    def init_state(self):
        """The carried state; an engine of B inputs carries [B, M-1] master
        tails and [B, spurs] spur trackers. On a mesh, a tree of Sharded
        leaves (shard_engine_tree); a column-layout engine carries its
        master tail as [(N-L)/n2, n2] rows split over their columns."""
        mst = master_init(self.master, device=self.device)
        if self.digit_cols:
            mst["tail"] = mst["tail"].reshape(-1, self.digit.n2)
        lead = (self.n_inputs,) if self.n_inputs > 1 else ()
        mst["tail"] = mst["tail"].expand(lead + mst["tail"].shape).clone()
        st = {
            "master": mst,
            "groups": {n: g.init_state() for n, g in self.groups.items()},
            "host": {"jobnum": 0,
                     "groups": {n: {"warmup": 2, "frames": 0} for n in self.groups}},
        }
        if self.spur_bins is not None:
            st["spurs"] = torch.zeros(lead + (len(self.spur_bins),), dtype=torch.complex64,
                                      device=self.device)
        if self.mesh is not None:
            st = shard_engine_tree(self, self.mesh, st)
        return st

    def init_params(self):
        return {n: g.params for n, g in self.groups.items()}

    def advance_host(self, host: dict) -> dict:
        """The state's host mirrors after one block (_Group.host_after),
        computed on the host alone: how every step advances them, and what
        a compiled step (runtime/graphs.py) returns beside the state its
        graph wrote."""
        return {"jobnum": host["jobnum"] + 1,
                "groups": {n: g.host_after(host["groups"][n]) for n, g in self.groups.items()}}

    def _walk(self, host: dict, blocks: int) -> tuple[list, list, "str | None"]:
        """The host mirrors before each of `blocks` blocks from `host` and
        after the last, each block's branch spelt a letter a group in the
        engine's order (_Group.branch), and the first reason a block cannot
        be graphed (None)."""
        hosts, spelt, why = [host], [], None
        for _ in range(blocks):
            letters = ""
            for n, g in self.groups.items():
                c, w = g.branch(host["groups"][n], host["jobnum"])
                letters += c
                why = why or w
            spelt.append(letters)
            host = self.advance_host(host)
            hosts.append(host)
        return hosts, spelt, why

    def branch(self, host: dict, blocks: int = 1) -> tuple:
        """(key, None) for `blocks` blocks from the host mirrors `host`, or
        (None, reason) where a block cannot be graphed. The key spells each
        block's branch, a letter a group in the engine's order
        (_Group.branch), "/" between blocks: the letters the steps dispatch
        on, so a graph keyed by it holds the launches of the branch it
        names."""
        _, spelt, why = self._walk(host, blocks)
        return (None, why) if why else ("/".join(spelt), None)

    def retune(self, params, group: str, idx: int, freq: float):
        """Retune one channel in place; returns params (nothing rebuilt)."""
        self.groups[group].retune(params[group], idx, freq)
        return params

    def set_edges(self, params, group: str, idx: int, low: float, high: float,
                  kaiser_beta=None, filter2_kaiser_beta=None):
        """Redesign one channel's filter in place (filter2_kaiser_beta: the
        filter2 cascade's stage); returns params (nothing rebuilt)."""
        self.groups[group].set_edges(params[group], idx, low, high, kaiser_beta,
                                     filter2_kaiser_beta)
        return params

    def set_armed(self, params, group: str, armed: bool):
        """Arm or disarm a spectrum group; returns params."""
        self.groups[group].set_armed(params[group], armed)
        return params

    def adopt_host_params(self, old: "Engine"):
        """Copy the per-channel host params a previous engine's commands
        tweaked into this one (the channel-table rebuild path): groups of
        the same name keep their leading rows. Returns this engine's device
        params, the adopted host mirrors written into them in place, so
        that a compiled step (runtime/graphs.py) captured on them before
        the swap reads the adopted rows."""
        for name, g in self.groups.items():
            og = old.groups.get(name)
            if og is None:
                continue
            n = min(g.C, og.C)
            for key in ("shifts", "inc_q32", "adj_q32", "responses", "resp_tiles", "tile_lo",
                        "slope", "responses2"):
                if (key in g.host and key in og.host
                        and g.host[key].shape[1:] == og.host[key].shape[1:]):
                    g.host[key][:n] = og.host[key][:n]
            if g.tiled and ("resp_tiles" not in og.host
                            or g.host["resp_tiles"].shape[1:] != og.host["resp_tiles"].shape[1:]):
                for i in range(n):
                    g._refresh_tile_row(i)
            for key, arr in g.host["demod"].items():
                o = og.host["demod"].get(key)
                if o is not None and arr.shape[1:] == o.shape[1:]:
                    arr[:n] = o[:n]
            _copy_leaves(g.params, g.host)
        return self.init_params()

    def master_step(self, mstate, block: torch.Tensor):
        """The master FFT of one block: (new master state, F). F is [bins],
        or for B inputs [B, ld]: each row padded to whole 128-bin tiles (the
        JAX package's padded tile layout), so that every row starts 16-byte
        aligned for the kernels' loads."""
        mstate, F = master_fft(self.master, mstate, block)
        return mstate, self._pad_rows(F)

    def _pad_rows(self, F: torch.Tensor) -> torch.Tensor:
        if self.n_inputs > 1:
            return torch.nn.functional.pad(F[..., :self.master.bins],
                                           (0, self.ld - self.master.bins))
        return F

    def _frontend(self, block: torch.Tensor) -> torch.Tensor:
        """Per-input mean input power of [..., L] blocks."""
        p_in = block.real * block.real
        if not self.master.real:
            p_in = p_in + block.imag * block.imag
        return p_in.mean(-1)

    def step(self, state, params, block: torch.Tensor):
        """One block: [L] input samples ([B, L] for an engine of B inputs)
        -> per-group audio + status info."""
        if self.time_shards:
            raise ValueError("a time-sharded engine runs D blocks a dispatch: use step_time")
        if self.mesh is not None:
            return self._step_mesh(state, params, block)
        mstate, F = self.master_step(state["master"], block)
        new_state = {"master": mstate}
        if self.spur_bins is not None:
            # F is this block's own tensor: notch it in place, every input
            vals = F.index_select(-1, self._spur_idx)
            new_state["spurs"] = state["spurs"] + _SPUR_ALPHA * (vals - state["spurs"])
            F.index_add_(-1, self._spur_idx, -new_state["spurs"])

        def chan(g, p, dues):  # the whole F goes in
            return [g._channelize(p, F)], [g._noise_est(p, F) if dues[0] else None]

        return self._step_groups(state, params, [block], chan, new_state)

    def _step_groups(self, state, params, blocks: list, chan, new_state: dict):
        """The groups' part of step, _step_mesh and step_time over the blocks
        ([L] or [B, L] each): every group through _Group.step on the
        letters and frame counts of the host walk that keys a compiled
        dispatch, with the placement's chan; the front-end powers; and
        new_state completed with the groups' states and the advanced host
        mirrors. Returns (new_state, outputs)."""
        hosts, spelt, _ = self._walk(state["host"], len(blocks))
        stacked = bool(self.time_shards)
        groups, outputs = {}, {}
        for i, (name, g) in enumerate(self.groups.items()):
            groups[name], audio, info = g.step(
                state["groups"][name], params[name], "".join(s[i] for s in spelt),
                [h["groups"][name]["frames"] for h in hosts[:-1]],
                [b[g.spec.input] for b in blocks] if self.n_inputs > 1 else blocks, chan, stacked)
            outputs[name] = {"audio": audio, "info": info}
        # front-end metrics (frontend->if_power smoothing, rx888.c contract):
        # [B] per-input powers, [1] for one input; [D, ...] time-sharded
        fe = [self._frontend(b).reshape(-1) for b in blocks]
        outputs["_frontend"] = {"if_power": torch.stack(fe) if stacked else fe[0]}
        new_state.update(groups=groups, host=hosts[-1])
        return new_state, outputs

    def _step_mesh(self, state, params, block):
        """step() of the channel-sharded engine. The master runs as the
        distributed digit-order transform: the sample matrix (carried in
        its column layout where the geometry allows) through two corner
        turns; the spur trackers read and notch the digit rows; then, for
        the groups of the tiled channelizer, the final corner turn and ONE
        all-gather give every device the natural-order spectrum, which
        kernels A and B read on each device's local channel rows. The other
        groups read the digit rows through DigitSpectrum's gathers. The
        outputs come back whole on the first device (a process's own rows on
        a mesh of several)."""
        from ..parallel.master import DigitSpectrum

        mesh, dm, m = self.mesh, self.digit, self.master
        dev0 = mesh.home
        state = shard_engine_tree(self, mesh, state)
        params = shard_engine_tree(self, mesh, params)
        block = torch.as_tensor(block).to(dev0)
        tail = state["master"]["tail"]
        if self.digit_cols:
            # tail carried as whole [*, n2] rows in the column layout: the
            # concat is a row append, the first corner turn is skipped, and
            # the new tail is a row slice that keeps the column split
            n2 = dm.n2
            blk = Sharded.split(block.reshape(block.shape[:-1] + (m.L // n2, n2)), mesh, -1)
            xs = each(mesh, lambda d, t, b: torch.cat([t, b.to(t.dtype)], dim=-2), tail.shards,
                      blk.shards)
            new_tail = Sharded(each(mesh, lambda d, x: x[..., m.L // n2:, :].contiguous(), xs), -1,
                               mesh)
            Cs = dm.digit_rows(Sharded(xs, -1, mesh), cols_in=True)
        else:
            x = torch.cat([tail.first, block.to(tail.dtype)], dim=-1)
            new_tail = Sharded.replicate(x[..., m.L:].contiguous(), mesh)
            Cs = dm.digit_rows(x)
        jn = state["master"]["jobnum"].first
        new_state = {"master": {"tail": new_tail, "jobnum": Sharded.replicate(jn + 1, mesh)}}
        if self.spur_bins is not None:
            vals = dm.take(Cs, self._spur_idx, scatter=False).first
            prev = state["spurs"].first
            new_state["spurs"] = Sharded.replicate(prev + _SPUR_ALPHA * (vals - prev), mesh)
            dm.notch(Cs, self.spur_bins, new_state["spurs"], plan=self._spur_plan)
        Ff = None
        if any(g.tiled for g in self.groups.values()):
            nat = all_gather(dm.natural(Cs), mesh, dim=-1)
            ready: dict = {}  # one spectrum a distinct device
            for d in mesh.local:
                if id(nat[d]) not in ready:
                    ready[id(nat[d])] = (self._pad_rows(nat[d]) if self.n_inputs > 1
                                         else nat[d][..., :m.bins])
            Ff = each(mesh, lambda d, f: ready[id(f)], nat)
        spec = DigitSpectrum(dm, Cs, m.real)

        def chan(g, p, dues):
            if g.tiled:
                return g._chan_noise_mesh(p, Ff, dues[0])
            return g._chan_noise_digit(p, spec, dues[0])

        return self._step_groups(state, params, [block], chan, new_state)

    def step_time(self, state, params, blocks):
        """D consecutive blocks in one dispatch, one block a mesh device: the
        masters run at once with the (M-1)-sample halo passed to the next
        device (parallel.timeshard, replacing the reference's mirror ring,
        filter.c:245-264); the spur trackers carry across the D blocks;
        each block's channelizer and N0 estimate run on its own device; the
        stateful demodulator tails run block after block. Equals D step()
        calls of a single-device engine.

        blocks: [D, L] ([D, B, L] with B inputs), a tensor or a Sharded
        split over blocks; outputs carry a leading [D] axis, whole on the
        first device (on each process's first device, on a mesh of
        several)."""
        from ..parallel.timeshard import batch_master_fft

        if not self.time_shards:
            raise ValueError("engine built without time_shards")
        mesh, m = self.mesh, self.master
        D, dev0 = mesh.size, mesh.home
        state = shard_engine_tree(self, mesh, state)
        params = shard_engine_tree(self, mesh, params)
        tail, F = batch_master_fft(m, state["master"]["tail"], blocks, mesh, self.shard_axis)
        Fs = each(mesh, lambda d, f: self._pad_rows(f[0]), F.shards)
        jn = state["master"]["jobnum"].first
        new_state = {"master": {"tail": tail, "jobnum": Sharded.replicate(jn + D, mesh)}}
        if self.spur_bins is not None:
            # the trackers carry block after block (filter.c:447): every
            # block's spur bins, then the D trackers, then each notch
            vals = all_gather(each(mesh, lambda d, f: f.index_select(-1, self._spur_idx_d[d])[None],
                                   Fs), mesh, 0)[mesh.local[0]].to(dev0)
            tr, trs = state["spurs"].first, []
            for d in range(D):
                tr = tr + _SPUR_ALPHA * (vals[d] - tr)
                trs.append(tr)
            for d in mesh.local:
                Fs[d].index_add_(-1, self._spur_idx_d[d], -trs[d].to(Fs[d].device))
            new_state["spurs"] = Sharded.replicate(tr, mesh)
        if isinstance(blocks, Sharded):
            blks = list(blocks.full(dev0))  # every block: a collective across processes
        else:
            blks = list(torch.as_tensor(blocks).to(dev0))
        return self._step_groups(state, params, blks,
                                 lambda g, p, dues: g._chan_noise_blocks(p, Fs, dues), new_state)


def migrate_state(old_state, new_state):
    """Merge a previous engine's carried state into a fresh one after a
    channel-table rebuild (the reference's dynamic create_chan,
    radio_status.c:92-105): groups of the same name keep their leading
    [C_old] rows (master tail, AGC gains, squelch state, phase
    accumulators), new rows keep their initial values. The host mirrors
    carry too: the block counter, and each surviving group's warm-up and
    frame counts. Sharded trees (a mesh engine's) merge by their whole
    values and come back placed as the new state's leaves."""
    def merge_leaf(old, new):
        if old.shape == new.shape:
            return old.to(new.dtype)
        if old.dim() == new.dim() >= 1 and old.shape[1:] == new.shape[1:]:
            if new.shape[0] > old.shape[0]:
                out = new.clone()
                out[: old.shape[0]] = old.to(new.dtype)
                return out
            return old[: new.shape[0]].to(new.dtype)
        return new

    def merge(old, new):
        if isinstance(new, dict):
            return {k: merge(old.get(k), v) if isinstance(old, dict) else v
                    for k, v in new.items()}
        if isinstance(new, Sharded):
            if (isinstance(old, Sharded) and old.mesh is new.mesh and old.dim == new.dim
                    and old.shape == new.shape and old.dtype == new.dtype):
                return old
            if not (torch.is_tensor(old) or isinstance(old, Sharded)):
                return new
            o = old.full() if isinstance(old, Sharded) else old
            n = new.full()
            return new.like(merge_leaf(o.to(n.device), n))
        if isinstance(old, Sharded):
            old = old.full(new.device)
        if not torch.is_tensor(old) or not torch.is_tensor(new):
            return new
        return merge_leaf(old, new)

    out = merge({k: v for k, v in old_state.items() if k != "host"},
                {k: v for k, v in new_state.items() if k != "host"})
    old_host, new_host = old_state["host"], new_state["host"]
    out["host"] = {"jobnum": old_host["jobnum"],
                   "groups": {n: dict(old_host["groups"].get(n, h))
                              for n, h in new_host["groups"].items()}}
    return out
