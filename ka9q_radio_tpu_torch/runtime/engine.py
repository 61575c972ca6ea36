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
host copy of `armed`), so no block reads a device value back to the host.
The state tensors keep the same values as the JAX engine's.

Per-block per-group pipeline (downconvert(), radio.c:1451-1562):
  master FFT (torch.fft, cuFFT on the card)
  -> tiled channelizer (CUDA kernel, ops/cuda_channelize.py)
  -> N0 estimate on its cadence (CUDA kernel) + EMA smoothing
  -> fine-tune Q32 NCO + Renfors block phase adjustment
  -> linear (SSB) demodulator; or, for a wide spectrum group, windowed FFTs
     of the raw block averaged into bins.

This slice runs one device and one input: the linear SSB path and the wide
spectrum. FM/WFM, PLL/envelope/stereo linear, the narrowband spectrum,
filter2/ISB, beamforming, egress compaction, spur notches, multiple inputs
and meshes are later slices and raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from ..ops.cuda_channelize import channelize_operand, cuda_channelize, cuda_noise_est
from ..ops.filter_design import design_bandpass_response, response_to_device_order
from ..ops.filterbank import (
    _CTILE,
    MasterConfig,
    block_phase_adjust_q32,
    build_tile_params,
    compute_tuning,
    fine_tune,
    master_fft,
    master_init,
    tile_plan,
    tiled_idft_matrix,
)
from ..ops.noise import MIN_NOISE_BINS, POWER_ALPHA, noise_window_fits
from ..ops.osc import rev_to_q32
from ..models.linear import check_linear_flags, linear_demod, linear_init
from ..models.spectrum import wide_accumulate, wide_constants, wide_extract, wide_geometry, wide_init
from ..utils.device import resolve_device, to_tensors
from ..utils.units import dB_to_power, dB_to_voltage

__all__ = ["ChannelSpec", "GroupSpec", "Engine", "DEFAULTS"]

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


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is a later slice of the port")


class _Group:
    """Host-side geometry, host mirrors and device params of one GroupSpec."""

    def __init__(self, spec: GroupSpec, master: MasterConfig, samprate: float, blocktime: float,
                 center: float, noise_every: int, device: torch.device):
        self.spec = spec
        self.master = master
        self.fs_in = samprate
        self.blocktime = blocktime
        self.center = float(center)
        self.device = device
        if spec.demod not in ("linear", "spectrum"):
            raise _later(f"the {spec.demod} demodulator")
        if spec.demod == "linear":
            check_linear_flags(spec.enable_pll, spec.envelope, spec.stereo)
        if spec.filter2 > 0 or spec.isb:
            raise _later("the filter2/ISB cascade")
        if spec.beam:
            raise _later("beamforming")
        if spec.egress_slots:
            raise _later("egress compaction (the daemon)")
        if spec.input != 0 or any(c.input not in (None, 0) for c in spec.channels):
            raise _later("multi-input")
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
        self.noise_bins = int(min(master.bins, max(self.n_bins, MIN_NOISE_BINS)))
        # N0 re-estimates every `noise_every`-th block (warm-up blocks always),
        # with the EMA coefficient compounded to keep the time constant
        self.noise_every = max(1, int(noise_every))
        self.noise_alpha = float(1.0 - (1.0 - POWER_ALPHA) ** self.noise_every)
        self.spectrum_wide = False
        if spec.demod == "spectrum":
            # algorithm crossover (spectrum.c, modes.c:69)
            self.spectrum_wide = spec.bin_bw >= spec.crossover
            if not self.spectrum_wide:
                raise _later("the narrowband spectrum")
            self.wide_geo = wide_geometry(
                self.fs_in, master.L, master.real, spec.bin_bw, spec.spectrum_window,
                spec.spectrum_window_param, spec.fft_avg, spec.spectrum_overlap)
            self.wide_consts = wide_constants(self.wide_geo, device)
        # every linear group takes the tiled channelizer (the CUDA kernel);
        # the per-element gather paths are a later slice
        self.tiled = spec.demod == "linear"
        if self.tiled:
            S = tile_plan(self.n_bins) * _CTILE
            if not (master.real or N % _CTILE == 0) or self.n_bins * self.n_bins >= 2**31 \
                    or S * self.olen * 8 > (32 << 20):
                raise _later("the per-element and FFT-IDFT channelizers")
            if not noise_window_fits(self.noise_bins, master.real, N):
                raise _later("per-element noise windows (small or odd masters)")
            self.tile_E = torch.as_tensor(tiled_idft_matrix(self.n_bins, self.olen, S),
                                          device=device)
            # the channelizer kernel's form of tile_E (split real-block GEMM operand)
            self.tile_op = channelize_operand(self.tile_E, self.n_bins, self.olen)
        self.params = self._build_params()

    # -- retunable params ---------------------------------------------------
    def _tuning_arrays(self, freqs: np.ndarray):
        N, L, fs = self.master.N, self.master.L, self.fs_in
        shifts = np.zeros(self.C, np.int32)
        incs = np.zeros(self.C, np.int32)
        adjs = np.zeros(self.C, np.int32)
        for i, f in enumerate(freqs):
            shift, rem, ok = compute_tuning(N, fs, float(f) - self.center)
            if not ok:
                raise ValueError(f"freq {f} outside front-end coverage")
            shifts[i] = shift
            incs[i] = rev_to_q32(-rem / self.spec.samprate)
            adjs[i] = block_phase_adjust_q32(shift, L, N)
        return shifts, incs, adjs

    def _design_main(self, low: float, high: float) -> np.ndarray:
        r = self.spec.samprate
        lo, hi = min(low, high), max(low, high)
        return response_to_device_order(design_bandpass_response(
            self.n_bins, self.olen, lo / r, hi / r, kaiser_beta=self.spec.kaiser_beta,
            real_master=self.master.real, master_points=self.master.N))

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
        if spec.demod == "spectrum":
            # poll-gating flag (spectrum.c:161-186): 1 = accumulate this block
            p["armed"] = np.float32(1.0)
            p["demod"] = {}
        else:
            g_sq_open = opt("squelch_open_db", "squelch_open_db")
            g_sq_close = opt("squelch_close_db", "squelch_close_db")
            g_gain = opt("gain_db", "gain_db")
            r = spec.samprate
            C = self.C
            p["demod"] = {
                "bandwidth": f32([abs(c.high - c.low) for c in chans]),
                "headroom": f32(np.full(C, dB_to_voltage(opt("headroom_db", "headroom_db")))),
                "squelch_open": f32([dB_to_power(c.squelch_open_db if c.squelch_open_db is not None
                                                 else g_sq_open) for c in chans]),
                "squelch_close": f32([dB_to_power(c.squelch_close_db if c.squelch_close_db is not None
                                                  else g_sq_close) for c in chans]),
                "squelch_tail": i32(np.full(C, opt("squelch_tail", "squelch_tail"))),
                "snr_squelch_enable": np.full(C, spec.snr_squelch, bool),
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
            }
        self.host = p  # authoritative numpy mirrors for host-side surgery
        return to_tensors(p, self.device)

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
        shift, rem, ok = compute_tuning(N, fs, float(freq) - self.center)
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
            params["resp_tiles"][idx].copy_(torch.from_numpy(h["resp_tiles"][idx]))
        for k in keys:
            params[k][idx] = int(h[k][idx])
        return params

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
        demod = (wide_init(self.wide_geo, device=dev) if self.spectrum_wide
                 else linear_init(self.C, device=dev))
        return {"dc": dc, "demod": demod}

    # -- per-block device program -------------------------------------------
    def _channelize(self, params, F):
        """Master spectrum F -> [C, olen] baseband (pre fine-tune)."""
        m = self.master
        return cuda_channelize(F, params["resp_tiles"], params["tile_lo"], params["slope"],
                               params["shifts"], self.tile_E, self.n_bins, self.olen, m.real, m.N,
                               E_op=self.tile_op)

    def _noise_est(self, params, F):
        """N0 estimate from the master bins around each channel."""
        m = self.master
        return cuda_noise_est(F, params["shifts"], self.noise_bins, m.real, m.N, self.fs_in)[0]

    def step(self, state, params, F, block, jobnum: int, host: dict):
        """One block for this group. jobnum: host block counter (before this
        block); host: this group's host mirrors {"warmup", "frames"}.
        Returns (new_state, audio, info, new_host)."""
        if self.spectrum_wide:
            if not self.host["armed"]:
                nb = self.spec.bin_count
                zeros = torch.zeros((self.C,), dtype=torch.float32, device=F.device)
                info = {"bin_data": torch.zeros((self.C, nb), dtype=torch.float32, device=F.device),
                        "baseband_power": zeros, "n0": zeros}
                return state, torch.zeros((self.C, 0), dtype=torch.float32, device=F.device), \
                    info, host
            demod_state, pwr = wide_accumulate(state["demod"], block, self.wide_geo,
                                               self.wide_consts, host["frames"])
            bins = wide_extract(pwr, params["shifts"], self.master.N, self.wide_geo,
                                self.spec.bin_count)
            info = {"bin_data": bins, "baseband_power": bins.sum(-1),
                    "n0": torch.zeros((self.C,), dtype=torch.float32, device=F.device)}
            new_host = dict(host, frames=host["frames"] + self.wide_geo.frames_per_block)
            return ({"dc": state["dc"], "demod": demod_state},
                    torch.zeros((self.C, 0), dtype=torch.float32, device=F.device), info, new_host)
        bb = self._channelize(params, F)
        warm = host["warmup"] > 0
        due = self.noise_every == 1 or warm or jobnum % self.noise_every == 0
        n0_est = self._noise_est(params, F) if due else None
        new_state, audio, info = self._demod_tail(state, params, bb, n0_est, due, warm)
        return new_state, audio, info, dict(host, warmup=max(host["warmup"] - 1, 0))

    def _demod_tail(self, state, params, bb, n0_est, due: bool, warm: bool):
        """N0 EMA on the cadence, fine-tune NCO, demod."""
        prev_n0 = state["dc"]["n0"]
        if not due:
            n0 = prev_n0
        elif warm:
            n0 = n0_est
        else:
            alpha = float(np.float32(self.noise_alpha))
            n0 = torch.where(prev_n0 <= 0, n0_est, prev_n0 + alpha * (n0_est - prev_n0))

        bb, acc = fine_tune(bb, state["dc"]["acc_q32"], params["inc_q32"], params["adj_q32"])
        bb_power = (bb.real * bb.real + bb.imag * bb.imag).mean(-1)
        spec = self.spec
        demod_state, audio, info = linear_demod(
            state["demod"], bb, bb_power, n0, params["demod"],
            samprate=spec.samprate, blocktime=self.blocktime)
        info["baseband_power"] = bb_power
        info["n0"] = n0
        new_dc = {"acc_q32": acc, "n0": n0,
                  "warmup": torch.clamp(state["dc"]["warmup"] - 1, min=0)}
        return {"dc": new_dc, "demod": demod_state}, audio, info


class Engine:
    """radiod-equivalent: master FFT + all channel groups, one step per block.

    Usage:
        eng = Engine(samprate=129_600_000, real=True, groups=[...])  # on CUDA
        state, params = eng.init_state(), eng.init_params()
        state, out = eng.step(state, params, block)   # block: [L] samples

    device: None runs on CUDA and raises where there is none; "cpu" runs
    the plain PyTorch versions of the kernels.
    """

    def __init__(self, samprate: float, groups: Sequence[GroupSpec], real: bool = True,
                 blocktime: float = 0.02, overlap: int = 5, center: float = 0.0,
                 noise_every: int = 4, device=None):
        self.device = resolve_device(device)
        self.master = MasterConfig.from_rate(samprate, blocktime, overlap, real)
        self.samprate = float(samprate)
        self.blocktime = blocktime
        self.center = float(center)
        self.noise_every = max(1, int(noise_every))
        names = [g.name for g in groups]
        if len(set(names)) != len(names):
            raise ValueError("duplicate group names")
        self.groups = {g.name: _Group(g, self.master, self.samprate, blocktime, self.center,
                                      self.noise_every, self.device)
                       for g in groups}

    @property
    def L(self) -> int:
        return self.master.L

    @property
    def specs(self) -> list[GroupSpec]:
        return [g.spec for g in self.groups.values()]

    def init_state(self):
        return {
            "master": master_init(self.master, device=self.device),
            "groups": {n: g.init_state() for n, g in self.groups.items()},
            "host": {"jobnum": 0,
                     "groups": {n: {"warmup": 2, "frames": 0} for n in self.groups}},
        }

    def init_params(self):
        return {n: g.params for n, g in self.groups.items()}

    def retune(self, params, group: str, idx: int, freq: float):
        """Retune one channel in place; returns params (nothing rebuilt)."""
        self.groups[group].retune(params[group], idx, freq)
        return params

    def set_armed(self, params, group: str, armed: bool):
        """Arm or disarm a spectrum group; returns params."""
        self.groups[group].set_armed(params[group], armed)
        return params

    def step(self, state, params, block: torch.Tensor):
        """One block: [L] input samples -> per-group audio + status info."""
        host = state["host"]
        jobnum = host["jobnum"]
        mstate, F = master_fft(self.master, state["master"], block)
        new_groups, outputs, host_groups = {}, {}, {}
        for name, g in self.groups.items():
            gs, audio, info, host_groups[name] = g.step(
                state["groups"][name], params[name], F, block, jobnum, host["groups"][name])
            new_groups[name] = gs
            outputs[name] = {"audio": audio, "info": info}
        # front-end metrics (frontend->if_power smoothing, rx888.c contract)
        p_in = block.real * block.real
        if not self.master.real:
            p_in = p_in + block.imag * block.imag
        outputs["_frontend"] = {"if_power": p_in.mean()[None]}
        new_state = {"master": mstate, "groups": new_groups,
                     "host": {"jobnum": jobnum + 1, "groups": host_groups}}
        return new_state, outputs
