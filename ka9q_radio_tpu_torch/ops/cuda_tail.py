"""Wrapper of the linear demodulator's tail kernel (csrc/linear_tail.cu).

  cuda_linear_tail  fine tune, bb_power, the CW shift, the AGC, mono I
                    detection and the SNR squelch of a linear group's block
                    (linear_tail)

A linear group without PLL, envelope, stereo or filter2 (usb, lsb, a cw
offset; runtime/engine.py `_Group.fused_tail`) runs its block from kernel
A's baseband to the muted audio as this one kernel, in place of the plain
chain's ~165 PyTorch launches a block. It is built and bound by
ops/cuda_channelize.py's loader and counted in its `launches`.

The wrapper given CPU tensors runs the plain version, `linear_tail_plain`:
ops/filterbank.py fine_tune, the mean |bb|^2 and models/linear.py
linear_demod, as the engine's chain runs them. Given CUDA tensors it
launches the kernel or raises; it never falls back.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.linear import linear_demod
from .cuda_channelize import _check, _launch
from .filterbank import fine_tune

__all__ = ["cuda_linear_tail", "linear_tail_plain"]

_I32, _F32, _B = torch.int32, torch.float32, torch.bool
# the kernel's [C] inputs after bb, in csrc/linear_tail.cu's In order:
# (where, key, dtype), where the fine tune's ("dc"), the AGC state's
# ("agc"), the demod state's ("state") or its params' ("params")
_TAIL_IN = (("dc", "acc_q32", _I32), ("dc", "inc_q32", _I32), ("dc", "adj_q32", _I32),
            ("dc", "n0", _F32), ("agc", "gain", _F32), ("agc", "hangcount", _I32),
            ("state", "shift_acc", _I32), ("state", "am_dc", _F32),
            ("state", "squelch_state", _I32), ("state", "squelch_open", _B),
            ("params", "agc_enable", _B), ("params", "headroom", _F32),
            ("params", "hangtime_samples", _I32), ("params", "recovery_per_sample", _F32),
            ("params", "threshold", _F32), ("params", "bandwidth", _F32),
            ("params", "manual_gain", _F32), ("params", "shift_inc_q32", _I32),
            ("params", "squelch_open", _F32), ("params", "squelch_close", _F32),
            ("params", "squelch_tail", _I32), ("params", "snr_squelch_enable", _B))
# its outputs, in Out order ("audio" is [C, N], the rest [C])
_TAIL_OUT = (("acc_q32", _I32), ("bb_power", _F32), ("gain", _F32), ("hangcount", _I32),
             ("shift_acc", _I32), ("am_dc", _F32), ("squelch_state", _I32),
             ("squelch_open", _B), ("audio", _F32), ("output_power", _F32), ("snr", _F32),
             ("send", _B), ("pll_lock", _B))


def linear_tail_plain(bb, acc_q32, inc_q32, adj_q32, n0, state, params, *, samprate: int,
                      blocktime: float):
    """The chain the kernel replaces: fine tune, the mean |bb|^2, then
    linear_demod without PLL, envelope or stereo. Returns (new acc_q32,
    bb_power, new demod state, audio [C, N], info)."""
    bb, acc = fine_tune(bb, acc_q32, inc_q32, adj_q32)
    bb_power = (bb.real * bb.real + bb.imag * bb.imag).mean(-1)
    st, audio, info = linear_demod(state, bb, bb_power, n0, params, samprate=samprate,
                                   blocktime=blocktime)
    return acc, bb_power, st, audio, info


def cuda_linear_tail(bb: torch.Tensor, acc_q32: torch.Tensor, inc_q32: torch.Tensor,
                     adj_q32: torch.Tensor, n0: torch.Tensor, state: dict, params: dict, *,
                     samprate: int, blocktime: float):
    """One block of a linear group's tail from bb [C, N] complex64 (kernel
    A's output, before the fine tune): acc_q32, inc_q32, adj_q32 [C] int32
    the fine-tune NCO, n0 [C] float32 the smoothed noise density, state the
    group's linear_init tree, params its demod params. Returns (new
    acc_q32, bb_power [C], new demod state, audio [C, N] float32 muted,
    info) with the keys, dtypes and shapes of linear_tail_plain (its plain
    version). The kernel takes rows up to 29,056 samples (8 N bytes of
    shared memory); its launch fails (cudaErrorInvalidValue) beyond."""
    if bb.device.type == "cpu":
        return linear_tail_plain(bb, acc_q32, inc_q32, adj_q32, n0, state, params,
                                 samprate=samprate, blocktime=blocktime)
    if bb.device.type != "cuda":
        raise ValueError(f"cuda_linear_tail takes CPU or CUDA tensors, not {bb.device}")
    C, N = bb.shape
    dev = bb.device
    if bb.dtype != torch.complex64:
        raise TypeError(f"bb has dtype {bb.dtype}, expected torch.complex64")
    # whole rows at any row stride: the per-element channelizer's baseband
    # is a column slice of its inverse FFT
    if bb.stride(1) != 1 or bb.stride(0) < N:
        raise ValueError("bb's rows must be contiguous")
    trees = {"dc": {"acc_q32": acc_q32, "inc_q32": inc_q32, "adj_q32": adj_q32, "n0": n0},
             "agc": state["agc"], "state": state, "params": params}
    ins = [bb]
    for where, key, dtype in _TAIL_IN:
        t = trees[where][key]
        _check(t, f"{where} {key}", dtype, (C,), dev)
        ins.append(t)
    out = {k: torch.empty((C, N) if k == "audio" else (C,), dtype=dt, device=dev)
           for k, dt in _TAIL_OUT}
    if C > 0:
        sps = min(max(int(round(N * 0.002 / blocktime)), 1), N)  # agc_block's sub-block
        _launch("linear_tail", dev, C, N, bb.stride(0), sps, max(N // sps, 1),
                int(round(0.08 * samprate)),
                float(np.float32(1.0 / N)), float(np.float32(1.0 / sps)),
                (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins]),
                (ctypes.c_void_p * len(out))(*[t.data_ptr() for t in out.values()]))
    st = dict(state, agc={"gain": out["gain"], "hangcount": out["hangcount"]})
    for k in ("shift_acc", "am_dc", "squelch_state", "squelch_open"):
        st[k] = out[k]
    info = {k: out[k] for k in ("pll_lock", "output_power", "snr", "squelch_state", "send",
                                "gain")}
    return out["acc_q32"], out["bb_power"], st, out["audio"], info
