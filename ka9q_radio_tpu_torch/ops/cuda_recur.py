"""Wrappers of the demodulators' per-sample recurrence kernels (csrc/recur.cu).

  cuda_pll_scan        the PLL of linear.c over a block (pll_scan)
  cuda_goertzel_block  the CTCSS Goertzel over a block (goertzel)

The JAX package runs both as lax.scan inside its jitted step; eager PyTorch
would run one Python iteration per sample, so each is one kernel with one
thread per channel. They are built and bound by ops/cuda_channelize.py's
loader and counted in its `launches`.

A wrapper given CPU tensors runs the plain version, the loop over samples
(models/linear.py `pll_scan_plain`, ops/iir.py `goertzel_update_block`).
Given CUDA tensors it launches its kernel or raises; it never falls back.
"""
from __future__ import annotations

import torch

from .cuda_channelize import _check, _launch
from .iir import goertzel_update_block

__all__ = ["cuda_pll_scan", "cuda_goertzel_block"]


def cuda_pll_scan(bb: torch.Tensor, pll: dict, k1: torch.Tensor, k2: torch.Tensor,
                  locked: torch.Tensor, square: torch.Tensor):
    """The PLL over one block: (mixed [C, T] complex64, new PLL state, sig
    [C], noi [C]) from bb [C, T] complex64, the PLL state (vco_phase int32,
    u, phi float32, wraps int32, each [C]), the loop constants k1, k2 [C]
    float32 and the locked and square flags [C] bool. Equals
    models.linear.pll_scan_plain (its plain version)."""
    if bb.device.type == "cpu":
        from ..models.linear import pll_scan_plain

        return pll_scan_plain(bb, pll, k1, k2, locked, square)
    if bb.device.type != "cuda":
        raise ValueError(f"cuda_pll_scan takes CPU or CUDA tensors, not {bb.device}")
    C, T = bb.shape
    dev = bb.device
    _check(bb, "bb", torch.complex64, (C, T), dev)
    for what, t, dt in (("k1", k1, torch.float32), ("k2", k2, torch.float32),
                        ("locked", locked, torch.bool), ("square", square, torch.bool),
                        ("vco_phase", pll["vco_phase"], torch.int32), ("u", pll["u"], torch.float32),
                        ("phi", pll["phi"], torch.float32), ("wraps", pll["wraps"], torch.int32)):
        _check(t, what, dt, (C,), dev)
    mixed = torch.empty((C, T), dtype=torch.complex64, device=dev)
    out = {"vco_phase": torch.empty_like(pll["vco_phase"]), "u": torch.empty_like(pll["u"]),
           "phi": torch.empty_like(pll["phi"]), "wraps": torch.empty_like(pll["wraps"])}
    sig = torch.empty(C, dtype=torch.float32, device=dev)
    noi = torch.empty(C, dtype=torch.float32, device=dev)
    if C == 0:
        return mixed, out, sig, noi
    _launch("pll_scan", dev, bb.data_ptr(), C, T, k1.data_ptr(), k2.data_ptr(),
            locked.data_ptr(), square.data_ptr(), pll["vco_phase"].data_ptr(),
            pll["u"].data_ptr(), pll["phi"].data_ptr(), pll["wraps"].data_ptr(),
            mixed.data_ptr(), out["vco_phase"].data_ptr(), out["u"].data_ptr(),
            out["phi"].data_ptr(), out["wraps"].data_ptr(), sig.data_ptr(), noi.data_ptr())
    return mixed, out, sig, noi


def cuda_goertzel_block(state: dict, x: torch.Tensor, coeff: torch.Tensor) -> dict:
    """The Goertzel recurrence over one block: the new {"s0", "s1"} [C]
    float32 from the state, x [C, T] float32 and coeff [C] float32. Equals
    iir.goertzel_update_block (its plain version)."""
    if x.device.type == "cpu":
        return goertzel_update_block(state, x, coeff)
    if x.device.type != "cuda":
        raise ValueError(f"cuda_goertzel_block takes CPU or CUDA tensors, not {x.device}")
    C, T = x.shape
    dev = x.device
    _check(x, "x", torch.float32, (C, T), dev)
    for what, t in (("coeff", coeff), ("s0", state["s0"]), ("s1", state["s1"])):
        _check(t, what, torch.float32, (C,), dev)
    out = {"s0": torch.empty_like(state["s0"]), "s1": torch.empty_like(state["s1"])}
    if C == 0:
        return out
    _launch("goertzel", dev, x.data_ptr(), C, T, coeff.data_ptr(), state["s0"].data_ptr(),
            state["s1"].data_ptr(), out["s0"].data_ptr(), out["s1"].data_ptr())
    return out
