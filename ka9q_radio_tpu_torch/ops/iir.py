"""First-order recurrences and the Goertzel single-bin DFT (iir.c/iir.h).

* First-order linear recurrences y[n] = c[n] y[n-1] + d[n] (exponential
  smoothers, FM de-emphasis, the AM DC remover) run as a log-depth
  (Hillis-Steele) scan over the sample axis: ceil(log2 T) steps of whole-
  tensor multiplies and adds, real or complex, never a loop over samples.
* The Goertzel recurrence (CTCSS tone detection, fm.c:279-325) keeps
  (s0, s1) across blocks, so a 240 ms integration spans several blocks.
  `goertzel_update_block` here is the plain version, a loop over samples,
  of the CUDA kernel in ops/cuda_recur.py (the engine calls the kernel's
  wrapper, which runs this for CPU tensors only).

* The direct-form-II IIR (`iir_apply`, iir.c:107-124) with its notch,
  lowpass and DC-blocker designers: host-designed coefficients, a loop over
  samples with the state carried across blocks. No part of the engine runs
  it; it is a library function for host-side filters.
"""
from __future__ import annotations

import math
import numbers

import numpy as np
import torch

__all__ = ["first_order_scan", "ema_smooth", "iir_notch_coeffs", "iir_lp4_coeffs",
           "iir_dc_coeffs", "iir_apply", "goertzel_coeff", "goertzel_init",
           "goertzel_update_block", "goertzel_output"]


def first_order_scan(c, d: torch.Tensor, y0, axis: int = -1) -> torch.Tensor:
    """Solve y[n] = c[n] y[n-1] + d[n] along `axis`.

    c: scalar or a tensor broadcastable to d; y0 broadcasts against d with
    `axis` removed. The initial condition folds into the first input
    (d[0] += c[0] y0); then each of ceil(log2 T) steps combines every pair
    (c_a, d_a), (c_b, d_b) a stride apart into (c_a c_b, d_a c_b + d_b).
    A Python number for c or y0 is filled on d's device, never copied from
    the host, so the scan can be captured in a CUDA graph.
    """
    d = torch.as_tensor(d)
    c = torch.broadcast_to(_on(c, d), d.shape)
    d, c = torch.movedim(d, axis, -1), torch.movedim(c, axis, -1)
    y0 = _on(y0, d)
    d = torch.cat([d[..., :1] + c[..., :1] * y0[..., None], d[..., 1:]], dim=-1)
    T = d.shape[-1]
    k = 1
    while k < T:
        c, d = (torch.cat([c[..., :k], c[..., :-k] * c[..., k:]], dim=-1),
                torch.cat([d[..., :k], d[..., :-k] * c[..., k:] + d[..., k:]], dim=-1))
        k *= 2
    return torch.movedim(d, -1, axis)


def _on(v, like: torch.Tensor) -> torch.Tensor:
    """v as a tensor of like's dtype on like's device: a number filled
    there (no host-to-device copy), a tensor or an array cast there."""
    if isinstance(v, numbers.Number):
        return torch.full((), v, dtype=like.dtype, device=like.device)
    return torch.as_tensor(v, dtype=like.dtype, device=like.device)


def ema_smooth(x: torch.Tensor, alpha, y0, axis: int = -1) -> torch.Tensor:
    """Exponential smoother y[n] = y[n-1] + alpha (x[n] - y[n-1])."""
    alpha = _on(alpha, x)
    return first_order_scan(1.0 - alpha, alpha * x, y0, axis=axis)


def iir_notch_coeffs(rel_freq: float, r: float = 0.997):
    """2-pole real notch at rel_freq (fraction of the sample rate); iir.c:54-77."""
    b = np.array([1.0, -2.0 * np.cos(2 * np.pi * rel_freq), 1.0])
    a = np.array([1.0, b[1] * r, r * r])
    return b, a


def iir_lp4_coeffs(rel_freq: float):
    """4-stage lowpass (Smith DSP guide p.326 form); iir.c:82-93."""
    x = np.exp(-14.445 * rel_freq)
    b = np.array([(1 - x) ** 4, 0.0, 0.0, 0.0, 0.0])
    a = np.array([1.0, -4 * x, 6 * x * x, -4 * x**3, x**4])
    return b, a


def iir_dc_coeffs(c: float = 0.999):
    """First-order DC blocker; iir.c:96-104."""
    b = np.array([(1 + c) / 2, -(1 + c) / 2])
    a = np.array([1.0, -c])
    return b, a


def iir_apply(x, b, a, w0=None, axis: int = -1):
    """Apply a direct-form-II IIR along `axis` (iir.c:107-124).

    x: real input [..., T]. b, a: feedforward and feedback coefficients
    (numpy or tensors), a[0] taken as 1; they may carry leading batch dims
    matching x's for per-channel filters. w0: initial state [..., order]
    (zeros by default). Returns (y, w_final): the output and the final
    state, to carry into the next block.
    """
    x = torch.movedim(torch.as_tensor(x), axis, -1)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    order = a.shape[-1] - 1
    w = (torch.zeros(x.shape[:-1] + (order,), dtype=x.dtype, device=x.device)
         if w0 is None else torch.as_tensor(w0, dtype=x.dtype, device=x.device))
    a_fb, nb = a[..., 1:], b.shape[-1]
    ys = []
    for t in range(x.shape[-1]):
        # w holds w[n-1]..w[n-order]; wfull w[n]..w[n-order]
        w_new0 = x[..., t] - torch.sum(a_fb * w, dim=-1)
        wfull = torch.cat([w_new0[..., None], w], dim=-1)
        ys.append(torch.sum(b * wfull[..., :nb], dim=-1))
        w = wfull[..., :order]
    y = torch.stack(ys, dim=-1) if ys else torch.zeros_like(x)
    return torch.movedim(y, -1, axis), w


def goertzel_coeff(rel_freq: torch.Tensor):
    """(coeff, cf) of a Goertzel bin at rel_freq (fraction of the sample
    rate), computed in float32 on rel_freq's device: coeff = 2 cos(2 pi f),
    cf = exp(-j 2 pi f)."""
    f = rel_freq.to(torch.float32)
    w = f * float(np.float32(2 * math.pi))
    c, s = torch.cos(w), torch.sin(w)
    return 2.0 * c, torch.complex(c, -s)


def goertzel_init(shape=(), device=None) -> dict:
    return {"s0": torch.zeros(shape, dtype=torch.float32, device=device),
            "s1": torch.zeros(shape, dtype=torch.float32, device=device)}


def goertzel_update_block(state: dict, x: torch.Tensor, coeff: torch.Tensor) -> dict:
    """The Goertzel recurrence over a block, sample by sample (the plain
    version of the goertzel_block kernel): s0 <- x + coeff s0 - s1, s1 <- s0
    (iir.h:39-44), each operation rounded on its own. x: [..., T] float32;
    coeff broadcasts against x's batch shape."""
    s0, s1 = state["s0"], state["s1"]
    x = x.to(torch.float32)
    for t in range(x.shape[-1]):
        s0, s1 = x[..., t] + coeff * s0 - s1, s0
    return {"s0": s0, "s1": s1}


def goertzel_output(state: dict, coeff: torch.Tensor, cf: torch.Tensor) -> torch.Tensor:
    """Push one zero sample and return s0 - cf s1 (iir.c:44-48). N unit-peak
    on-frequency samples give magnitude N/2. The state is not changed."""
    s0 = coeff * state["s0"] - state["s1"]
    s1 = state["s0"]
    return torch.complex(s0, torch.zeros_like(s0)) - cf * torch.complex(s1, torch.zeros_like(s1))
