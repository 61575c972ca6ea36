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

The client daemons' direct-form IIR (`iir_apply`) and its notch, lowpass and
DC designers are not ported: no part of the engine runs them.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["first_order_scan", "ema_smooth", "goertzel_coeff", "goertzel_init",
           "goertzel_update_block", "goertzel_output"]


def first_order_scan(c, d: torch.Tensor, y0, axis: int = -1) -> torch.Tensor:
    """Solve y[n] = c[n] y[n-1] + d[n] along `axis`.

    c: scalar or a tensor broadcastable to d; y0 broadcasts against d with
    `axis` removed. The initial condition folds into the first input
    (d[0] += c[0] y0); then each of ceil(log2 T) steps combines every pair
    (c_a, d_a), (c_b, d_b) a stride apart into (c_a c_b, d_a c_b + d_b).
    """
    d = torch.as_tensor(d)
    c = torch.broadcast_to(torch.as_tensor(c, dtype=d.dtype, device=d.device), d.shape)
    d, c = torch.movedim(d, axis, -1), torch.movedim(c, axis, -1)
    y0 = torch.as_tensor(y0, dtype=d.dtype, device=d.device)
    d = torch.cat([d[..., :1] + c[..., :1] * y0[..., None], d[..., 1:]], dim=-1)
    T = d.shape[-1]
    k = 1
    while k < T:
        c, d = (torch.cat([c[..., :k], c[..., :-k] * c[..., k:]], dim=-1),
                torch.cat([d[..., :k], d[..., :-k] * c[..., k:] + d[..., k:]], dim=-1))
        k *= 2
    return torch.movedim(d, -1, axis)


def ema_smooth(x: torch.Tensor, alpha, y0, axis: int = -1) -> torch.Tensor:
    """Exponential smoother y[n] = y[n-1] + alpha (x[n] - y[n-1])."""
    alpha = torch.as_tensor(alpha, dtype=x.dtype, device=x.device)
    return first_order_scan(1.0 - alpha, alpha * x, y0, axis=axis)


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
