"""The yardstick of the kernels' roofline shares: the H100's published peaks
and the bytes and operations each op entry needs, counted from its shapes.

Frozen copies of the smoke test's counts (chip_smoke.py counts_a, counts_b,
bound, bound_a, bound_b): kernel A's bytes are the master tile rows the
channels cover, the responses, the IDFT constant and the output, each once,
and its operations the dense folded product (8 C n olen) with the gather,
fold and ramp, at the TF32 tensor-core rate three times over (split "3xTF32"
for FP32 accuracy); kernel B's bytes are the window bins once and a few
words a channel, its operations 5 FP32 a bin and one INT32 compare a key.
"""
from __future__ import annotations

import numpy as np

__all__ = ["HBM_BYTES_S", "FP32_OPS_S", "TF32_OPS_S", "INT32_OPS_S", "bound_ms",
           "channelize_bound_ms", "noise_est_bound_ms"]

# H100 SXM (NVIDIA data sheet, dense, at the 700 W limit): device memory
# bytes/s, FP32 FLOP/s off the tensor cores, TF32 FLOP/s on them, INT32
# operations/s (132 SMs x 64 lanes x 1.98 GHz).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12
TF32_OPS_S = 495e12
INT32_OPS_S = 132 * 64 * 1.98e9
TILE = 128


def bound_ms(nbytes: float, *ops: tuple[float, float]) -> float:
    """Least ms for nbytes through device memory and each (count, rate) of
    operations on its own units: the slowest of them."""
    return max([nbytes / HBM_BYTES_S] + [n / rate for n, rate in ops]) * 1e3


def channelize_bound_ms(shifts: np.ndarray, n: int, olen: int, master_bins: int,
                        real: bool = True) -> float:
    """Kernel A's bound for one launch over channels at bin `shifts`: S =
    whole tile rows covering any n-bin slice, each distinct row of the
    master once (a real master's upright slices clamp inside its rows; a
    complex master's signed ones wrap through DC)."""
    C = len(shifts)
    S = (-(-n // TILE) + 1) * TILE
    n_rows = -(-master_bins // TILE)
    lo = (np.asarray(shifts, np.int64) - n // 2) // TILE
    if real:
        rows = np.clip(lo, 0, max(n_rows - S // TILE, 0))[:, None] + np.arange(S // TILE)
    else:
        rows = (lo[:, None] + np.arange(S // TILE)) % n_rows
    rows = np.unique(rows)
    nbytes = rows.size * TILE * 8 + C * S * 8 + n * olen * 8 + C * olen * 8 + 3 * C * 4
    nops = 6 * C * S + 2 * C * (S - n) + 8 * C * n * olen + 8 * C * olen
    return bound_ms(nbytes, (3 * nops, TF32_OPS_S))


def noise_est_bound_ms(window_lo: np.ndarray, W: int, master_bins: int) -> float:
    """Kernel B's bound for one launch over channels whose N0 windows start
    at bins `window_lo`, W bins each (a complex master's signed starts wrap
    through DC): each distinct bin once."""
    C = len(window_lo)
    bins = np.unique((np.asarray(window_lo, np.int64)[:, None] + np.arange(W)) % master_bins).size
    return bound_ms(bins * 8 + C * (4 + 4 + 8), (C * W * 5, FP32_OPS_S), (C * W, INT32_OPS_S))
