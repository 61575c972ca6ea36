"""Distributed large FFT: the master forward transform split over a mesh.

The reference's most CPU-intensive operation is the giant forward FFT
(1.6-3.2M points a 20 ms block at RX888 rates, docs/FFTW3.md:4-7,57-61).
Split over D devices it becomes the row-column (four-step) Cooley-Tukey
transform:

    view x[N] as A[N1, N2] (row-major, so each device owns a contiguous
    time slice) -> local FFTs along N1 -> twiddle exp(-2 pi i n1 k2 / N) ->
    all-to-all (the distributed "corner turn") -> local FFTs along N2.

Three corner turns give natural order in and standard FFT order out, each
device ending with a contiguous bin range: the six-step FFT. The local
stages are torch.fft (cuFFT on the card); the corner turns are the
explicit copies of parallel.sharding.all_to_all.
"""
from __future__ import annotations

import numpy as np
import torch

from .sharding import Mesh, Sharded, all_to_all

__all__ = ["distributed_fft", "plan_split", "twiddle"]


def plan_split(N: int, ndev: int) -> tuple[int, int]:
    """Pick N = N1*N2 with ndev | N1 and ndev | N2 (both axes get corner-
    turned), N1 as close to sqrt(N) as possible."""
    best = None
    for n1 in range(ndev, N + 1, ndev):
        if N % n1 or (N // n1) % ndev:
            continue
        score = abs(np.log(n1 * n1 / N))
        if best is None or score < best[0]:
            best = (score, n1)
    if best is None:
        raise ValueError(f"N={N} has no split with both factors divisible by {ndev}")
    n1 = best[1]
    return n1, N // n1


def twiddle(n1: int, n2: int, N: int, cols: slice = slice(None)) -> np.ndarray:
    """[n1, len(cols)] four-step twiddle W_N^{k1 b} for the columns b in
    `cols`, built on the host with the exact int64 phase k1 b mod N, as
    complex64."""
    k1 = np.arange(n1, dtype=np.int64)[:, None]
    b = np.arange(n2, dtype=np.int64)[cols][None, :]
    return np.exp((-2j * np.pi / N) * ((k1 * b) % N)).astype(np.complex64)


def distributed_fft(x, mesh: Mesh, axis: str = "c", n1: int | None = None) -> Sharded:
    """Complex FFT of x[N] over the mesh.

    x: a tensor [N] (split here into contiguous time chunks) or a Sharded
    [N] split over its axis. Returns X[N] in standard FFT order, split into
    contiguous bin ranges (Sharded over axis 0; `.full()` joins it)."""
    N = x.shape[-1]
    D = mesh.shape[axis]
    if n1 is None:
        n1, n2 = plan_split(N, D)
    else:
        n2 = N // n1
    if n1 * n2 != N or n1 % D or n2 % D:
        raise ValueError(f"bad split {n1}x{n2} for N={N}, D={D}")
    cols = n2 // D
    if not isinstance(x, Sharded):
        x = Sharded.split(torch.as_tensor(x), mesh, 0)
    # this device's contiguous time rows of A[a, b] = x[a*n2 + b]; the
    # decomposition X[k1 + n1*k2] = FFT_{n2,b}(W(b, k1) FFT_{n1,a}(A)[k1, b])
    # takes the n1-transform first, so corner-turn to complete n1
    xs = [s.to(torch.complex64).reshape(n1 // D, n2) for s in x.shards]
    At = all_to_all(xs, mesh, split_dim=-1, concat_dim=-2)  # [n1, cols]
    A1 = [torch.fft.fft(a, dim=-2) * torch.as_tensor(
        twiddle(n1, n2, N, slice(d * cols, (d + 1) * cols)), device=a.device)
        for d, a in enumerate(At)]
    Bt = all_to_all(A1, mesh, split_dim=-2, concat_dim=-1)  # [n1/D, n2]
    C = [torch.fft.fft(b, dim=-1) for b in Bt]  # C[k1_local, k2]
    # standard order: shard over k2 (bin k = k1 + n1*k2 is contiguous per
    # k2 block): one more corner turn and a transpose
    Ct = all_to_all(C, mesh, split_dim=-1, concat_dim=-2)  # [n1, n2/D]
    return Sharded([c.transpose(-1, -2).reshape(-1) for c in Ct], 0, mesh)
