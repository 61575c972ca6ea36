"""Distributed digit-order master FFT and the sharded bin gathers.

The multi-device form of the shared forward transform (the reference's
rof3240000 plan at RX888 full rate, docs/FFTW3.md:4-7,57-61):

  1. `DigitMaster.fft`: two-factor Cooley-Tukey with TWO all-to-all corner
     turns (the six-step FFT minus its final turn). Device d ends owning
     rows k1 in [d n1/D, (d+1) n1/D) of C[k1, k2], where the global bin is
     k = k1 + n1 k2: "digit order". `fft_natural` adds the final turn and
     returns the natural-order spectrum split into contiguous bin ranges.
  2. `DigitMaster.take`: an arbitrary-bin gather from the digit layout.
     Every device reads only the bins it owns (a masked local gather), and
     one psum_scatter over the channel axis both sums the partial reads and
     leaves the result split into each device's C/D channel rows.
  3. `DigitMaster.notch`: the spur/DC notch (filter.c:443-453) as a masked
     add onto the owning device's digit rows.

A real A/D master runs the complex transform with zero imaginary part, as
the JAX package does: the flagship N = 3,240,000 = 2^6 3^4 5^4 splits
1800 x 1800 for an 8-device mesh, while its packed half length 1,620,000
cannot meet the D | n1, D | n2 corner-turn divisibility for D = 8. The
gathers then use the single-device real-master index math (read |g|,
conjugate where the spectrum is inverted, filter.c:777-859), so sharded and
single-device engines agree to FFT roundoff.

The local stages are torch.fft (cuFFT on the card), not the TPU's matmul
cascade; the four-step twiddle is a complex64 table built once on the host
with the exact int64 phase. Retunes stay pure data: bin indices are tensors
computed from the shifts each block.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .fft import plan_split, twiddle
from .sharding import Mesh, Sharded, all_gather, all_to_all, psum, psum_scatter

__all__ = ["DigitMaster", "DigitSpectrum", "per_device"]


def per_device(x, mesh: Mesh) -> list:
    """The whole value of x on every device of the mesh: a Sharded split
    value is all-gathered, a replicated one taken as it is, a tensor copied
    to each device; a list is already one tensor a device."""
    if isinstance(x, (list, tuple)):
        return list(x)
    if isinstance(x, Sharded):
        return x.shards if x.dim is None else all_gather(x.shards, mesh, dim=x.dim)
    return Sharded.replicate(torch.as_tensor(x), mesh).shards


def _local_rows(x, mesh: Mesh) -> list:
    """Each device's C/D channel rows of a [C, ...] value (a Sharded split
    over axis 0 gives its shards; a tensor or replicated value is cut)."""
    if isinstance(x, Sharded) and x.dim == 0:
        return x.shards
    whole = per_device(x, mesh)
    D = mesh.size
    return [torch.chunk(w, D, dim=0)[d] for d, w in enumerate(whole)]


@dataclasses.dataclass(frozen=True)
class DigitMaster:
    """Plan for one distributed master transform over a mesh axis.

    real=True masters keep only stage-2 columns k2 <= n2/2 (every gathered
    bin k = k1 + n1 k2 <= N/2, filter.c's non-negative half), so the second
    stage's output is half its length."""

    mesh: Mesh
    axis: str
    N: int
    n1: int
    n2: int
    real: bool = False

    @classmethod
    def plan(cls, mesh: Mesh, axis: str, N: int, real: bool = False, mxu: bool = False,
             precision: str = "high") -> "DigitMaster":
        """Split N = n1 n2 with D | n1 and D | n2; raises where N has no
        such split. mxu and precision "bf16" are the TPU's matmul-cascade
        local stages and its precision tier; the port's local stages are
        cuFFT in FP32, so both raise."""
        if mxu:
            raise ValueError("mxu=True picks the TPU's matmul-cascade local stages; the port's "
                             "local stages are cuFFT (mxu=False)")
        precision = str(precision).lower()
        if precision == "bf16":
            raise ValueError("precision='bf16' is a tier of the TPU's matmul cascade; the port's "
                             "local stages run in FP32 (high or exact)")
        if precision not in ("high", "exact"):
            raise ValueError(f"precision={precision!r}: expected high|exact")
        n1, n2 = plan_split(N, mesh.shape[axis])  # D | n1 and D | n2
        if N >= 2**31:
            raise ValueError(f"N={N}: twiddle residues (k1*b mod N < N) exceed int32")
        return cls(mesh=mesh, axis=axis, N=N, n1=n1, n2=n2, real=real)

    @property
    def D(self) -> int:
        return self.mesh.shape[self.axis]

    @property
    def rows(self) -> int:
        return self.n1 // self.D

    @property
    def cols(self) -> int:
        return self.n2 // self.D

    @property
    def n2_kept(self) -> int:
        """Stage-2 columns kept: n2/2+1 for real masters (bins <= N/2)."""
        return self.n2 // 2 + 1 if self.real else self.n2

    @property
    def kept_pad(self) -> int:
        """n2_kept rounded up so the natural-order corner turn divides."""
        return -(-self.n2_kept // self.D) * self.D

    @property
    def nat_bins(self) -> int:
        """Length of fft_natural's output (>= m_bins; pad bins at the end)."""
        return self.n1 * self.kept_pad

    @functools.cached_property
    def _tw(self) -> list:
        """Each device's [n1, cols] column slice of the twiddle table."""
        c = self.cols
        return [torch.as_tensor(twiddle(self.n1, self.n2, self.N, slice(d * c, (d + 1) * c)),
                                device=dev)
                for d, dev in enumerate(self.mesh.devices)]

    # -- forward transform ---------------------------------------------------
    def _in_shards(self, x, cols_in: bool) -> list:
        """Each device's block of the [..., n1, n2] sample matrix x[a, b] =
        sample a n2 + b: rows [..., n1/D, n2] (contiguous time), or with
        cols_in columns [..., n1, n2/D]."""
        dim = -1 if cols_in else -2
        if isinstance(x, Sharded):
            return [s.reshape(s.shape[:-1] + (-1, self.n2)) if not cols_in and s.shape[-1] != self.n2
                    else s for s in x.shards]
        x = torch.as_tensor(x)
        if x.shape[-1] == self.N:
            x = x.reshape(x.shape[:-1] + (self.n1, self.n2))
        return Sharded.split(x, self.mesh, dim).shards

    def digit_rows(self, x, cols_in: bool = False) -> list:
        """The two corner turns: each device's [..., rows, n2] block of
        C[k1, k2] (X[k1 + n1 k2] = C[k1, k2]), all n2 columns."""
        xs = self._in_shards(x, cols_in)
        if cols_in:
            At = xs  # already [..., n1, cols] on each device
        else:
            At = all_to_all(xs, self.mesh, split_dim=-1, concat_dim=-2)  # [..., n1, cols]
        A1 = [torch.fft.fft(a.to(torch.complex64), dim=-2) * tw for a, tw in zip(At, self._tw)]
        Bt = all_to_all(A1, self.mesh, split_dim=-2, concat_dim=-1)  # [..., rows, n2]
        return [torch.fft.fft(b, dim=-1) for b in Bt]

    def fft(self, x, cols_in: bool = False) -> Sharded:
        """x: [..., N] time samples (a tensor, or the sample matrix's row
        shards) -> Zd [..., n1, n2_kept] complex64 in digit order, split over
        its rows (X[k1 + n1 k2] = Zd[k1, k2])."""
        kept = self.n2_kept
        return Sharded([c[..., :kept].contiguous() for c in self.digit_rows(x, cols_in)], -2,
                       self.mesh)

    def natural(self, C: list) -> list:
        """The final corner turn of digit_rows' blocks: each device's
        contiguous [..., nat_bins/D] range of the natural-order spectrum
        (real masters keep k2 <= n2/2 columns, rounded up to a multiple of
        D; the pad bins land past N/2, beyond every bin the engine reads)."""
        kp = self.kept_pad
        n2 = self.n2
        out = []
        for c in C:
            c = (torch.nn.functional.pad(c, (0, kp - n2)) if kp > n2 else c[..., :kp])
            out.append(c.transpose(-1, -2))  # [..., kp, rows]
        Ct = all_to_all(out, self.mesh, split_dim=-2, concat_dim=-1)  # [..., kp/D, n1]
        return [c.reshape(c.shape[:-2] + (-1,)) for c in Ct]

    def fft_natural(self, x, cols_in: bool = False) -> Sharded:
        """The six-step FFT: the natural-order spectrum as one [...,
        nat_bins] value split into contiguous bin ranges (device d owns bins
        [d nat/D, (d+1) nat/D)).

        cols_in=True: x is already the [..., n1, n2] sample matrix split
        over its COLUMNS (x[a, b] = sample a n2 + b), so the first corner
        turn is skipped. The engine carries its master tail so when n2
        divides both L and N - L (a block advance of whole rows)."""
        return Sharded(self.natural(self.digit_rows(x, cols_in)), -1, self.mesh)

    # -- gathers -------------------------------------------------------------
    def take(self, Zd, idx, scatter: bool = True, inputs=None):
        """Gather master bins idx (in [0, N)) from the digit-order spectrum.

        Zd: a Sharded [..., n1, n2_kept] (or its list of row shards); idx
        [C, nb] (or any shape with scatter=False), a tensor or Sharded;
        inputs: [C] stream of each channel on a [B, n1, n2_kept] spectrum.
        scatter=True: a Sharded [C, nb] split into C/D channel rows (one
        psum_scatter); scatter=False: the whole [..., *idx.shape] value
        replicated (one psum). Each device contributes only the bins it
        owns. A real master must only be asked for bins <= N/2."""
        zs = Zd.shards if isinstance(Zd, Sharded) else list(Zd)
        n1, rows = self.n1, self.rows
        ixs = per_device(idx, self.mesh)
        ins = per_device(inputs, self.mesh) if inputs is not None else [None] * self.D
        parts = []
        for d, (z, ix, inp) in enumerate(zip(zs, ixs, ins)):
            n2k = z.shape[-1]
            ix = ix.to(torch.int64)
            lr = torch.remainder(ix, n1) - d * rows
            ok = (lr >= 0) & (lr < rows)
            flat = torch.clamp(lr, 0, rows - 1) * n2k + torch.div(ix, n1, rounding_mode="floor")
            zf = z.reshape(z.shape[:-2] + (-1,))
            flat = torch.clamp(flat, 0, zf.shape[-1] - 1)
            if inp is None:
                v = zf[..., flat]
            else:
                v = zf[inp.to(torch.int64).reshape((-1,) + (1,) * (flat.dim() - 1)), flat]
            parts.append(torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=v.device)))
        if scatter:
            return Sharded(psum_scatter(parts, self.mesh, 0), 0, self.mesh)
        return Sharded(psum(parts, self.mesh), None, self.mesh)

    def spur_plan(self, bins) -> list:
        """Each device's (positions j of the static bins it owns, their local
        rows, their columns) for notch()."""
        bins = np.asarray(bins, np.int64)
        k1, k2 = bins % self.n1, bins // self.n1
        owner = k1 // self.rows
        plan = []
        for d, dev in enumerate(self.mesh.devices):
            js = np.nonzero(owner == d)[0]
            plan.append(tuple(torch.as_tensor(a, device=dev)
                              for a in (js, k1[js] - d * self.rows, k2[js])))
        return plan

    def notch(self, Zd, bins, track, plan: "list | None" = None):
        """Subtract track[..., j] from master bin bins[j] (static positions),
        in place on the owning device's digit rows (their row stride is the
        shards' last dimension: n2_kept as fft() returns them, n2 as
        digit_rows() does). track: [..., len(bins)], a tensor or replicated
        value; plan: spur_plan(bins), made once. Returns Zd."""
        zs = Zd.shards if isinstance(Zd, Sharded) else list(Zd)
        plan = self.spur_plan(bins) if plan is None else plan
        trs = per_device(track, self.mesh)
        for z, tr, (js, lr, k2) in zip(zs, trs, plan):
            if js.numel():
                if not z.is_contiguous():
                    raise ValueError("notch writes in place: Zd's shards must be contiguous")
                zf = z.view(z.shape[:-2] + (-1,))
                zf.index_add_(-1, lr * z.shape[-1] + k2, -tr.index_select(-1, js))
        return Zd


def _signed_bins(n_bins: int, device) -> torch.Tensor:
    k = torch.arange(n_bins, dtype=torch.int64, device=device)
    return torch.where(k < (n_bins + 1) // 2, k, k - n_bins)[None, :]


class DigitSpectrum:
    """One block's distributed master spectrum and the gathers of
    ops/filterbank.py and ops/noise.py (gather_bins, channelize_beam's
    combine, gather_noise_bins) on its digit-order layout: what a group that
    does not take the tiled channelizer reads on a sharded engine. Every
    result is split into each device's C/D channel rows."""

    def __init__(self, dm: DigitMaster, Zd, real_master: bool):
        self.dm = dm
        self.Zd = Zd
        self.real = real_master

    def _rows(self, whole: list) -> list:
        D = self.dm.D
        return [torch.chunk(w, D, dim=0)[d] for d, w in enumerate(whole)]

    def gather(self, shifts, n_bins: int, inputs=None) -> Sharded:
        """gather_bins: [C, n_bins] channel slices, split over channels.
        The index math mirrors filter.c:695-860 as gather_bins does."""
        dm = self.dm
        mesh = dm.mesh
        sh = per_device(shifts, mesh)
        gs = [s.to(torch.int64)[:, None] + _signed_bins(n_bins, s.device) for s in sh]
        if self.real:
            m_bins = dm.N // 2 + 1
            inv = [(s < 0)[:, None] for s in sh]
            mi = [torch.where(i, -g, g) for i, g in zip(inv, gs)]
            valid = [(m >= 0) & (m < m_bins) for m in mi]
            vals = dm.take(self.Zd, [torch.clamp(m, 0, m_bins - 1) for m in mi], inputs=inputs)
            out = [torch.where(i, v.conj(), v) for i, v in zip(self._rows(inv), vals.shards)]
        else:
            valid = [(g >= -(dm.N // 2)) & (g <= (dm.N - 1) // 2) for g in gs]
            out = dm.take(self.Zd, [torch.remainder(g, dm.N) for g in gs], inputs=inputs).shards
        return Sharded([torch.where(ok, v, torch.zeros((), dtype=v.dtype, device=v.device))
                        for ok, v in zip(self._rows(valid), out)], 0, mesh)

    def gather_beam(self, shifts, n_bins: int, alpha, beta, inputs=None) -> Sharded:
        """channelize_beam's antenna combine on distributed bins
        (filter.c:723-742): alpha F[rp] + beta conj(F[-rp]), DC and Nyquist
        carrying the antennas as real and imaginary parts."""
        dm = self.dm
        mesh = dm.mesh
        sh = per_device(shifts, mesh)
        gs = [s.to(torch.int64)[:, None] + _signed_bins(n_bins, s.device) for s in sh]
        valid = [(g >= -(dm.N // 2)) & (g <= (dm.N - 1) // 2) for g in gs]
        rps = [torch.remainder(g, dm.N) for g in gs]
        both = dm.take(self.Zd, [torch.cat([rp, torch.remainder(dm.N - rp, dm.N)], dim=-1)
                                 for rp in rps], inputs=inputs)
        al, be = _local_rows(alpha, mesh), _local_rows(beta, mesh)
        out = []
        for b, a, bt, ok, rp in zip(both.shards, al, be, self._rows(valid), self._rows(rps)):
            f_rp, f_mir = b[:, :n_bins], b[:, n_bins:]
            a, bt = a[:, None], bt[:, None]
            vals = a * f_rp + bt * f_mir.conj()
            special = (rp == 0) | (rp == dm.N // 2)
            sval = a * f_rp.real + bt * f_rp.imag
            out.append(torch.where(ok, torch.where(special, sval, vals),
                                   torch.zeros((), dtype=vals.dtype, device=vals.device)))
        return Sharded(out, 0, mesh)

    def gather_noise(self, shifts, nbins: int, inputs=None) -> Sharded:
        """gather_noise_bins: [C, W] bin energies around each channel, the
        window placed bin for bin as ops/noise.py places it (tile-aligned
        where noise_window_fits, per-element otherwise), so a sharded
        engine's N0 equals the single-device engine's."""
        from ..ops.noise import _TILE as T, noise_window_fits

        dm = self.dm
        mesh = dm.mesh
        m_bins = dm.N // 2 + 1 if self.real else dm.N
        tiled = noise_window_fits(nbins, self.real, dm.N)
        W = -(-nbins // T) * T if tiled else nbins
        idx = []
        for s in per_device(shifts, mesh):
            sh = s.to(torch.int64)
            k = torch.arange(W, dtype=torch.int64, device=s.device)[None, :]
            if self.real:
                lo = torch.clamp(sh.abs() - W // 2, 0, max(m_bins - W, 0))
            else:
                lo = torch.clamp(sh - W // 2, -(m_bins // 2), (m_bins - 1) // 2 - (W - 1))
            if tiled:
                lo = torch.div(lo, T, rounding_mode="floor") * T
            ix = lo[:, None] + k
            idx.append(torch.clamp(ix, 0, m_bins - 1) if self.real
                       else torch.remainder(ix, m_bins))
        v = dm.take(self.Zd, idx, inputs=inputs)
        return Sharded([x.real * x.real + x.imag * x.imag for x in v.shards], 0, mesh)
