"""The two hand-written CUDA kernels of the main path, their wrappers and loader.

Counterpart of ka9q_radio_tpu/ops/pallas_channelize.py:

  cuda_channelize  csrc/channelize.cu   replaces pallas_channelize
  cuda_noise_est   csrc/noise_est.cu    replaces pallas_noise_est

The kernels compute what the plain PyTorch versions compute
(ops/filterbank.py `tiled_channelize`; ops/noise.py `gather_noise_bins` +
`estimate_noise_keys`), not the TPU mechanics: no span window, no one-hot
gather matmul, no 128-channel runs. Each channel reads its own rows straight
from device memory, so any layout runs, and there is no run plan to keep.

Kernel A folds the tile frame S -> n (the IDFT constant is periodic in its
row with period n) and runs the product on the tensor cores as one real
GEMM in split ("3xTF32") precision; its constant operand, the real-block
IDFT split into TF32 hi and lo parts in K-major core matrices, is built
once per group by `channelize_operand` (csrc/channelize.cu says why and
how).

A wrapper given CPU tensors runs the plain version: that is the CPU path of
the port. Given CUDA tensors it launches its kernel or raises; it never
falls back. Each launch adds one to `launches[name]`.

The sources build at first use with nvcc into a shared library with a plain
C interface (loaded through ctypes), one nvcc per source, all started
together, keyed by a hash of the source and the flags, under
build/torch_kernels/ at the root of the checkout.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .filterbank import _CTILE, tiled_channelize
from .noise import (N_CUTOFF, _quantile_terms, estimate_noise_keys, gather_noise_bins,
                    noise_correction, noise_window_fits)

__all__ = ["launches", "reset_launches", "build", "cuda_channelize", "cuda_noise_est",
           "channelize_operand", "fold_pad", "round_tf32", "SOURCES", "REPLACES"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> source file and the C entry point's argument types
_V, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_KERNELS = {
    "channelize": ("channelize.cu", "ka9q_channelize",
                   [_V, _LL, _I, _I, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _F, _V, _V]),
    "noise_est": ("noise_est.cu", "ka9q_noise_est",
                  [_V, _LL, _I, _V, _I, _I, _I, _I, _F, _F, _F, _F, _F, _V, _V, _V]),
}
SOURCES = {name: f"ka9q_radio_tpu_torch/csrc/{src}" for name, (src, _, _) in _KERNELS.items()}
REPLACES = {
    "channelize": "ka9q_radio_tpu/ops/pallas_channelize.py:165 (pallas_channelize; pallas_call at :214)",
    "noise_est": "ka9q_radio_tpu/ops/pallas_channelize.py:286 (pallas_noise_est; pallas_call at :324)",
}

# kernel A's tiling (csrc/channelize.cu): K chunk and column tile
_KC, _COLS = 32, 64

launches = {name: 0 for name in _KERNELS}
_loaded: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def build() -> dict:
    """Build (or find built) every kernel library and load it.

    Returns {"seconds": wall time, "built": names compiled now, "log": nvcc
    output per name}. Raises if a build fails.
    """
    t0 = time.perf_counter()
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, libs, log = {}, {}, {}
    for name, (src, _, _) in _KERNELS.items():
        text = (_CSRC / src).read_bytes()
        key = hashlib.sha256(text + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
        lib = _BUILD_DIR / f"lib{name}-{key}.so"
        libs[name] = lib
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / src)]
            jobs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True))
    for name, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        log[name] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} (rc {proc.returncode}):\n{out}")
        os.replace(tmp, libs[name])
    for name, (_, entry, argtypes) in _KERNELS.items():
        if name not in _loaded:
            fn = getattr(ctypes.CDLL(str(libs[name])), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return {"seconds": time.perf_counter() - t0, "built": sorted(jobs), "log": log}


def _fn(name: str):
    if name not in _loaded:
        build()
    return _loaded[name]


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{what} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _launch(name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _fn(name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError_t {rc}")
    launches[name] += 1


def fold_pad(n_bins: int) -> int:
    """Kernel A's fold length: n_bins rounded up to 16 (its K is 2 fold_pad)."""
    return -(-n_bins // 16) * 16


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 stored mantissa bits), to nearest with
    ties away from zero: what the card's cvt.rna.tf32.f32 gives."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def channelize_operand(E: torch.Tensor, n_bins: int, olen: int) -> torch.Tensor:
    """Kernel A's constant operand, from the IDFT matrix E [S, olen] c64.

    The real-block form B = [[Er, Ei], [-Ei, Er]] of E[:n_bins], [Kp, Np]
    with Kp = 2 fold_pad(n_bins) and Np = 2 (olen rounded up to 32) (column
    2t gives Re Y[t], 2t + 1 Im Y[t]), zero-padded, its rows in 32-row K
    chunks: rows 32 c + i of chunk c take Re x of fold bin 16 c + i and
    rows 32 c + 16 + i its Im x (i < 16), so that a run of chunks is a run
    of fold bins; split into TF32 parts hi = round_tf32(B), lo =
    round_tf32(B - hi); flattened as the kernel's shared-memory chunks want
    them: [Np/64 column tiles][Kp/32 K chunks][4 k8 steps][2 column
    halves][hi, lo][4 groups of 8 columns][2 k halves][8 columns][4 k]: K-major
    core matrices of 8 columns x 4 k (128 bytes), the tensor cores' B
    layout without swizzle. float32 on E's device.
    """
    n_pad = fold_pad(n_bins)
    Kp, olen_p = 2 * n_pad, -(-olen // 32) * 32
    Np = 2 * olen_p
    e = E[:n_bins]
    B = torch.zeros((Kp, olen_p, 2), dtype=torch.float32, device=E.device)
    B[:n_bins, :olen, 0], B[:n_bins, :olen, 1] = e.real, e.imag
    B[n_pad:n_pad + n_bins, :olen, 0], B[n_pad:n_pad + n_bins, :olen, 1] = -e.imag, e.real
    # [Re rows | Im rows] -> chunks of 16 Re rows then their 16 Im rows
    B = B.reshape(2, n_pad // 16, 16, Np).transpose(0, 1).reshape(Kp, Np)
    hi = round_tf32(B)
    T = torch.stack([hi, round_tf32(B - hi)], -1)
    # k = ((ch * 4 + s) * 2 + kh) * 4 + q, n = ((ct * 2 + half) * 4 + grp) * 8 + r
    T = T.reshape(Kp // _KC, 4, 2, 4, Np // _COLS, 2, 4, 8, 2)  # ch s kh q ct half grp r hl
    return T.permute(4, 0, 1, 5, 8, 6, 2, 7, 3).contiguous().reshape(-1)


def cuda_channelize(F: torch.Tensor, resp_tiles: torch.Tensor, tile_lo: torch.Tensor,
                    slope: torch.Tensor, shifts: torch.Tensor, E: torch.Tensor,
                    n_bins: int, olen: int, real_master: bool, master_N: int,
                    E_op: torch.Tensor | None = None) -> torch.Tensor:
    """Tiled channelizer: [C, olen] complex64 baseband from the master
    spectrum F [m_bins] complex64, the tile params resp_tiles [C, S] c64 and
    tile_lo/slope/shifts [C] int32, and the IDFT matrix E [S, olen] c64.
    Equals filterbank.tiled_channelize (its plain version). E_op is
    channelize_operand(E, n_bins, olen), the kernel's form of E, which the
    caller builds once: the kernel needs it, the CPU path does not."""
    if F.device.type == "cpu":
        return tiled_channelize(F, resp_tiles, tile_lo, slope, shifts, E, n_bins, olen,
                                real_master, master_N)
    if F.device.type != "cuda":
        raise ValueError(f"cuda_channelize takes CPU or CUDA tensors, not {F.device}")
    C, S = resp_tiles.shape
    m_bins = master_N // 2 + 1 if real_master else master_N
    if S % _CTILE or not real_master and m_bins % _CTILE:
        raise ValueError("tile frame and complex master must be whole 128-bin tiles")
    dev = F.device
    _check(F, "F", torch.complex64, (m_bins,), dev)
    _check(resp_tiles, "resp_tiles", torch.complex64, (C, S), dev)
    for what, t in (("tile_lo", tile_lo), ("slope", slope), ("shifts", shifts)):
        _check(t, what, torch.int32, (C,), dev)
    _check(E, "E", torch.complex64, (S, olen), dev)
    n_pad = fold_pad(n_bins)
    if n_bins * n_bins >= 2**31:
        raise ValueError("the kernel's 32-bit ramp phase needs n_bins^2 < 2^31")
    if F.data_ptr() % 16 or resp_tiles.data_ptr() % 16:
        raise ValueError("F and resp_tiles must start on 16-byte boundaries (16-byte loads)")
    if E_op is None:
        raise ValueError("the kernel takes the group's E_op = channelize_operand(E, n_bins, olen)")
    _check(E_op, "E_op", torch.float32, (2 * n_pad * 2 * (-(-olen // 32) * 32) * 2,), dev)
    out = torch.empty((C, olen), dtype=torch.complex64, device=dev)
    if C == 0:
        return out
    nrows = -(-m_bins // _CTILE)
    w = float(np.float32(2.0 * np.pi / n_bins))
    _launch("channelize", dev, F.data_ptr(), m_bins, nrows, int(real_master),
            resp_tiles.data_ptr(), tile_lo.data_ptr(), slope.data_ptr(), shifts.data_ptr(),
            E_op.data_ptr(), C, S, olen, n_bins, n_pad, w, out.data_ptr())
    return out


def cuda_noise_est(F: torch.Tensor, shifts: torch.Tensor, nbins: int, real_master: bool,
                   master_N: int, samprate: float):
    """Noise floor of every channel: (n0 [C] float32, keys [C, 2] int32),
    the keys being the int32 views of the two order statistics. Equals
    noise.estimate_noise_keys(noise.gather_noise_bins(...)) (its plain
    version)."""
    m_bins = master_N // 2 + 1 if real_master else master_N
    if F.device.type == "cpu":
        return estimate_noise_keys(gather_noise_bins(F, shifts, nbins, real_master, master_N),
                                   m_bins, samprate)
    if F.device.type != "cuda":
        raise ValueError(f"cuda_noise_est takes CPU or CUDA tensors, not {F.device}")
    if not noise_window_fits(nbins, real_master, master_N):
        raise NotImplementedError(
            "per-element noise windows (small or odd masters) are a later slice of the port")
    W = -(-nbins // _CTILE) * _CTILE
    if W > 4096:
        raise ValueError(f"noise window of {W} bins exceeds the kernel's 4096")
    C = shifts.shape[0]
    dev = F.device
    _check(F, "F", torch.complex64, (m_bins,), dev)
    _check(shifts, "shifts", torch.int32, (C,), dev)
    if F.data_ptr() % 16:
        raise ValueError("F must start on a 16-byte boundary (the kernel reads two bins a load)")
    n0 = torch.empty(C, dtype=torch.float32, device=dev)
    keys = torch.empty((C, 2), dtype=torch.int32, device=dev)
    if C == 0:
        return n0, keys
    i, has_next, w_lo, w_hi = _quantile_terms(W)
    corr = float(np.float32(noise_correction()))
    denom = float(np.float32(float(m_bins) * float(samprate)))
    _launch("noise_est", dev, F.data_ptr(), m_bins, int(real_master), shifts.data_ptr(),
            C, W, i, int(has_next), w_lo, w_hi, float(N_CUTOFF), corr, denom,
            n0.data_ptr(), keys.data_ptr())
    return n0, keys
