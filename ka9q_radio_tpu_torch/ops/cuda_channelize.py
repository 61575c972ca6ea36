"""The two hand-written CUDA kernels of the main path, their wrappers and loader.

Counterpart of ka9q_radio_tpu/ops/pallas_channelize.py:

  cuda_channelize  csrc/channelize.cu   replaces pallas_channelize
  cuda_noise_est   csrc/noise_est.cu    replaces pallas_noise_est

The loader here also builds and binds csrc/recur.cu, the demodulators'
per-sample recurrences (pll_scan, goertzel), whose wrappers are in
ops/cuda_recur.py, and csrc/linear_tail.cu, the linear demodulator's tail
(linear_tail), whose wrapper is in ops/cuda_tail.py; those are not TPU
kernels (the JAX package runs the recurrences as lax.scan and the tail as
jitted array code).

The kernels compute what the plain PyTorch versions compute
(ops/filterbank.py `tiled_channelize`; ops/noise.py `gather_noise_bins` +
`estimate_noise_keys`), not the TPU mechanics: no span window, no one-hot
gather matmul, no 128-channel runs. Each channel reads its own rows straight
from device memory, so any layout runs, and there is no run plan to keep.
With several inputs, F is [B, ld] and `inputs` [C] int32 names each
channel's row: the kernels place a channel's rows or window inside its own
row (clamped on a real master, wrapped on a complex one) and only then add
the row's offset, so no channel reads its neighbour's stream. ld must be
even, so that every row starts 16 bytes aligned for the kernels' 16-byte
loads (the engine pads rows to whole 128-bin tiles; an odd real m_bins,
rx888's 1,620,001, would misalign every odd row).

Kernel A folds the tile frame S -> n (the IDFT constant is periodic in its
row with period n) and runs the product on the tensor cores in split
("3xTF32") precision, in one of two designs that `channelize_plan` picks
from the launch's shape and the card's SM count: a one-shot grid (a CTA a
row tile and column tile) that reads the constant operand, the real-block
IDFT split into TF32 hi and lo parts in K-major core matrices, built once
per group by `channelize_operand`; or, for launches of many row tiles, a
persistent one (a CTA an SM walking the row tiles) that looks the
constant's n values up on chip from E (csrc/channelize.cu says why and
how).

A wrapper given CPU tensors runs the plain version: that is the CPU path of
the port. Given CUDA tensors it launches its kernel or raises; it never
falls back. Each launch adds one to `launches[name]`, or, inside
`recording()` in the same thread, to that block's own count (a CUDA graph's
capture records what its replays add: runtime/graphs.py).

The sources build at first use with nvcc into a shared library with a plain
C interface (loaded through ctypes), one nvcc per source, all started
together, keyed by a hash of the source and the flags, under
build/torch_kernels/ at the root of the checkout.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from .filterbank import _CTILE, tiled_channelize
from .noise import (N_CUTOFF, _quantile_terms, estimate_noise_keys, gather_noise_bins,
                    noise_correction, noise_window_fits)

__all__ = ["launches", "reset_launches", "recording", "build", "cuda_channelize", "cuda_noise_est",
           "channelize_operand", "channelize_plan", "sm_count", "fold_pad", "round_tf32", "SOURCES",
           "REPLACES"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> source file and the C entry point's argument types
_V, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_KERNELS = {
    "channelize": ("channelize.cu", "ka9q_channelize",
                   [_V, _LL, _LL, _I, _I, _V, _V, _V, _V, _V, _V, _V, _I, _I, _I, _I, _I, _F, _I,
                    _V, _V]),
    "noise_est": ("noise_est.cu", "ka9q_noise_est",
                  [_V, _LL, _LL, _I, _I, _V, _V, _I, _I, _I, _I, _F, _F, _F, _F, _F, _V, _V, _V]),
    "pll_scan": ("recur.cu", "ka9q_pll_scan", [_V, _I, _I] + [_V] * 16),
    "goertzel": ("recur.cu", "ka9q_goertzel_block", [_V, _I, _I] + [_V] * 6),
    "linear_tail": ("linear_tail.cu", "ka9q_linear_tail",
                    [_I, _I, _LL, _I, _I, _I, _F, _F, _V, _V]),
}
# per-source flags beyond _NVCC_FLAGS: the recurrences and the linear tail
# round every operation on its own, as their plain versions do
# (csrc/recur.cu, csrc/linear_tail.cu)
_SRC_FLAGS = {"recur.cu": ("-fmad=false",), "linear_tail.cu": ("-fmad=false",)}
SOURCES = {name: f"ka9q_radio_tpu_torch/csrc/{src}" for name, (src, _, _) in _KERNELS.items()}
REPLACES = {
    "channelize": "ka9q_radio_tpu/ops/pallas_channelize.py:168 (pallas_channelize; pallas_call at :214)",
    "noise_est": "ka9q_radio_tpu/ops/pallas_channelize.py:288 (pallas_noise_est; pallas_call at :324)",
    "pll_scan": "ka9q_radio_tpu/models/linear.py:66-89 (the PLL's lax.scan; not a TPU kernel)",
    "goertzel": "ka9q_radio_tpu/ops/iir.py:172-177 (the Goertzel's lax.scan; not a TPU kernel)",
    "linear_tail": ("ka9q_radio_tpu/runtime/engine.py:1123 and models/linear.py:108-236 (fine "
                    "tune, AGC, detection and squelch as jitted array code; not a TPU kernel)"),
}

# kernel A's tiling (csrc/channelize.cu): K chunk and column tile
_KC, _COLS = 32, 64
# its persistent design's widest fold: its table holds the constant's n values, 320 at most
# (X of a 32-channel row tile, hi and lo, then takes 160 KB of shared memory)
_P_MAXN = 320
# the persistent design when the one-shot grid (row tiles of 64 x column tiles) would take
# more than this many waves of one CTA an SM: on an H100 (PERF.md §6) the one-shot grid of
# one wave is the faster (C 1,000: 0.029 against 0.043 ms), of two the slower (C 1,088:
# 0.056 against 0.043)
_P_WAVES = 1

launches = {name: 0 for name in _KERNELS}
_loaded: dict[str, ctypes._CFuncPtr] = {}
_local = threading.local()  # this thread's recording() count, if any


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


@contextlib.contextmanager
def recording():
    """Count this thread's launches inside the block in the dict it yields,
    not in `launches`: a CUDA graph's capture (whose replays add them) and
    its warm-up run, while other threads' launches count as usual."""
    prev = getattr(_local, "count", None)
    _local.count = dict.fromkeys(launches, 0)
    try:
        yield _local.count
    finally:
        _local.count = prev


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")
    return path


def build() -> dict:
    """Build (or find built) every kernel library and load it.

    Returns {"seconds": wall time, "built": sources compiled now, "log":
    nvcc output per source}. Raises if a build fails.
    """
    t0 = time.perf_counter()
    nvcc = _nvcc()
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, libs, log = {}, {}, {}
    for src in dict.fromkeys(src for src, _, _ in _KERNELS.values()):
        flags = (*_NVCC_FLAGS, *_SRC_FLAGS.get(src, ()))
        text = (_CSRC / src).read_bytes()
        key = hashlib.sha256(text + " ".join(flags).encode()).hexdigest()[:16]
        lib = _BUILD_DIR / f"lib{Path(src).stem}-{key}.so"
        libs[src] = lib
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *flags, "-o", str(tmp), str(_CSRC / src)]
            jobs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True))
    for src, (tmp, proc) in jobs.items():
        out, _ = proc.communicate()
        log[src] = out
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src} (rc {proc.returncode}):\n{out}")
        os.replace(tmp, libs[src])
    for name, (src, entry, argtypes) in _KERNELS.items():
        if name not in _loaded:
            fn = getattr(ctypes.CDLL(str(libs[src])), entry)
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
    count = getattr(_local, "count", None)
    (launches if count is None else count)[name] += 1


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


def channelize_plan(C: int, n_pad: int, olen: int, sms: int) -> str:
    """Kernel A's design for a launch of C channels at fold length n_pad and
    olen output samples on a card of `sms` SMs (0: no card): "persistent" (a
    CTA an SM walks the row tiles, each row gathered once, the constant
    looked up on chip from its n values) where n_pad <= _P_MAXN and the
    one-shot grid would take more than _P_WAVES waves, else "one-shot" (a
    CTA a row tile and column tile)."""
    one_shot_ctas = -(-C // 64) * (2 * (-(-olen // 32) * 32) // _COLS)
    if sms > 0 and n_pad <= _P_MAXN and one_shot_ctas > _P_WAVES * sms:
        return "persistent"
    return "one-shot"


_sms: dict = {}


def sm_count(device) -> int:
    """The SMs of a CUDA device (once a device), 0 for any other."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return 0
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


def _check_spectrum(F: torch.Tensor, m_bins: int, inputs: torch.Tensor | None, C: int,
                    device) -> int:
    """Check the master spectrum (and `inputs`) a kernel reads: [m_bins],
    or [B, ld] with ld >= m_bins even and inputs [C] int32. Returns ld (0
    for one spectrum)."""
    if inputs is None:
        _check(F, "F", torch.complex64, (m_bins,), device)
        ld = 0
    else:
        if F.dim() != 2 or F.shape[1] < m_bins or F.shape[1] % 2:
            raise ValueError(f"F has shape {tuple(F.shape)}: with inputs it is [B, ld], "
                             f"ld >= {m_bins} and even (16-byte rows)")
        _check(F, "F", torch.complex64, tuple(F.shape), device)
        _check(inputs, "inputs", torch.int32, (C,), device)
        ld = F.shape[1]
    if F.data_ptr() % 16:
        raise ValueError("F must start on a 16-byte boundary (the kernels' 16-byte loads)")
    return ld


def cuda_channelize(F: torch.Tensor, resp_tiles: torch.Tensor, tile_lo: torch.Tensor,
                    slope: torch.Tensor, shifts: torch.Tensor, E: torch.Tensor,
                    n_bins: int, olen: int, real_master: bool, master_N: int,
                    E_op: torch.Tensor | None = None,
                    inputs: torch.Tensor | None = None) -> torch.Tensor:
    """Tiled channelizer: [C, olen] complex64 baseband from the master
    spectrum F [m_bins] complex64 (or [B, ld] and `inputs` [C] int32: see
    the module docstring), the tile params resp_tiles [C, S] c64 and
    tile_lo/slope/shifts [C] int32, and the IDFT matrix E [S, olen] c64.
    Equals filterbank.tiled_channelize (its plain version). E_op is
    channelize_operand(E, n_bins, olen), the one-shot design's form of E,
    which the caller builds once: the kernel needs it, the CPU path does
    not."""
    if F.device.type == "cpu":
        return tiled_channelize(F, resp_tiles, tile_lo, slope, shifts, E, n_bins, olen,
                                real_master, master_N, inputs)
    if F.device.type != "cuda":
        raise ValueError(f"cuda_channelize takes CPU or CUDA tensors, not {F.device}")
    C, S = resp_tiles.shape
    m_bins = master_N // 2 + 1 if real_master else master_N
    if S % _CTILE or not real_master and m_bins % _CTILE:
        raise ValueError("tile frame and complex master must be whole 128-bin tiles")
    dev = F.device
    ld = _check_spectrum(F, m_bins, inputs, C, dev)
    _check(resp_tiles, "resp_tiles", torch.complex64, (C, S), dev)
    for what, t in (("tile_lo", tile_lo), ("slope", slope), ("shifts", shifts)):
        _check(t, what, torch.int32, (C,), dev)
    _check(E, "E", torch.complex64, (S, olen), dev)
    n_pad = fold_pad(n_bins)
    if n_bins * n_bins >= 2**31:
        raise ValueError("the kernel's 32-bit ramp phase needs n_bins^2 < 2^31")
    if resp_tiles.data_ptr() % 16:
        raise ValueError("resp_tiles must start on a 16-byte boundary (16-byte loads)")
    if E_op is None:
        raise ValueError("the kernel takes the group's E_op = channelize_operand(E, n_bins, olen)")
    _check(E_op, "E_op", torch.float32, (2 * n_pad * 2 * (-(-olen // 32) * 32) * 2,), dev)
    out = torch.empty((C, olen), dtype=torch.complex64, device=dev)
    if C == 0:
        return out
    _launch_channelize(F, resp_tiles, tile_lo, slope, shifts, E, E_op, out, n_bins, real_master,
                       m_bins, ld, inputs,
                       channelize_plan(C, n_pad, olen, sm_count(dev)) == "persistent")
    return out


def _launch_channelize(F, resp_tiles, tile_lo, slope, shifts, E, E_op, out, n_bins: int,
                       real_master: bool, m_bins: int, ld: int, inputs, persistent: bool) -> None:
    """Kernel A on checked tensors, in the design given (the card tests and
    tools/channelize_designs_torch.py force each; cuda_channelize takes
    channelize_plan's)."""
    C, S = resp_tiles.shape
    nrows = -(-m_bins // _CTILE)
    w = float(np.float32(2.0 * np.pi / n_bins))
    _launch("channelize", F.device, F.data_ptr(), m_bins, ld, nrows, int(real_master),
            None if inputs is None else inputs.data_ptr(),
            resp_tiles.data_ptr(), tile_lo.data_ptr(), slope.data_ptr(), shifts.data_ptr(),
            E_op.data_ptr(), E.data_ptr(), C, S, out.shape[1], n_bins, fold_pad(n_bins), w,
            int(persistent), out.data_ptr())


def cuda_noise_est(F: torch.Tensor, shifts: torch.Tensor, nbins: int, real_master: bool,
                   master_N: int, samprate: float, inputs: torch.Tensor | None = None):
    """Noise floor of every channel: (n0 [C] float32, keys [C, 2] int32),
    the keys being the int32 views of the two order statistics. Equals
    noise.estimate_noise_keys(noise.gather_noise_bins(...)) (its plain
    version), in either window placement; F and inputs as in
    cuda_channelize. The kernel takes windows up to csrc/noise_est.cu's
    kMaxW bins; its launch fails (cudaErrorInvalidValue) beyond."""
    m_bins = master_N // 2 + 1 if real_master else master_N
    if F.device.type == "cpu":
        return estimate_noise_keys(
            gather_noise_bins(F, shifts, nbins, real_master, master_N, inputs), m_bins, samprate)
    if F.device.type != "cuda":
        raise ValueError(f"cuda_noise_est takes CPU or CUDA tensors, not {F.device}")
    tiled = noise_window_fits(nbins, real_master, master_N)
    W = -(-nbins // _CTILE) * _CTILE if tiled else nbins
    C = shifts.shape[0]
    dev = F.device
    ld = _check_spectrum(F, m_bins, inputs, C, dev)
    _check(shifts, "shifts", torch.int32, (C,), dev)
    n0 = torch.empty(C, dtype=torch.float32, device=dev)
    keys = torch.empty((C, 2), dtype=torch.int32, device=dev)
    if C == 0:
        return n0, keys
    i, has_next, w_lo, w_hi = _quantile_terms(W)
    corr = float(np.float32(noise_correction()))
    denom = float(np.float32(float(m_bins) * float(samprate)))
    _launch("noise_est", dev, F.data_ptr(), m_bins, ld, int(real_master), int(tiled),
            None if inputs is None else inputs.data_ptr(), shifts.data_ptr(),
            C, W, i, int(has_next), w_lo, w_hi, float(N_CUTOFF), corr, denom,
            n0.data_ptr(), keys.data_ptr())
    return n0, keys
