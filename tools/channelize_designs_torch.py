"""Kernel A's two designs side by side on the card, at n 300 / olen 240 on the
flagship's 129.6 Msps real master (examples/radiod@rx888-wspr.conf): for each
channel count, each design against the plain `tiled_channelize` (the largest
error over the largest output), two launches compared bit for bit, and the
device ms of a launch (CUDA events around a CUDA graph of 20 launches), with
`channelize_plan`'s choice beside. One JSON line a channel count.

    python tools/channelize_designs_torch.py [--channels 1000 4000 8448 16000 32728]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ka9q_radio_tpu_torch.ops import cuda_channelize as cc  # noqa: E402
from ka9q_radio_tpu_torch.ops import filterbank as fb  # noqa: E402
from ka9q_radio_tpu_torch.ops.filter_design import design_bandpass_response  # noqa: E402

MASTER_N, N_BINS, OLEN = 3_240_000, 300, 240


def flagship_args(C: int, device, seed: int = 0) -> tuple:
    """Tile params of C USB channels spread over 2.6-62 MHz of the real
    master, random spectrum: (F, resp_tiles, tile_lo, slope, shifts, E, E_op)
    on `device`."""
    rng = np.random.default_rng(seed)
    m_bins = MASTER_N // 2 + 1
    r = design_bandpass_response(N_BINS, OLEN, 50 / 12e3, 3e3 / 12e3, 11.0, True, MASTER_N)
    resp = (r[None, :] * np.exp(1j * rng.uniform(0, 2 * np.pi, (C, 1)))).astype(np.complex64)
    shifts = np.linspace(65_000, 1_550_000, C).astype(np.int32)
    rt, tl, sl = fb.build_tile_params(resp, shifts, True, MASTER_N)
    E = fb.tiled_idft_matrix(N_BINS, OLEN, rt.shape[-1])
    F = (rng.standard_normal(m_bins) + 1j * rng.standard_normal(m_bins)).astype(np.complex64)
    args = [torch.as_tensor(a, device=device) for a in (F, rt, tl, sl, shifts, E)]
    return (*args, cc.channelize_operand(args[5], N_BINS, OLEN))


def launch(args, out, persistent: bool) -> None:
    F, rt, tl, sl, shifts, E, op = args
    cc._launch_channelize(F, rt, tl, sl, shifts, E, op, out, N_BINS, True, MASTER_N // 2 + 1, 0,
                          None, persistent)


def settle(what: str, seconds: float = 20.0) -> None:
    """Wait for the card's queue; a launch still running after `seconds`
    (a kernel that never finishes) ends the process, which frees the card."""
    ev = torch.cuda.Event()
    ev.record()
    t0 = time.monotonic()
    while not ev.query():
        if time.monotonic() - t0 > seconds:
            print(json.dumps({"hung": what}), flush=True)
            os._exit(4)
        time.sleep(0.001)


def graph_ms(fn, n: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    graph.replay()
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--channels", type=int, nargs="+", default=[1000, 4000, 8448, 16000, 32728])
    ap.add_argument("--reps", type=int, default=1, help="timings of each design at each C")
    a = ap.parse_args(argv)
    dev = torch.device("cuda")
    cc.build()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    sms = cc.sm_count(dev)
    for C in a.channels:
        args = flagship_args(C, dev, seed=C)
        want = fb.tiled_channelize(*args[:6], N_BINS, OLEN, True, MASTER_N)
        scale = float(want.abs().max())
        row = {"C": C, "plan": cc.channelize_plan(C, cc.fold_pad(N_BINS), OLEN, sms), "sms": sms,
               "card": card}
        for name, persistent in (("one-shot", False), ("persistent", True)):
            outs = [torch.empty((C, OLEN), dtype=torch.complex64, device=dev) for _ in range(2)]
            for o in outs:
                launch(args, o, persistent)
                settle(f"{name} at C {C}")
            row[name] = {"err": float((outs[0] - want).abs().max()) / scale,
                         "bit_equal": bool(torch.equal(outs[0], outs[1])),
                         "ms": [graph_ms(lambda o=outs[0], p=persistent: launch(args, o, p))
                                for _ in range(a.reps)]}
        print(json.dumps(row), flush=True)
        del args, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
