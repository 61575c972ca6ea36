#!/usr/bin/env python
"""Ablation of the port's distributed master FFT, DigitMaster.fft_natural
(ka9q_radio_tpu_torch/parallel/master.py): the twin of tools/prof_master.py.

Each case runs the whole six-step transform with some parts made identity,
so a part's cost is the difference of two cases:
  full        fft_natural as the engine runs it;
  turns       the three corner turns alone (stages and twiddle identity);
  no_tw       everything but the twiddle multiply (its cost: full - no_tw);
  casc1_only  the turns and stage 1 (the [n1, cols] FFT over its rows, the
              strided transform with its transposes, as the engine runs it);
  casc1_nt    the turns and stage 1 over the last axis of the same buffer
              (the same work, contiguous: the transposes' cost is
              casc1_only - casc1_nt);
  casc2_only  the turns and stage 2 (the [rows, n2] FFT) alone.
The stages are torch.fft (cuFFT on the card); the TPU's split_fft_mxu is
not ported. Each case is timed with CUDA events over R passes of K
distinct real blocks of N samples (the host's clock on the CPU), best of
3 after 2 warm passes, every pass's first 64 bins folded into a checksum.

    python tools/prof_master_torch.py [--device cuda|cpu]

runs N = 3,240,000 (the flagship's real master) on make_mesh() and on 4
shards of the first device, and prints one JSON line a mesh. It imports
only the port.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N_FLAGSHIP = 3_240_000
CASES = {  # stage1, stage2, twiddle, stage 1 strided (as the engine runs it)
    "full": (True, True, True, True),
    "turns": (False, False, False, True),
    "no_tw": (True, True, False, True),
    "casc1_only": (True, False, False, True),
    "casc1_nt": (True, False, False, False),
    "casc2_only": (False, True, False, True),
}


def pipeline(dm, x, stage1=True, stage2=True, tw=True, strided=True) -> list:
    """fft_natural of real samples x [N] with the parts switched off made
    identity: each device's shard of the natural-order output. With every
    part on it is DigitMaster.fft_natural itself."""
    from ka9q_radio_tpu_torch.parallel.sharding import all_to_all, each

    mesh, n1, cols = dm.mesh, dm.n1, dm.cols
    At = all_to_all(dm._in_shards(x, False), mesh, split_dim=-1, concat_dim=-2)  # [n1, cols]
    A1 = each(mesh, lambda d, a: a.to(torch.complex64), At)
    if stage1 and strided:
        A1 = each(mesh, lambda d, a: torch.fft.fft(a, dim=-2), A1)
    elif stage1:
        A1 = each(mesh, lambda d, a: torch.fft.fft(a.reshape(cols, n1), dim=-1).reshape(n1, cols),
                  A1)
    if tw:
        A1 = each(mesh, lambda d, a, t: a * t, A1, dm._tw)
    Bt = all_to_all(A1, mesh, split_dim=-2, concat_dim=-1)  # [rows, n2]
    C = each(mesh, lambda d, b: torch.fft.fft(b, dim=-1), Bt) if stage2 else Bt
    return dm.natural(C)


def time_case(dm, blocks: torch.Tensor, case: str, reps: int, warm: int = 2,
              spans: int = 3) -> float:
    """ms a block of one case: the best span of reps passes over the blocks."""
    from bench_torch import best_span_ms

    dev = blocks.device

    def span() -> torch.Tensor:
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(reps):
            for x in blocks:
                out = pipeline(dm, x, *CASES[case])
                acc = acc + out[0][:64].abs().sum().to(dev)
        return acc

    return best_span_ms(span, dev, warm, spans)[0] / (reps * len(blocks))


def profile(mesh, N: int = N_FLAGSHIP, k: int = 8, reps: int = 4, seed: int = 0) -> dict:
    """Every case on one mesh: one JSON record."""
    from ka9q_radio_tpu_torch.parallel.master import DigitMaster

    dm = DigitMaster.plan(mesh, mesh.axis_names[0], N, real=True)
    gen = torch.Generator(device=mesh.home).manual_seed(seed)
    blocks = torch.randn((k, N), generator=gen, device=mesh.home) * 1e-3
    return {"N": N, "D": dm.D, "n1": dm.n1, "n2": dm.n2, "kept_pad": dm.kept_pad,
            "devices": [str(d) for d in mesh.devices], "blocks": k, "reps": reps,
            "ms": {case: time_case(dm, blocks, case, reps) for case in CASES}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None)
    a = ap.parse_args(argv)
    from bench_torch import card
    from ka9q_radio_tpu_torch.parallel import make_mesh
    from ka9q_radio_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    cuda = device.type == "cuda"
    dev0 = torch.device("cuda", 0) if cuda else device
    meshes = {"make_mesh()": make_mesh() if cuda else make_mesh([dev0]),
              "4 shards": make_mesh([dev0] * 4)}
    name = card() if cuda else None
    for label, mesh in meshes.items():
        print(json.dumps({"mesh": label, **profile(mesh), "card": name}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
