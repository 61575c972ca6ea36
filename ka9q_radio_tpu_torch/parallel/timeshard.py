"""Time-axis sharding with halo exchange (SURVEY section 2.5 P5).

The overlap-save master keeps an (M-1)-sample context between blocks; the
reference carries it in its mirror ring (filter.c:245-264). When D
consecutive input blocks are transformed at once, one on each device of a
mesh, that context becomes a halo along the time axis: device d needs the
last M-1 samples of device d-1's block. A ppermute moves exactly that halo
to the neighbour, as in ring attention's halo exchange.

batch_master_fft(): [D, L] blocks (one per device) -> D master spectra, one
ppermute a batch, bit for bit the spectra of D sequential master_fft steps.
"""
from __future__ import annotations

import torch

from ..ops.filterbank import MasterConfig, master_transform
from .sharding import Mesh, Sharded, ppermute

__all__ = ["batch_master_fft"]


def batch_master_fft(cfg: MasterConfig, tail, blocks, mesh: Mesh, axis: str = "c"):
    """Run D master FFTs at once, one block per device.

    Args:
      cfg: master geometry (L, M, real).
      tail: [M-1] carried context (the halo from the previous call), a
        tensor or a replicated Sharded; an engine of several inputs passes
        [B, M-1], and the exchange and the transform batch over B.
      blocks: [D, L] (or [D, B, L]) consecutive input blocks, a tensor
        (split here, block d to device d) or a Sharded split over axis 0.
      mesh/axis: the mesh; D = mesh.shape[axis].

    Returns (new_tail, F): F a Sharded [D, bins] (or [D, B, bins]) split
    over blocks, F[d] identical to the d-th sequential master_fft's; and the
    new carried tail (the last block's end), replicated.
    """
    D = mesh.shape[axis]
    L, halo = cfg.L, cfg.M - 1
    if not isinstance(blocks, Sharded):
        blocks = Sharded.split(torch.as_tensor(blocks), mesh, 0)
    blks = [b[0] for b in blocks.shards]  # [(B,) L] on device d
    mine = [b[..., L - halo:] for b in blks]
    # neighbour exchange: my block end -> device d+1 (device 0 takes the
    # carried tail instead of the ring's wrap entry)
    prev = ppermute(mine, mesh, [(i, (i + 1) % D) for i in range(D)])
    t0 = tail.shards[0] if isinstance(tail, Sharded) else torch.as_tensor(tail)
    prev[0] = t0.to(mesh.devices[0])
    F = [master_transform(cfg, torch.cat([p, b], dim=-1))[None] for p, b in zip(prev, blks)]
    new_tail = Sharded.replicate(mine[D - 1].clone(), mesh)
    return new_tail, Sharded(F, 0, mesh)
