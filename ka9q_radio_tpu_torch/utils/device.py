"""Device selection: the port runs on CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device. None means CUDA, and raises on a host
    without it: the port never drops to the CPU on its own (pass
    device="cpu" for the plain-PyTorch path the tests use)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ka9q_radio_tpu_torch runs on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run the plain "
                "PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


def to_tensors(tree, device: torch.device):
    """A (nested dict) tree of numpy arrays -> the same tree of tensors on
    `device`, dtypes kept (bool, int32, float32, complex64; 0-d stays 0-d)."""
    if isinstance(tree, dict):
        return {k: to_tensors(v, device) for k, v in tree.items()}
    return torch.tensor(np.asarray(tree), device=device)
