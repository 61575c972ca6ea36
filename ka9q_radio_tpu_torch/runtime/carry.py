"""Carry the JAX engine's params and state across to the port.

`params_from_jax` and `state_from_jax` turn the JAX engine's params and
state trees, fetched to numpy (jax.device_get), into the port's tensors, so
both packages compute from the same starting point. The state's host
mirrors (block counter, warm-up countdowns, the wide and narrowband
spectrum groups' frame counts) are read from the numpy values here, once,
off the hot path. Every demodulator's state tree (linear with its PLL, FM
with its Goertzel, WFM, both spectra) carries over leaf for leaf.
"""
from __future__ import annotations

import numpy as np

from ..utils.device import resolve_device, to_tensors

__all__ = ["params_from_jax", "state_from_jax"]


def params_from_jax(tree, device=None):
    """JAX engine params (numpy tree) -> the port's params on `device`."""
    return to_tensors(tree, resolve_device(device))


def state_from_jax(tree, device=None):
    """JAX engine state (numpy tree) -> the port's state on `device`, with
    its host mirrors."""
    state = to_tensors(tree, resolve_device(device))
    groups = {}
    for name, g in tree["groups"].items():
        frames = g["demod"].get("frames")
        groups[name] = {"warmup": int(np.asarray(g["dc"]["warmup"])),
                        "frames": 0 if frames is None else int(np.asarray(frames))}
    state["host"] = {"jobnum": int(np.asarray(tree["master"]["jobnum"])), "groups": groups}
    return state
