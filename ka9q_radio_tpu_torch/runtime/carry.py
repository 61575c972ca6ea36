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


def _device(device, engine):
    return engine.device if engine is not None else resolve_device(device)


def _placed(tree, engine):
    """On a mesh engine, the tree placed over its mesh (shard_engine_tree)."""
    if engine is None or engine.mesh is None:
        return tree
    from ..parallel import shard_engine_tree
    return shard_engine_tree(engine, engine.mesh, tree)


def params_from_jax(tree, device=None, engine=None):
    """JAX engine params (numpy tree) -> the port's params on `device`; or,
    given the port's engine, on its device, and on a mesh engine placed
    over its mesh (the channel rows split as its own params are)."""
    return _placed(to_tensors(tree, _device(device, engine)), engine)


def state_from_jax(tree, device=None, engine=None):
    """JAX engine state (numpy tree) -> the port's state on `device` (or the
    engine's, placed over its mesh as params_from_jax does), with its host
    mirrors."""
    state = to_tensors(tree, _device(device, engine))
    groups = {}
    for name, g in tree["groups"].items():
        frames = g["demod"].get("frames")
        groups[name] = {"warmup": int(np.asarray(g["dc"]["warmup"])),
                        "frames": 0 if frames is None else int(np.asarray(frames))}
    state["host"] = {"jobnum": int(np.asarray(tree["master"]["jobnum"])), "groups": groups}
    return _placed(state, engine)
