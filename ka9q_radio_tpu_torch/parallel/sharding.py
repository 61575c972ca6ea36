"""The mesh, sharded values and the collectives of the sharded engine.

The JAX package's mesh is single-controller: one process drives every
device. This port keeps that model. A `Mesh` is an ordered list of
torch.devices with one axis name, "c". A sharded value (`Sharded`) is a list
of per-device shards: a channel-axis leaf is split into C/D rows, the column
layout of the master tail into column blocks, and every other leaf is
replicated (one copy a device; devices that are the same device share one
tensor).

The collectives are written as explicit copies between the shards, each
with the same result as its JAX namesake (all_to_all, all_gather,
psum_scatter, psum, ppermute). A copy is `Tensor.to(dev, non_blocking=True)`
on the current streams of both devices; PyTorch orders a copy between two
cards with events on those streams, so no shard reads a piece before it has
arrived. On distinct cards these are peer copies; on a mesh that names one
card D times ([cuda:0] * D) the pieces stay where they are and the
concatenations are device-local copies. The bodies that JAX writes under
shard_map are loops over the shards here, each launch on its shard's device.

Policy (engine_sharding_tree): a leaf splits over the channel axis iff its
key path passes through a group-name key and its leading dimension equals
that group's channel count; the master tail of a column-layout engine
(Engine.digit_cols) splits over its last axis; every other leaf replicates.
A time-sharded engine replicates everything.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

CHANNEL_AXIS = "c"

__all__ = ["Mesh", "Sharded", "make_mesh", "engine_sharding_tree", "shard_engine_tree",
           "local_tree", "full_tree", "reassemble", "place_like", "write_row", "CHANNEL_AXIS",
           "all_to_all", "all_gather", "psum_scatter", "psum", "ppermute"]


class Mesh:
    """A 1-D mesh: an ordered list of devices with one axis name."""

    def __init__(self, devices: Sequence, axis: str = CHANNEL_AXIS):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis_names = (axis,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {self.axis_names[0]: self.size}

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis_names[0]!r})"


def make_mesh(devices=None, axis: str = CHANNEL_AXIS) -> Mesh:
    """A 1-D mesh over every local CUDA device, or over `devices` (e.g.
    ["cpu"] * 4 in the tests, [torch.device("cuda", 0)] * 4 to run four
    shards on one card). With no argument it needs CUDA: the port never
    builds a CPU mesh on its own."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() takes every local CUDA device and there is none; "
                               "pass devices=[...] (e.g. ['cpu'] * 4) for a host mesh")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices, axis)


def _put(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t on dev: a copy where it moves (non-blocking onto a card; a copy to
    the host waits for its data), t itself where not."""
    return t.to(dev, non_blocking=dev.type == "cuda")


class Sharded:
    """A value spread over a mesh: `shards[d]` lies on mesh.devices[d].

    dim None: replicated (every shard holds the whole value); else the
    value is the concatenation of the shards along `dim`. The global view
    (`full`, `shape`, `cpu`, `copy_`) lets host code (checkpoints, tests)
    treat it like one tensor."""

    __slots__ = ("shards", "dim", "mesh")

    def __init__(self, shards: list, dim: "int | None", mesh: Mesh):
        if len(shards) != mesh.size:
            raise ValueError(f"{len(shards)} shards for a mesh of {mesh.size}")
        self.shards = list(shards)
        self.dim = dim
        self.mesh = mesh

    # -- construction --------------------------------------------------------
    @classmethod
    def split(cls, t: torch.Tensor, mesh: Mesh, dim: int) -> "Sharded":
        """t split into D equal blocks along dim, block d to device d."""
        D = mesh.size
        if t.shape[dim] % D:
            raise ValueError(f"dimension {dim} of {tuple(t.shape)} does not divide into {D} shards")
        base = t.untyped_storage().data_ptr() if t.numel() else None
        shards = []
        for p, dev in zip(torch.chunk(t, D, dim=dim), mesh.devices):
            q = _put(p, dev)
            if q.numel() and q.untyped_storage().data_ptr() == base:
                q = q.clone(memory_format=torch.contiguous_format)  # a shard of its own
            shards.append(q.contiguous())
        return cls(shards, dim, mesh)

    @classmethod
    def replicate(cls, t: torch.Tensor, mesh: Mesh) -> "Sharded":
        """t on every device of the mesh; devices that are one device share
        one tensor."""
        by_dev: dict = {}
        shards = []
        for dev in mesh.devices:
            if dev not in by_dev:
                by_dev[dev] = _put(t, dev)
            shards.append(by_dev[dev])
        return cls(shards, None, mesh)

    def like(self, t: torch.Tensor) -> "Sharded":
        """A global tensor t placed as this value is."""
        return (Sharded.replicate(t, self.mesh) if self.dim is None
                else Sharded.split(t, self.mesh, self.dim))

    # -- global view ---------------------------------------------------------
    def unique(self) -> list:
        """The distinct shard tensors (a replicated value on one device
        counts once)."""
        seen: dict = {}
        for s in self.shards:
            seen.setdefault(id(s), s)
        return list(seen.values())

    def full(self, device=None) -> torch.Tensor:
        """The global value on `device` (default: the first device)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        if self.dim is None:
            return _put(self.shards[0], dev)
        return torch.cat([_put(s, dev) for s in self.shards], dim=self.dim)

    @property
    def shape(self) -> torch.Size:
        s = list(self.shards[0].shape)
        if self.dim is not None:
            s[self.dim] *= len(self.shards)
        return torch.Size(s)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def cpu(self) -> torch.Tensor:
        return self.full("cpu")

    def copy_(self, src: torch.Tensor) -> "Sharded":
        """Write a global value into the shards in place."""
        if self.dim is None:
            for s in self.unique():
                s.copy_(src)
            return self
        for s, part in zip(self.shards, torch.chunk(src, len(self.shards), dim=self.dim)):
            s.copy_(part)
        return self

    # -- in-place row surgery (retune, set_edges, set_demod) -----------------
    def _owner(self, idx: int) -> tuple[list, int]:
        """(shard tensors to write, local index) of global row idx."""
        if self.dim is None:
            return self.unique(), idx
        if self.dim != 0:
            raise ValueError("row writes need a value split over its leading axis")
        rows = self.shards[0].shape[0]
        return [self.shards[idx // rows]], idx % rows

    def write_row(self, idx: int, value) -> None:
        """Row idx (global) = value, in the shard that owns it (every copy
        of a replicated value)."""
        ts, i = self._owner(int(idx))
        for t in ts:
            if torch.is_tensor(value) or isinstance(value, np.ndarray):
                t[i].copy_(torch.as_tensor(value))
            else:
                t[i] = value

    def fill_(self, value) -> "Sharded":
        for s in self.unique():
            s.fill_(value)
        return self

    def __repr__(self) -> str:
        return f"Sharded(shape={tuple(self.shape)}, dim={self.dim}, D={len(self.shards)})"


def write_row(leaf, idx: int, value) -> None:
    """Row idx of a params leaf = value, in place: a tensor's row, or the
    owning shard's row of a sharded leaf."""
    if isinstance(leaf, Sharded):
        leaf.write_row(idx, value)
    elif torch.is_tensor(value) or isinstance(value, np.ndarray):
        leaf[idx].copy_(torch.as_tensor(value))
    else:
        leaf[idx] = value


def local_tree(tree, d: int):
    """Shard d's view of a tree: every Sharded leaf -> its d-th shard."""
    if isinstance(tree, dict):
        return {k: local_tree(v, d) for k, v in tree.items()}
    return tree.shards[d] if isinstance(tree, Sharded) else tree


def full_tree(tree, device=None):
    """A tree with every Sharded leaf made whole (on `device`)."""
    if isinstance(tree, dict):
        return {k: full_tree(v, device) for k, v in tree.items()}
    return tree.full(device) if isinstance(tree, Sharded) else tree


def reassemble(locals_: list, like, mesh: Mesh):
    """D per-shard trees (the outputs of a per-shard body) -> one tree of
    Sharded leaves, each placed as the leaf at the same path of `like` (a
    tree of Sharded leaves) is; a leaf `like` lacks is replicated."""
    first = locals_[0]
    if isinstance(first, dict):
        return {k: reassemble([t[k] for t in locals_],
                              like.get(k) if isinstance(like, dict) else None, mesh)
                for k in first}
    if not torch.is_tensor(first):
        return first
    return Sharded(list(locals_), like.dim if isinstance(like, Sharded) else None, mesh)


def place_like(tree, like, mesh: Mesh):
    """A tree of whole tensors placed leaf for leaf as `like` (a tree of
    Sharded leaves) is; a leaf `like` lacks is replicated."""
    if isinstance(tree, dict):
        return {k: place_like(v, like.get(k) if isinstance(like, dict) else None, mesh)
                for k, v in tree.items()}
    if not torch.is_tensor(tree):
        return tree
    return like.like(tree) if isinstance(like, Sharded) else Sharded.replicate(tree, mesh)


# -- placement policy --------------------------------------------------------
def engine_sharding_tree(engine, mesh: Mesh, tree):
    """The placement of every leaf of an engine state or params tree: 0
    (split over the channel axis), -1 (the column-layout master tail) or
    None (replicated), as a tree of the same structure (module docstring)."""
    group_C = ({} if getattr(engine, "time_shards", 0)
               else {name: g.C for name, g in engine.groups.items() if g.C % mesh.size == 0})
    digit_cols = bool(getattr(engine, "digit_cols", False))

    def pick(keys, leaf):
        shape = tuple(leaf.shape)
        if digit_cols and keys[-2:] == ["master", "tail"] and len(shape) >= 2:
            return -1
        gname = next((k for k in keys if k in group_C), None)
        if gname is not None and len(shape) >= 1 and shape[0] == group_C[gname]:
            return 0
        return None

    def walk(t, keys):
        if isinstance(t, dict):
            return {k: walk(v, keys + [k]) for k, v in t.items()}
        if torch.is_tensor(t) or isinstance(t, Sharded):
            return pick(keys, t)
        return t

    return walk(tree, [])


def shard_engine_tree(engine, mesh: Mesh, tree):
    """Place an engine state or params tree per engine_sharding_tree. Host
    values (the state's "host" ints) pass through; a leaf already placed as
    the policy says is kept as it is (so params placed by the engine keep
    their tensors, and retunes write them in place)."""
    spec = engine_sharding_tree(engine, mesh, tree)

    def place(t, dim):
        if isinstance(t, dict):
            return {k: place(v, dim[k]) for k, v in t.items()}
        if isinstance(t, Sharded):
            if t.mesh is mesh and t.dim == dim:
                return t
            t = t.full()
        if not torch.is_tensor(t):
            return t
        return Sharded.replicate(t, mesh) if dim is None else Sharded.split(t, mesh, dim)

    return place(tree, spec)


# -- collectives ---------------------------------------------------------------
def all_to_all(shards: list, mesh: Mesh, split_dim: int, concat_dim: int) -> list:
    """jax.lax.all_to_all(tiled=True): each shard splits into D blocks along
    split_dim; block d of shard e goes to device d, which concatenates the
    blocks it receives along concat_dim in shard order."""
    D = mesh.size
    pieces = [torch.chunk(s, D, dim=split_dim) for s in shards]
    return [torch.cat([_put(pieces[e][d], dev) for e in range(D)], dim=concat_dim)
            for d, dev in enumerate(mesh.devices)]


def all_gather(shards: list, mesh: Mesh, dim: int = -1) -> list:
    """jax.lax.all_gather(tiled=True): every device gets the concatenation
    of the shards along dim (computed once a distinct device)."""
    by_dev: dict = {}
    out = []
    for dev in mesh.devices:
        if dev not in by_dev:
            by_dev[dev] = torch.cat([_put(s, dev) for s in shards], dim=dim)
        out.append(by_dev[dev])
    return out


def psum_scatter(parts: list, mesh: Mesh, dim: int = 0) -> list:
    """jax.lax.psum_scatter(tiled=True): parts[e] is device e's partial
    value; device d gets block d (along dim) of their sum."""
    D = mesh.size
    pieces = [torch.chunk(p, D, dim=dim) for p in parts]
    out = []
    for d, dev in enumerate(mesh.devices):
        acc = _put(pieces[0][d], dev).clone()
        for e in range(1, D):
            acc += _put(pieces[e][d], dev)
        out.append(acc)
    return out


def psum(parts: list, mesh: Mesh) -> list:
    """jax.lax.psum: every device gets the sum of the partial values
    (computed once a distinct device)."""
    by_dev: dict = {}
    out = []
    for dev in mesh.devices:
        if dev not in by_dev:
            acc = _put(parts[0], dev).clone()
            for p in parts[1:]:
                acc += _put(p, dev)
            by_dev[dev] = acc
        out.append(by_dev[dev])
    return out


def ppermute(shards: list, mesh: Mesh, perm: Sequence[tuple[int, int]]) -> list:
    """jax.lax.ppermute: shard src goes to device dst for each (src, dst);
    a device that receives nothing gets zeros."""
    out = [None] * mesh.size
    for src, dst in perm:
        out[dst] = _put(shards[src], mesh.devices[dst])
    return [o if o is not None else torch.zeros_like(shards[d], device=mesh.devices[d])
            for d, o in enumerate(out)]
