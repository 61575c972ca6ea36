"""The compiled dispatch: Engine.step, or D of them, as one CUDA graph replay.

The JAX package compiles every dispatch: its Engine is one jitted step
(jax.jit(eng.step, donate_argnums=0)), and the daemon's `time-shards = D`
runs D steps as a lax.scan inside one jit. PyTorch runs eagerly, Python
launching each of the step's 200-370 kernels a block. GraphStep is the
port's counterpart of that jit, wrapped around an engine as JAX callers wrap
jax.jit around eng.step:

    step = GraphStep(eng)                     # or GraphStep(eng, time_shards=D)
    state, out = step(state, params, block)   # Engine.step's contract

With time_shards=D it takes [D, L] ([D, B, L]) blocks and stacks the
outputs to [D, ...]; the graph holds all D steps (the lax.scan's twin). On
CUDA each dispatch is one replay of a graph holding exactly the kernels the
eager step launches (the master FFT, the spur notch, each group's
channelizer, N0, the recurrences, the tails, egress compaction, the front-end
power). On the CPU it is the eager step, or the D-step loop.

How it keeps the contract:
  * Static buffers, the twin of donation. The graph reads the block from a
    buffer of its own (`input_buffer()`: Radiod copies the host's block
    straight into it) and the state from tensors of its own, and writes the
    new state back into them as its last nodes. A state leaf that is not one
    of those tensors (a migrated or restored state) is copied in on the
    device before the replay.
  * Params by address. Every writer (retune, set_edges, set_demod, set_armed,
    adopt_host_params) writes rows in place; a params leaf (a shard of a
    Sharded one) that is not the tensor the graphs were captured on raises.
  * A graph per host branch. The key is Engine.branch: for each block of
    the dispatch, each group's branch as _Group.branch works it out from the
    host mirrors (its warm-up and N0 cadence, a spectrum group's `armed`
    flag), the letters the eager step dispatches on, so a key names every
    host value that changes the launched sequence or a scalar baked into a
    launch. The host mirrors (state["host"]) advance on the host
    (Engine.advance_host), as the eager step advances them. A block whose
    launches would freeze a per-block host scalar runs eagerly, for the
    reason _Group.branch gives (a spectrum group's frame warm-up weighs each
    frame by 1/(n+1) from the host's frame count); graph_stats() counts
    every eager block by its reason.
  * Outputs live in the graph's own tensors, and the next replay of that
    graph overwrites them: a caller that keeps outputs across dispatches
    copies them first (Radiod._fetch_out does).
  * Launch counts. The kernel wrappers count a launch in Python, where they
    launch: a capture records (ops/cuda_channelize.py recording(), in its
    own thread) the launches its graph holds, and each replay adds them to
    the counters; the capture's warm-up run and the capture itself count
    nothing.
  * A capture runs on a side stream, after one eager run of the same branch
    (cuFFT plans, the kernels' first loads), in capture_error_mode
    "thread_local": Radiod's restock worker captures a grown engine's graphs
    in its own thread while the loop dispatches the old engine's. Each
    graph keeps a private memory pool. Python's cyclic garbage collector
    is held off while any capture is under way (_gc_held): a collection
    there finalizes unreachable objects, and freeing a dropped graph, its
    pool or pinned host memory inside a capture invalidates it
    (cudaErrorStreamCaptureInvalidated; seen when daemons are built one
    after another in a process). A capture that fails raises, naming the
    last torch call it entered; no dispatch falls back to the eager step.

emulate=True runs the static-buffer body without a graph (on the CPU, for
the tests): a key's first dispatch keeps its outputs, and later dispatches
of that key overwrite them in place, as replays do.

A mesh engine of one process (parallel.make_mesh(), or [cuda:0] * D) is
compiled the same way, the twin of JAX's jit of the sharded step:
Engine.step's channel-sharded path (one block a dispatch) or step_time
(time-sharded, the D blocks of the mesh a dispatch) as one replay. Its
collectives are device copies and concatenations, and its graph holds
kernels A and B once a shard. The state is a tree of Sharded leaves: the
static state keeps one tensor a shard of a split leaf and one a distinct
device of a replicated leaf, and each is written back once (the shards of
[cuda:0] * D that are one tensor are not written D times). The block buffer
lies on mesh.home, and the outputs come back whole there, as the eager mesh
step gives them. A mesh whose shards lie on distinct cards dispatches
eagerly, said on stderr and counted in graph_stats()["eager_blocks"]: one
capture that spans cards (a stream forked on each, a private pool on each)
is not verified on a machine of one card. A mesh over several processes
crosses the host through torch.distributed, which a graph cannot hold:
GraphStep refuses it.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import sys
import threading
import time

import torch
from torch.overrides import TorchFunctionMode

from ..ops import cuda_channelize as _cc
from ..parallel.sharding import Sharded

__all__ = ["GraphStep", "stack_tree"]


def stack_tree(trees: list):
    """[tree, ...] of tensors -> one tree of tensors stacked on a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: stack_tree([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _flatten(tree, skip_host: bool = False, prefix: tuple = ()) -> list:
    """[(path, leaf)] of a nest of dicts in order (an empty dict is a leaf);
    skip_host leaves out the top level's "host" mirrors."""
    out = []
    for k, v in tree.items():
        if skip_host and not prefix and k == "host":
            continue
        if isinstance(v, dict) and v:
            out += _flatten(v, False, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


def _unflatten(items) -> dict:
    root: dict = {}
    for path, v in items:
        d = root
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return root


def _ptr(t):
    return t.untyped_storage().data_ptr() if torch.is_tensor(t) and t.numel() else None


def _slots(v) -> list:
    """[(d, tensor)]: the distinct tensors of a state leaf, each with the
    shard it stands for (d None for a plain tensor; Sharded.distinct)."""
    if isinstance(v, Sharded):
        return v.distinct()
    return [(None, v)] if torch.is_tensor(v) else []


def _part(v, d):
    """Shard d of a leaf (the leaf itself for d None)."""
    return v if d is None else v.shards[d]


def _own(v):
    """A static copy of a state leaf: a contiguous clone of a tensor, of
    each shard of a split Sharded leaf, or of a replicated one's first shard
    placed once a distinct device."""
    if isinstance(v, Sharded):
        if v.dim is None:
            return Sharded.replicate(v.first.clone(memory_format=torch.contiguous_format), v.mesh)
        return Sharded([None if t is None else t.clone(memory_format=torch.contiguous_format)
                        for t in v.shards], v.dim, v.mesh)
    return v.clone(memory_format=torch.contiguous_format) if torch.is_tensor(v) else v


# captures under way in the process, and whether the cyclic GC was on
# before the first of them (_gc_held)
_gc_lock = threading.Lock()
_gc_hold = {"captures": 0, "was_enabled": False}


@contextlib.contextmanager
def _gc_held():
    """No cyclic garbage collection while the block runs, nor while another
    thread's capture is under way; the collector is turned back on after
    the last one ends if it was on before the first."""
    with _gc_lock:
        if _gc_hold["captures"] == 0:
            _gc_hold["was_enabled"] = gc.isenabled()
            gc.disable()
        _gc_hold["captures"] += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_hold["captures"] -= 1
            if _gc_hold["captures"] == 0 and _gc_hold["was_enabled"]:
                gc.enable()


def _copy_in(s, v) -> None:
    """A foreign state leaf's values into the static leaf s, in place."""
    if not isinstance(s, Sharded):
        s.copy_(v)
    elif isinstance(v, Sharded) and v.mesh is s.mesh and v.dim == s.dim:
        for d, t in s.distinct():
            t.copy_(v.shards[d])
    else:
        s.copy_(v.full() if isinstance(v, Sharded) else v)


def _addresses(v):
    """Where a params leaf's data lies: a tensor's, or each shard's."""
    if isinstance(v, Sharded):
        return tuple(None if t is None else t.data_ptr() for t in v.shards)
    return v.data_ptr() if torch.is_tensor(v) else None


def _is_leaf(v) -> bool:
    return torch.is_tensor(v) or isinstance(v, Sharded)


class _LastCall(TorchFunctionMode):
    """Remembers the last torch call entered, to name a failed capture's."""

    def __init__(self):
        super().__init__()
        self.name = "(no torch call)"

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.name = getattr(func, "__qualname__", None) or repr(func)
        return func(*args, **(kwargs or {}))


def _pool_bytes(pool) -> "int | None":
    """Bytes of the caching allocator's segments in a graph's private pool
    (None where the allocator's snapshot does not name pools)."""
    total = 0
    for seg in torch.cuda.memory_snapshot():
        if "segment_pool_id" not in seg:
            return None
        if tuple(seg["segment_pool_id"]) == tuple(pool):
            total += seg["total_size"]
    return total


class _Graph:
    """One captured branch: the graph (None when emulated), its output
    tree and flat leaves, and what graph_stats() reports of it."""

    __slots__ = ("graph", "outs", "leaves", "launches", "capture_ms", "pool_bytes", "replays")

    def __init__(self, graph, outs, launches: dict, pool_bytes):
        self.graph = graph
        self.outs = outs
        self.leaves = [v for _, v in _flatten(outs)]
        self.launches = launches
        self.capture_ms = 0.0
        self.pool_bytes = pool_bytes
        self.replays = 0


class GraphStep:
    """Engine.step (time_shards=D: D of them) as one CUDA graph replay a
    dispatch; the module docstring says how. graph_stats() reports the
    captures, replays and eager blocks."""

    def __init__(self, eng, time_shards: int = 0, emulate: bool = False):
        mesh = eng.mesh
        if mesh is not None and mesh.multiproc:
            raise ValueError("a mesh engine dispatches eagerly (Engine.step, step_time): its "
                             "collectives cross the host, which a CUDA graph cannot hold")
        if eng.time_shards and int(time_shards) != eng.time_shards:
            raise ValueError(f"a time-sharded engine runs its {eng.time_shards} blocks a dispatch "
                             f"through step_time: pass time_shards={eng.time_shards}")
        self.eng = eng
        self.D = int(time_shards)
        self.emulate = bool(emulate)
        # (b): a mesh over distinct cards keeps the eager dispatch, counted
        self._eager_why = None
        if (mesh is not None and not self.emulate and eng.device.type == "cuda"
                and len({mesh.devices[d] for d in mesh.local}) > 1):
            self._eager_why = "mesh over distinct cards (one capture across cards is unverified)"
            print(f"GraphStep: {mesh} dispatches eagerly: a {self._eager_why}", file=sys.stderr,
                  flush=True)
        self.graphs: dict[str, _Graph] = {}
        self._static = self._storages = self._param_ptrs = None
        self._block = None
        self.replays = 0
        self.copies_in = 0  # dispatches that copied a foreign state in first
        self.capture_ms: list[float] = []
        self.eager_blocks: collections.Counter = collections.Counter()

    @property
    def compiled(self) -> bool:
        """Whether dispatches replay graphs (on CUDA, or emulated); else eager."""
        return self._eager_why is None and (self.emulate or self.eng.device.type == "cuda")

    # -- the eager step -----------------------------------------------------
    def eager(self, state, params, block):
        """The eager dispatch: Engine.step, a time-sharded mesh engine's
        step_time, or the loop of D steps whose outputs stack to [D, ...].
        What runs on the CPU, for a block that cannot be graphed, and where
        a caller asks for the eager path."""
        if self.eng.time_shards:
            return self.eng.step_time(state, params, block)
        if not self.D:
            return self.eng.step(state, params, block)
        outs = []
        for d in range(self.D):
            state, out = self.eng.step(state, params, block[d])
            outs.append(out)
        return state, stack_tree(outs)

    # -- keys ---------------------------------------------------------------
    def _advance(self, host: dict) -> dict:
        for _ in range(max(self.D, 1)):
            host = self.eng.advance_host(host)
        return host

    def key(self, host: dict) -> tuple:
        """(key, None) for a dispatch from these host mirrors, or (None,
        reason) where it must run eagerly: Engine.branch over the
        dispatch's blocks, each block's branch a letter a group in the
        engine's order ("/" between blocks; _Group.branch says what each
        letter means), the letters the eager step dispatches on."""
        return self.eng.branch(host, max(self.D, 1))

    # -- static buffers -----------------------------------------------------
    def input_buffer(self) -> torch.Tensor:
        """The block the graphs read: [L] ([B, L]; [D, ...] with time shards)
        of the master's type on the engine's device."""
        if self._block is None:
            eng = self.eng
            shape = (((self.D,) if self.D else ()) + ((eng.n_inputs,) if eng.n_inputs > 1 else ())
                     + (eng.L,))
            dtype = torch.float32 if eng.master.real else torch.complex64
            self._block = torch.zeros(shape, dtype=dtype, device=eng.device)
        return self._block

    def _bind(self, state, params) -> None:
        """Make the static state on first use (copies of state's leaves),
        later copy in every leaf of `state` that is not a static one; hold
        the params leaves (each shard of a Sharded one) to the addresses of
        the first dispatch."""
        items = dict(_flatten(state, skip_host=True))
        if self._static is None:
            self._static = {p: _own(v) for p, v in items.items()}
            self._storages = {_ptr(t) for v in self._static.values() for _, t in _slots(v)} - {None}
        else:
            if items.keys() != self._static.keys():
                raise ValueError("the state does not have the structure this engine's step made")
            copied = False
            for p, s in self._static.items():
                v = items[p]
                if v is s or not _is_leaf(s):
                    continue
                if v.shape != s.shape or v.dtype != s.dtype:
                    raise ValueError(f"state leaf {'/'.join(p)}: {v.dtype}{tuple(v.shape)}, the "
                                     f"step carries {s.dtype}{tuple(s.shape)}")
                _copy_in(s, v)
                copied = True
            self.copies_in += copied
        ptrs = [(p, _addresses(v)) for p, v in _flatten(params)]
        if self._param_ptrs is None:
            self._param_ptrs = ptrs
        elif ptrs != self._param_ptrs:
            bad = next((a for a, b in zip(ptrs, self._param_ptrs) if a != b), ptrs[0])
            raise ValueError(f"params leaf {'/'.join(bad[0])} is not the tensor the step's graphs "
                             "read: a writer replaced it (params are written in place)")

    def _state(self, host: dict) -> dict:
        return _unflatten(list(self._static.items()) + [(("host",), host)])

    def _write_back(self, st: dict, out: dict) -> dict:
        """The new state into the static tensors, in place: each distinct
        tensor once (a Sharded leaf's from the shard it stands for). A new
        leaf that shares memory with a static tensor is copied first, so no
        write reads what another overwrites, and so is an output (no output
        aliases the state). Returns the outputs."""
        new = dict(_flatten(st, skip_host=True))
        if new.keys() != self._static.keys():
            raise ValueError("the step returned a state of another structure than it took")
        writes = []
        for p, s in self._static.items():
            v = new[p]
            if v is s or not _is_leaf(s):
                continue
            if (v.shape != s.shape or v.dtype != s.dtype
                    or isinstance(v, Sharded) != isinstance(s, Sharded)
                    or isinstance(s, Sharded) and v.dim != s.dim):
                raise ValueError(f"step returned state leaf {'/'.join(p)} as "
                                 f"{v.dtype}{tuple(v.shape)} placed {getattr(v, 'dim', '-')}, "
                                 f"carried as {s.dtype}{tuple(s.shape)} placed "
                                 f"{getattr(s, 'dim', '-')}")
            for d, t in _slots(s):
                src = _part(v, d)
                if src is not t:
                    writes.append((t, src.clone() if _ptr(src) in self._storages else src))
        out = _unflatten([(p, v.clone() if _ptr(v) in self._storages else v)
                          for p, v in _flatten(out)])
        for t, v in writes:
            t.copy_(v)
        return out

    def _body(self, params, host: dict) -> dict:
        """What a graph holds: the step(s) from the static state and block,
        then the new state written back. Returns the outputs."""
        return self._write_back(*self.eager(self._state(host), params, self.input_buffer()))

    # -- capture and replay -------------------------------------------------
    def _capture(self, key: str, params, host: dict) -> _Graph:
        """Capture key's branch (emulated: run it, this dispatch's result)."""
        t0 = time.perf_counter()
        if self.emulate:
            g = _Graph(None, self._body(params, host), {}, None)
            g.replays = 1
            self.replays += 1
        else:
            g = self._capture_cuda(key, params, host)
        g.capture_ms = (time.perf_counter() - t0) * 1e3
        self.capture_ms.append(g.capture_ms)
        return g

    def _capture_cuda(self, key: str, params, host: dict) -> _Graph:
        dev = self.eng.device
        cur = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(device=dev)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        last = _LastCall()
        try:
            with torch.cuda.stream(side):
                # the same branch once eagerly (its results dropped, its
                # launches counted nowhere): cuFFT plans and the kernels'
                # first loads happen outside the capture
                with _cc.recording():
                    self.eager(self._state(host), params, self.input_buffer())
                with _cc.recording() as launches, _gc_held():
                    graph.capture_begin(capture_error_mode="thread_local")
                    try:
                        with last:
                            outs = self._body(params, host)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except Exception:
                            pass
                        raise
                    graph.capture_end()
        except Exception as e:
            raise RuntimeError(f"capturing the step's branch {key!r} failed in {last.name}: "
                               f"{e}") from e
        cur.wait_stream(side)
        return _Graph(graph, outs, {k: n for k, n in launches.items() if n},
                      _pool_bytes(graph.pool()))

    def _replay(self, g: _Graph, params, host: dict) -> None:
        if g.graph is None:
            for dst, src in zip(g.leaves, [v for _, v in _flatten(self._body(params, host))]):
                if dst is not src:
                    dst.copy_(src)
        else:
            g.graph.replay()
            for k, n in g.launches.items():
                _cc.launches[k] += n
        g.replays += 1
        self.replays += 1

    def __call__(self, state, params, block):
        if self._eager_why is not None:
            self.eager_blocks[self._eager_why] += max(self.D, 1)
            return self.eager(state, params, block)
        if not self.compiled:
            return self.eager(state, params, block)
        host = state["host"]
        key, why = self.key(host)
        if why is not None:
            self.eager_blocks[why] += max(self.D, 1)
            return self.eager(state, params, block)
        self._bind(state, params)
        buf = self.input_buffer()
        if block is not buf:
            block = torch.as_tensor(block)
            if tuple(block.shape) != tuple(buf.shape):
                raise ValueError(f"block of shape {tuple(block.shape)}: the step takes "
                                 f"{tuple(buf.shape)}")
            buf.copy_(block, non_blocking=True)
        g = self.graphs.get(key)
        if g is None:
            g = self.graphs[key] = self._capture(key, params, host)
            if g.graph is not None:
                self._replay(g, params, host)
        else:
            self._replay(g, params, host)
        return self._state(self._advance(host)), g.outs

    def prepare(self, state, params) -> int:
        """Capture, before the first dispatch, the graphs that dispatches
        from `state` will certainly meet: the next dispatches' cadence
        patterns (the master's warm-up and the N0 cadence) under the
        spectrum groups' armed flags as they are, and under each spectrum
        group's flag flipped. Returns the graphs captured (0 when not on
        CUDA: an emulated capture is a dispatch)."""
        if self.emulate or not self.compiled:
            return 0
        self._bind(state, params)
        eng, host = self.eng, state["host"]
        dispatches = -(-eng.warmup_blocks // max(self.D, 1)) + eng.noise_every
        n0 = len(self.graphs)
        for flip in [None] + [n for n, g in eng.groups.items() if g.spec.demod == "spectrum"]:
            armed = flip is not None and eng.groups[flip].branch(host["groups"][flip], 0)[0] != "i"
            if flip is not None:
                eng.set_armed(params, flip, not armed)
            try:
                h = host
                for _ in range(dispatches):
                    key, _ = self.key(h)
                    if key is not None and key not in self.graphs:
                        self.graphs[key] = self._capture(key, params, h)
                    h = self._advance(h)
            finally:
                if flip is not None:
                    eng.set_armed(params, flip, armed)
        return len(self.graphs) - n0

    def reset(self) -> None:
        """Release every graph (its private pool goes with its last tensor)
        and the static buffers."""
        for g in self.graphs.values():
            if g.graph is not None:
                g.graph.reset()
        self.graphs.clear()
        self._static = self._storages = self._param_ptrs = self._block = None

    def graph_stats(self) -> dict:
        """How the dispatches ran: captures and their ms, replays, eager
        blocks by reason, state copies in, and per graph (by key) its
        replays, capture ms, private pool bytes and launches a replay."""
        return {
            "dispatch": ("cuda graph" if self.compiled and not self.emulate
                         else "emulated" if self.emulate else "eager"),
            "time_shards": self.D,
            "captures": len(self.capture_ms),
            "capture_ms": list(self.capture_ms),
            "replays": self.replays,
            "eager_blocks": dict(self.eager_blocks),
            "state_copies_in": self.copies_in,
            "graphs": {k: {"replays": g.replays, "capture_ms": g.capture_ms,
                           "pool_bytes": g.pool_bytes, "launches": dict(g.launches)}
                       for k, g in self.graphs.items()},
        }
