"""The port's background pool restock held to the JAX daemon's: the twins of
tests/test_restock.py, each eager and through the emulated graph dispatch
(there the restock worker builds the grown engine's GraphStep in its own
thread). Each restock lands in both daemons at the same block boundary
(DaemonPair settles before every block and comparison), so the channel
tables, free slots, params and packets stay equal."""
import time

import numpy as np
import pytest
import torch

from ka9q_radio_tpu.runtime.radiod import Radiod as JRadiod
from ka9q_radio_tpu_torch.net.status import StatusType as T
from ka9q_radio_tpu_torch.runtime.radiod import Radiod as TRadiod
from test_restock import CONF
from torch_parity import FS, DaemonPair

torch.set_num_threads(2)

DISPATCH = ["eager", "graph"]


def scene(b: int, L: int, rng) -> np.ndarray:
    """The [am] section's carrier, AM at 50%, over -60 dBFS noise."""
    t = np.arange(b * L, (b + 1) * L) / FS
    x = 0.1 * (1 + 0.5 * np.cos(2 * np.pi * 800 * t)) * np.exp(2j * np.pi * 100_000 * t)
    x += 1e-3 * (rng.standard_normal(L) + 1j * rng.standard_normal(L))
    return x.astype(np.complex64)


def count_rebuilds(monkeypatch) -> dict:
    """Foreground rebuilds of each package's daemon."""
    n = {"jax": 0, "port": 0}
    for key, cls in (("jax", JRadiod), ("port", TRadiod)):
        orig = cls._rebuild

        def counting(self, specs, orig=orig, key=key):
            n[key] += 1
            return orig(self, specs)

        monkeypatch.setattr(cls, "_rebuild", counting)
    return n


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_creates_never_block_after_first(dispatch, monkeypatch):
    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=71)
    rd = pair.t
    rebuilds = count_rebuilds(monkeypatch)
    for i, ssrc in enumerate(range(5001, 5011)):
        pair.send({T.OUTPUT_SSRC: ssrc, T.RADIO_FREQUENCY: 50_000.0 + 1000 * i})
        pair.step(2)  # a pending grow lands before the second
    assert sum(1 for c in rd.chans.values() if c.dynamic) == 10
    # exactly ONE foreground rebuild in each daemon: the background restock
    # kept the pool stocked
    assert rebuilds == {"jax": 1, "port": 1}, rebuilds
    gname = next(c.group for c in rd.chans.values() if c.dynamic)
    assert rd.engine.groups[gname].C >= 12
    x = scene(rd.blocks, rd.engine.L, pair.rng)
    pair.j.step_block(block=x)
    out = rd.step_block(block=x)
    assert np.all(np.isfinite(np.asarray(out[gname]["audio"])))
    pair.check(2)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_foreground_rebuild_voids_stale_restock(dispatch, monkeypatch):
    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=72)
    rd = pair.t
    pair.send({T.OUTPUT_SSRC: 6001, T.RADIO_FREQUENCY: 60_000.0})
    pair.send({T.OUTPUT_SSRC: 6002, T.RADIO_FREQUENCY: 61_000.0})
    assert rd._restock is not None and pair.j._restock is not None  # pool low: a grow
    # a foreground rebuild (a demod-type move forces a new compiled class)
    pair.send({T.OUTPUT_SSRC: 6001, T.DEMOD_TYPE: 1})
    epoch, eng = rd._engine_epoch, rd.engine
    pair.settle()
    # the stale restock must NOT have replaced the rebuilt engine
    assert rd.engine is eng and rd._engine_epoch == epoch
    assert pair.j._restock is None and rd._restock is None
    pair.check(3)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_restock_lands_in_timeshard_no_mesh_mode(dispatch, monkeypatch):
    """time-shards WITHOUT a mesh (two blocks a dispatch): the background
    restock swap lands."""
    conf = CONF.replace("dyn-slots = 2", "dyn-slots = 2\ntime-shards = 2")
    pair = DaemonPair(conf, dispatch, monkeypatch, scene, seed=73)
    rd = pair.t
    assert rd._time_shards == 2 and rd._mesh is None
    pair.send({T.OUTPUT_SSRC: 7001, T.RADIO_FREQUENCY: 50_000.0})
    pair.send({T.OUTPUT_SSRC: 7002, T.RADIO_FREQUENCY: 51_000.0})
    assert rd._restock is not None
    gname = next(c.group for c in rd.chans.values() if c.dynamic)
    c_before = rd.engine.groups[gname].C
    pair.settle()
    assert rd._restock is None
    assert rd.engine.groups[gname].C > c_before  # the swap landed
    pair.step()
    assert rd.graph_stats()["current"]["time_shards"] == 2
    pair.check(2)


@pytest.mark.parametrize("dispatch", DISPATCH)
def test_restock_auto_provisioning(dispatch, monkeypatch):
    """The pool sizes itself from the measured create rate x restock
    latency. With a burst of creates against a slow (set) restock, the
    scheduled grow exceeds dyn-slots, and no create after the first pays
    a foreground rebuild. Both daemons read one clock that the test
    advances 20 ms a block, so both measure the same rates and schedule
    the same grows."""
    clock = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    pair = DaemonPair(CONF, dispatch, monkeypatch, scene, seed=74, fixed_pool=False)
    rd = pair.t
    pair.step()
    rebuilds = count_rebuilds(monkeypatch)
    scheduled = {"jax": [], "port": []}
    for key, cls in (("jax", JRadiod), ("port", TRadiod)):
        orig = cls._schedule_restock

        def spy(self, gname, orig=orig, key=key):
            scheduled[key].append((gname, self._pool_need(gname)))
            return orig(self, gname)

        monkeypatch.setattr(cls, "_schedule_restock", spy)
    pair.send({T.OUTPUT_SSRC: 5001, T.PRESET: "nfm", T.RADIO_FREQUENCY: 110_000.0})
    assert rebuilds == {"jax": 1, "port": 1}
    gname = rd.chans[5001].group
    # the foreground rebuild seeded this class's latency estimate (floored
    # at 30 s in both); pretend restocks take 30 s for this class
    assert rd._restock_latency.get(gname, 0.0) > 0.0
    assert rd._restock_latency == pair.j._restock_latency
    for r in (pair.j, rd):
        r._restock_latency[gname] = 30.0
    for i in range(2, 8):
        clock[0] += 0.02
        pair.send({T.OUTPUT_SSRC: 5000 + i, T.PRESET: "nfm",
                   T.RADIO_FREQUENCY: (110 + i) * 1000.0})
        pair.step()
    assert scheduled["port"] == scheduled["jax"]
    assert any(n > rd.dyn_spare for _, n in scheduled["port"]), scheduled
    assert rd.engine.groups[gname].C > 1 + rd.dyn_spare
    assert rebuilds == {"jax": 1, "port": 1}
    assert rd._restock_latency == pair.j._restock_latency
    pair.check(2)
