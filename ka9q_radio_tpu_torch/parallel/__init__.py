"""Scale-out: the mesh, sharded values and the sharded engine's transforms.

The reference parallelizes with one thread a channel on one host (SURVEY.md
section 2.5); here the channel axis of every group is split over a mesh of
devices, and the master transform is computed distributed
(parallel/master.py) or, time-sharded, one block a device
(parallel/timeshard.py). One process drives every device (module
parallel/sharding.py says how shards and collectives are held).
"""
from .sharding import (CHANNEL_AXIS, Mesh, Sharded, engine_sharding_tree, make_mesh,
                       shard_engine_tree)

__all__ = ["make_mesh", "shard_engine_tree", "engine_sharding_tree", "CHANNEL_AXIS", "Mesh",
           "Sharded"]
