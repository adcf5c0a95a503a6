"""Scale-out (DESIGN.md §10, §12, §15), PyTorch port of repro/distributed
without its serving half.

* placement — which shard owns a node: range, hash and skew policies.
* collectives — ``ShardGroup``, the port's stand-in for a mesh axis: D
  shards with the device of each, and their ``all_to_all``/``psum``/
  ``pmax``/``pmin``. Naming a device D times runs D shards on it.
* walks — walk-axis sharding over a replicated index.
* streaming_shard — the node-partitioned sliding window
  (``DistributedStreamingEngine``) with its live reshard.

Sharded serving (the reference's ``serve_lanes_sharded`` and the sharded
snapshots) is not yet ported. The package imports none of its modules:
``core/distributed.py`` imports ``collectives`` from it and
``streaming_shard`` imports ``core/distributed.py``, so an import here
would be circular.
"""
