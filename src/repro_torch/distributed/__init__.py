"""Scale-out (DESIGN.md §10, §12, §13, §15), PyTorch port of
repro/distributed.

* placement — which shard owns a node: range, hash and skew policies.
* collectives — ``ShardGroup``, the port's stand-in for a mesh axis: D
  shards with the device of each, and their ``all_to_all``/``psum``/
  ``pmax``/``pmin``. Naming a device D times runs D shards on it.
* walks — walk-axis sharding over a replicated index.
* streaming_shard — the node-partitioned sliding window
  (``DistributedStreamingEngine``) with its live reshard, and sharded
  lane serving (``serve_lanes_sharded``, which ``repro_torch.serve``
  drives).
* fault_tolerance — ``StragglerPolicy``, ``WindowCheckpointer`` and
  ``StreamSupervisor``: sharded-window checkpoints with an elastic
  restore (``repro_torch.train.checkpoint``).

The package imports none of its modules:
``core/distributed.py`` imports ``collectives`` from it and
``streaming_shard`` imports ``core/distributed.py``, so an import here
would be circular.
"""
