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
* sharding — the sharding plans: the partition spec of every parameter,
  moment, batch tensor and decode-state leaf on a mesh, as pure
  functions.
* pipeline — ``gpipe_forward``, the GPipe schedule over a
  ``ShardGroup``, and ``sequential_reference``.

The package imports ``sharding`` and ``pipeline``, which import nothing
of the walker, and no other module: ``core/distributed.py`` imports
``collectives`` from it and ``streaming_shard`` imports
``core/distributed.py``, so an import of those here would be circular.
"""
from repro_torch.distributed import pipeline, sharding  # noqa: F401
