"""The streaming walk sampler: edge store, dual index, samplers, regroup,
fused-hop walk engine, sliding window and streaming replay."""
