"""Data: synthetic temporal graphs (``synthetic``) and walks turned into
training data (``walk_dataset``)."""
from repro_torch.data.synthetic import (
    TemporalGraph,
    chronological_batches,
    powerlaw_temporal_graph,
)
from repro_torch.data.walk_dataset import skipgram_pairs, walks_to_lm_batch

__all__ = [
    "TemporalGraph", "chronological_batches", "powerlaw_temporal_graph",
    "skipgram_pairs", "walks_to_lm_batch",
]
