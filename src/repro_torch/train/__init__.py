"""Training-side state, PyTorch port of repro/train: so far the
checkpoint writer (``checkpoint``) with the sharded-window checkpoints.
The embeddings, the optimiser and the training loop are not ported yet."""
