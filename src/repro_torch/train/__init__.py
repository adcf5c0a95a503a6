"""Training side, PyTorch port of repro/train: skipgram embeddings on
streamed walks (``embeddings``), AdamW with int8 error feedback
(``optimizer``) and the leaf and sharded-window checkpoints
(``checkpoint``), and the LM's train, eval, serve and prefill steps
(``train_loop``, over ``repro_torch.models``)."""
from repro_torch.train.embeddings import (
    SkipgramState,
    init_skipgram,
    link_prediction_auc,
    skipgram_step,
    train_on_walks,
)
from repro_torch.train.optimizer import (
    AdamWConfig,
    OptState,
    apply_updates,
    compress_int8,
    global_norm,
    init_opt_state,
    lr_at,
)

__all__ = [
    "SkipgramState", "init_skipgram", "link_prediction_auc",
    "skipgram_step", "train_on_walks", "AdamWConfig", "OptState",
    "apply_updates", "compress_int8", "global_norm", "init_opt_state",
    "lr_at",
]
