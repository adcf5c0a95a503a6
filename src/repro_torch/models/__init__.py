"""The walk-native LM, PyTorch port of repro/models: ``layers``
(norms, rotary embeddings, MLP, embeddings), ``attention`` (GQA, MLA),
``moe`` (routed, shared and dense-residual experts), ``ssm`` (mamba,
mLSTM, sLSTM), ``transformer`` (layer specs, segments, blocks) and
``model`` (the LM API). Every family of the registry is ported: dense,
MoE, SSM (xLSTM), hybrid (Jamba), enc-dec (SeamlessM4T: the encoder
stack over audio frames, cross-attention) and VLM (Qwen2-VL: patch
embeddings, M-RoPE); the audio and vision frontends are the
reference's stubs, precomputed embeddings in the batch."""
