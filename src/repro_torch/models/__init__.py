"""The walk-native LM, PyTorch port of repro/models: ``layers``
(norms, rotary embeddings, MLP, embeddings), ``attention`` (GQA, MLA),
``moe`` (routed, shared and dense-residual experts), ``ssm`` (mamba,
mLSTM, sLSTM), ``transformer`` (layer specs, segments, blocks) and
``model`` (the LM API). The dense, MoE, SSM (xLSTM) and hybrid (Jamba)
families are ported; the enc-dec, VLM and audio families are refused
with ``NotImplementedError`` until ROADMAP queue 1 item 5d ports
them."""
