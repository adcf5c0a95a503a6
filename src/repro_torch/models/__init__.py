"""The walk-native LM, PyTorch port of repro/models: ``layers``
(norms, rotary embeddings, MLP, embeddings), ``attention`` (GQA, MLA),
``moe`` (routed, shared and dense-residual experts), ``transformer``
(layer specs, segments, blocks) and ``model`` (the LM API). The dense
and MoE families are ported; the SSM kinds and the enc-dec, VLM and
audio families are refused with ``NotImplementedError`` until ROADMAP
queue 1 items 5c–5d port them."""
