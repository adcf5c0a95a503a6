"""The walk-native LM, PyTorch port of repro/models: ``layers``
(norms, rotary embeddings, MLP, embeddings), ``attention`` (GQA),
``transformer`` (layer specs, segments, blocks) and ``model`` (the LM
API). The dense family is ported; MoE with MLA, the SSM kinds and the
enc-dec, VLM and audio families are refused with ``NotImplementedError``
until ROADMAP queue 1 items 5b–5d port them."""
