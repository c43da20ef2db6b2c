"""Decoder-only transformer LM.

Counterpart of ``deeplearning4j_tpu/models/transformer.py``
(``transformer_lm``), with the same defaults and the same resolved config:
Adam at the given learning rate, an ``Embedding`` layer whose activation is
the global default (``sigmoid``), causal ``TransformerBlock``s, and a softmax
``RnnOutput`` head, every layer with the global defaults baked in.
"""
from __future__ import annotations

from ..nn.conf.multilayer import (
    GlobalConf, InputType, LayerConf, MultiLayerConfiguration)


def transformer_lm(vocab_size: int, width: int = 256, n_layers: int = 4,
                   n_heads: int = 4, ffn_multiplier: int = 4,
                   max_len: int = 512, seed: int = 12345,
                   learning_rate: float = 3e-4) -> MultiLayerConfiguration:
    """Causal LM: one-hot ``[B, T, V]`` or ids ``[B, T]`` -> embedding ->
    ``n_layers`` blocks -> vocab probabilities."""
    g = GlobalConf(seed=seed, learning_rate=learning_rate, updater="adam",
                   weight_init="xavier")
    specs = [("Embedding", {"n_in": vocab_size, "n_out": width})]
    for _ in range(n_layers):
        specs.append(("TransformerBlock", {
            "n_in": width, "n_out": width, "n_heads": n_heads,
            "ffn_multiplier": ffn_multiplier, "causal": True}))
    specs.append(("RnnOutput", {"activation": "softmax", "n_in": width,
                                "n_out": vocab_size, "loss": "mcxent"}))
    layers = [LayerConf(t, f) for t, f in specs]
    return MultiLayerConfiguration(
        g, layers, InputType(kind="recurrent", size=vocab_size,
                             timesteps=max_len))
