"""Decoder-only transformer LMs: dense and Switch-MoE.

Counterpart of ``deeplearning4j_tpu/models/transformer.py``
(``transformer_lm``, ``moe_transformer_lm``), with the same defaults and
the same resolved configs: Adam at the given learning rate, an
``Embedding`` layer whose activation is the global default (``sigmoid``),
causal ``TransformerBlock``s (or ``MoETransformerBlock``s: top-1 routed
expert FFNs whose load-balance term enters the training objective), and a
softmax ``RnnOutput`` head, every layer with the global defaults baked in.
"""
from __future__ import annotations

from ..nn.conf.inputs import InputType
from ..nn.conf.multilayer import GlobalConf, LayerConf, MultiLayerConfiguration


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
        g, layers, input_type=InputType.recurrent(vocab_size, max_len))


def moe_transformer_lm(vocab_size: int, width: int = 256, n_layers: int = 4,
                       n_heads: int = 4, n_experts: int = 8,
                       expert_hidden: int = 0, max_len: int = 512,
                       seed: int = 12345,
                       learning_rate: float = 3e-4) -> MultiLayerConfiguration:
    """Sparse-FFN causal LM: ``n_layers`` Switch blocks (pre-LN residual
    attention, pre-LN residual top-1 MoE FFN of ``n_experts`` experts of
    ``expert_hidden`` units, 0 meaning 4 x width)."""
    g = GlobalConf(seed=seed, learning_rate=learning_rate, updater="adam",
                   weight_init="xavier")
    specs = [("Embedding", {"n_in": vocab_size, "n_out": width})]
    for _ in range(n_layers):
        specs.append(("MoETransformerBlock", {
            "n_in": width, "n_out": width, "n_experts": n_experts,
            "expert_hidden": expert_hidden, "router_noise": 0.0,
            "aux_loss_weight": 0.01, "n_heads": n_heads, "causal": True,
            "activation": "identity"}))
    specs.append(("RnnOutput", {"activation": "softmax", "n_in": width,
                                "n_out": vocab_size, "loss": "mcxent"}))
    layers = [LayerConf(t, f) for t, f in specs]
    return MultiLayerConfiguration(
        g, layers, input_type=InputType.recurrent(vocab_size, max_len))
