"""GravesLSTM character model.

Counterpart of ``deeplearning4j_tpu/models/char_rnn.py`` (``char_rnn_lstm``),
with the same defaults and the same resolved config: DL4J's canonical
character-modelling example, ``layers`` GravesLSTM(``hidden``) layers and a
softmax ``RnnOutput`` head, RMSProp (decay 0.95), Xavier weights, truncated
BPTT over chunks of ``tbptt_length`` steps, every layer with the global
defaults baked in.
"""
from __future__ import annotations

from ..nn.conf.multilayer import GlobalConf, LayerConf, MultiLayerConfiguration


def char_rnn_lstm(vocab_size: int, hidden: int = 200, layers: int = 2,
                  tbptt_length: int = 50, seed: int = 12345,
                  learning_rate: float = 0.1) -> MultiLayerConfiguration:
    """One-hot characters ``[B, T, V]`` -> stacked GravesLSTMs -> vocab
    probabilities at every step."""
    g = GlobalConf(seed=seed, learning_rate=learning_rate, updater="rmsprop",
                   rms_decay=0.95, weight_init="xavier")
    specs = [("GravesLSTM", {
        "n_in": vocab_size if i == 0 else hidden, "n_out": hidden,
        "activation": "tanh", "forget_gate_bias_init": 1.0,
        "gate_activation": "sigmoid", "peephole": True})
        for i in range(layers)]
    specs.append(("RnnOutput", {"activation": "softmax", "n_in": hidden,
                                "n_out": vocab_size, "loss": "mcxent"}))
    return MultiLayerConfiguration(
        g, [LayerConf(t, f) for t, f in specs], backprop_type="TruncatedBPTT",
        tbptt_fwd_length=tbptt_length, tbptt_back_length=tbptt_length)
