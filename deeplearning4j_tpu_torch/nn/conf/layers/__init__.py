"""Layer modules (forward, train-mode dropout, the output layer's loss),
registered under the JAX ``"@type"`` names."""
from .attention import TransformerBlock, attend
from .feedforward import EmbeddingLayer
from .recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer, streaming_lstm)

__all__ = ["EmbeddingLayer", "GravesBidirectionalLSTM", "GravesLSTM", "LSTM",
           "RnnOutputLayer", "TransformerBlock", "attend", "streaming_lstm"]
