"""Layer modules (forward, train-mode dropout, the output layer's loss),
registered under the JAX ``"@type"`` names."""
from .attention import TransformerBlock, attend
from .feedforward import EmbeddingLayer
from .recurrent import RnnOutputLayer

__all__ = ["EmbeddingLayer", "RnnOutputLayer", "TransformerBlock", "attend"]
