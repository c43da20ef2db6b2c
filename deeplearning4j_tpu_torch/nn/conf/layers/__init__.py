"""Layer modules (forward, train-mode dropout, the output layers' loss, and
each type's config side: field defaults, ``n_in`` and output-type
inference), registered under the JAX ``"@type"`` names."""
from .attention import TransformerBlock, attend
from .base import FeedForwardLayer, Layer
from .convolutional import (
    ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer, Upsampling2D,
    ZeroPaddingLayer)
from .feedforward import (
    ActivationLayer, DenseLayer, DropoutLayer, EmbeddingLayer, LossLayer,
    OutputLayer)
from .normalization import BatchNormalization, LocalResponseNormalization
from .recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer, streaming_lstm)

__all__ = ["ActivationLayer", "BatchNormalization", "ConvolutionLayer",
           "DenseLayer", "DropoutLayer", "EmbeddingLayer", "FeedForwardLayer",
           "GlobalPoolingLayer", "GravesBidirectionalLSTM", "GravesLSTM",
           "LSTM", "Layer", "LocalResponseNormalization", "LossLayer",
           "OutputLayer", "RnnOutputLayer", "SubsamplingLayer",
           "TransformerBlock", "Upsampling2D", "ZeroPaddingLayer", "attend",
           "streaming_lstm"]
