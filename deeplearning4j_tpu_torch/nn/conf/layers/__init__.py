"""Layer modules (forward, train-mode dropout, the output layers' loss, and
each type's config side: field defaults, ``n_in`` and output-type
inference), registered under the JAX ``"@type"`` names."""
from .attention import SelfAttentionLayer, TransformerBlock, attend
from .base import FeedForwardLayer, Layer, PretrainLayer
from .convolutional import (
    ConvolutionLayer, GlobalPoolingLayer, SubsamplingLayer, Upsampling2D,
    ZeroPaddingLayer)
from .feedforward import (
    RBM, ActivationLayer, AutoEncoder, DenseLayer, DropoutLayer,
    EmbeddingLayer, LossLayer, OutputLayer)
from .moe import MoELayer, MoETransformerBlock
from .normalization import BatchNormalization, LocalResponseNormalization
from .recurrent import (
    LSTM, GravesBidirectionalLSTM, GravesLSTM, RnnOutputLayer, streaming_lstm)
from .variational import (
    BernoulliReconstructionDistribution, CompositeReconstructionDistribution,
    ExponentialReconstructionDistribution, GaussianReconstructionDistribution,
    VariationalAutoencoder)

__all__ = ["ActivationLayer", "AutoEncoder", "BatchNormalization",
           "BernoulliReconstructionDistribution",
           "CompositeReconstructionDistribution", "ConvolutionLayer",
           "DenseLayer", "DropoutLayer", "EmbeddingLayer",
           "ExponentialReconstructionDistribution", "FeedForwardLayer",
           "GaussianReconstructionDistribution", "GlobalPoolingLayer",
           "GravesBidirectionalLSTM", "GravesLSTM", "LSTM", "Layer",
           "LocalResponseNormalization", "LossLayer", "MoELayer",
           "MoETransformerBlock", "OutputLayer", "PretrainLayer", "RBM",
           "RnnOutputLayer", "SelfAttentionLayer", "SubsamplingLayer",
           "TransformerBlock", "Upsampling2D", "VariationalAutoencoder",
           "ZeroPaddingLayer", "attend", "streaming_lstm"]
