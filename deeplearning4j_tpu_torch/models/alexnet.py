"""AlexNet as a ``MultiLayerNetwork`` configuration.

Counterpart of ``deeplearning4j_tpu/models/alexnet.py`` (``alexnet``),
written with the same builder calls, so the JSON is the JAX one: 11x11/4,
5x5 and three 3x3 "same" ReLU convolutions (96, 256, 384, 384, 256
filters), local response normalization after the first two, 3x3/2 max
pooling after the first two and the last, two 4096-unit ReLU dense layers
each followed by dropout (the retain probability), and a softmax output;
Nesterov momentum 0.9, He ("relu") weights, a Xavier output layer; NHWC
images. The original's two-GPU grouping is folded into plain
convolutions, as in the JAX package.
"""
from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ConvolutionLayer, DenseLayer, DropoutLayer, LocalResponseNormalization,
    OutputLayer, SubsamplingLayer)
from ..nn.conf.multilayer import MultiLayerConfiguration


def _conv(n_out, kernel, stride):
    return ConvolutionLayer.conf(n_out=n_out, kernel_size=kernel,
                                 stride=stride, convolution_mode="same",
                                 activation="relu")


def _lrn():
    return LocalResponseNormalization.conf(n=5, alpha=1e-4, beta=0.75, k=2)


def _pool():
    return SubsamplingLayer.conf(pooling_type="max", kernel_size=(3, 3),
                                 stride=(2, 2))


def alexnet(n_classes: int = 1000, image_size: int = 224, channels: int = 3,
            seed: int = 12345, learning_rate: float = 0.01,
            dropout: float = 0.5) -> MultiLayerConfiguration:
    lb = (NeuralNetConfiguration.builder()
          .seed(seed)
          .learning_rate(learning_rate)
          .updater("nesterovs").momentum(0.9)
          .weight_init("relu")
          .list()
          .layer(_conv(96, (11, 11), (4, 4)))
          .layer(_lrn())
          .layer(_pool())
          .layer(_conv(256, (5, 5), (1, 1)))
          .layer(_lrn())
          .layer(_pool())
          .layer(_conv(384, (3, 3), (1, 1)))
          .layer(_conv(384, (3, 3), (1, 1)))
          .layer(_conv(256, (3, 3), (1, 1)))
          .layer(_pool())
          .layer(DenseLayer.conf(n_out=4096, activation="relu"))
          .layer(DropoutLayer.conf(dropout=dropout))
          .layer(DenseLayer.conf(n_out=4096, activation="relu"))
          .layer(DropoutLayer.conf(dropout=dropout))
          .layer(OutputLayer.conf(n_out=n_classes, loss="mcxent",
                                  activation="softmax", weight_init="xavier")))
    lb.set_input_type(InputType.convolutional(image_size, image_size,
                                              channels))
    return lb.build()
