"""VGG-16 as a ``MultiLayerNetwork`` configuration.

Counterpart of ``deeplearning4j_tpu/models/vgg.py`` (``vgg16``), written
with the same builder calls, so the JSON is the JAX one: five blocks of
3x3 "same" ReLU convolutions (64, 128, 256, 512, 512 filters; 2, 2, 3, 3,
3 of them), each followed by 2x2 max pooling, then two 4096-unit ReLU
dense layers each followed by dropout (``dropout`` is the retain
probability), and a softmax output; Nesterov momentum 0.9, He ("relu")
weights and a Xavier output layer; NHWC images. Weights are random from
the seed (a Keras VGG-16 file is read by ``modelimport``, ROADMAP.md).
"""
from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ConvolutionLayer, DenseLayer, DropoutLayer, OutputLayer, SubsamplingLayer)
from ..nn.conf.multilayer import MultiLayerConfiguration

_VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def vgg16(n_classes: int = 1000, image_size: int = 224, channels: int = 3,
          seed: int = 12345, learning_rate: float = 0.01,
          dropout: float = 0.5) -> MultiLayerConfiguration:
    lb = (NeuralNetConfiguration.builder()
          .seed(seed)
          .learning_rate(learning_rate)
          .updater("nesterovs").momentum(0.9)
          .weight_init("relu")
          .list())
    for filters, convs in _VGG16_BLOCKS:
        for _ in range(convs):
            lb.layer(ConvolutionLayer.conf(
                n_out=filters, kernel_size=(3, 3), stride=(1, 1),
                convolution_mode="same", activation="relu"))
        lb.layer(SubsamplingLayer.conf(pooling_type="max", kernel_size=(2, 2),
                                       stride=(2, 2)))
    lb.layer(DenseLayer.conf(n_out=4096, activation="relu"))
    lb.layer(DropoutLayer.conf(dropout=dropout))
    lb.layer(DenseLayer.conf(n_out=4096, activation="relu"))
    lb.layer(DropoutLayer.conf(dropout=dropout))
    lb.layer(OutputLayer.conf(n_out=n_classes, loss="mcxent",
                              activation="softmax", weight_init="xavier"))
    lb.set_input_type(InputType.convolutional(image_size, image_size,
                                              channels))
    return lb.build()
