"""LeNet-5 on MNIST.

Counterpart of ``deeplearning4j_tpu/models/lenet.py`` (``lenet_mnist``),
written with the same builder calls: 20 and 50 5x5 filters each followed by
2x2 max pooling, a 500-unit ReLU dense layer and a 10-way softmax output,
Nesterov momentum 0.9, Xavier weights, flat ``[B, 784]`` images in.
"""
from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ConvolutionLayer, DenseLayer, OutputLayer, SubsamplingLayer)
from ..nn.conf.multilayer import MultiLayerConfiguration


def lenet_mnist(seed: int = 12345,
                learning_rate: float = 0.01) -> MultiLayerConfiguration:
    return (NeuralNetConfiguration.builder()
            .seed(seed)
            .learning_rate(learning_rate)
            .updater("nesterovs").momentum(0.9)
            .weight_init("xavier")
            .list()
            .layer(ConvolutionLayer.conf(n_out=20, kernel_size=(5, 5),
                                         stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer.conf(pooling_type="max",
                                         kernel_size=(2, 2), stride=(2, 2)))
            .layer(ConvolutionLayer.conf(n_out=50, kernel_size=(5, 5),
                                         stride=(1, 1), activation="identity"))
            .layer(SubsamplingLayer.conf(pooling_type="max",
                                         kernel_size=(2, 2), stride=(2, 2)))
            .layer(DenseLayer.conf(n_out=500, activation="relu"))
            .layer(OutputLayer.conf(n_out=10, loss="mcxent",
                                    activation="softmax"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())
