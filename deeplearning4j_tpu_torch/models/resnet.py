"""ResNet-50 and ResNet-18 as ``ComputationGraph`` configurations.

Counterpart of ``deeplearning4j_tpu/models/resnet.py``, written with the
same builder calls, so the JSON is the JAX one: convolution, batch norm and
ReLU in that order, NHWC images, residual adds by ``ElementWiseVertex``,
Nesterov momentum 0.9, He ("relu") weights and a Xavier output layer.
ResNet-50's bottleneck puts its stride on the first 1x1 convolution
(``_a``), not on the 3x3; ``"same"`` padding is XLA's (the 7x7/2 stem at
224 pads 2 rows above and 3 below).
"""
from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.graphconf import ComputationGraphConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ActivationLayer, BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    OutputLayer, SubsamplingLayer)
from ..nn.conf.vertices import ElementWiseVertex


def _conv_bn(gb, name: str, n_out: int, kernel, stride, input_name: str,
             activation: str = "relu", mode: str = "same") -> str:
    gb.add_layer(f"{name}_conv",
                 ConvolutionLayer.conf(n_out=n_out, kernel_size=kernel,
                                       stride=stride, convolution_mode=mode,
                                       activation="identity", has_bias=False),
                 input_name)
    gb.add_layer(f"{name}_bn", BatchNormalization.conf(activation=activation),
                 f"{name}_conv")
    return f"{name}_bn"


def _bottleneck(gb, name: str, in_name: str, filters: int, stride: int,
                downsample: bool) -> str:
    """1x1 -> 3x3 -> 1x1 (x4 filters) with an identity or projection
    shortcut."""
    out_ch = filters * 4
    a = _conv_bn(gb, f"{name}_a", filters, (1, 1), (stride, stride), in_name)
    b = _conv_bn(gb, f"{name}_b", filters, (3, 3), (1, 1), a)
    c = _conv_bn(gb, f"{name}_c", out_ch, (1, 1), (1, 1), b,
                 activation="identity")
    if downsample:
        shortcut = _conv_bn(gb, f"{name}_proj", out_ch, (1, 1),
                            (stride, stride), in_name, activation="identity")
    else:
        shortcut = in_name
    gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), c, shortcut)
    gb.add_layer(f"{name}_relu", ActivationLayer.conf(activation="relu"),
                 f"{name}_add")
    return f"{name}_relu"


def _stem(gb) -> str:
    stem = _conv_bn(gb, "stem", 64, (7, 7), (2, 2), "input")
    gb.add_layer("stem_pool",
                 SubsamplingLayer.conf(pooling_type="max", kernel_size=(3, 3),
                                       stride=(2, 2), convolution_mode="same"),
                 stem)
    return "stem_pool"


def _head(gb, cur: str, n_classes: int, image_size: int,
          channels: int) -> ComputationGraphConfiguration:
    gb.add_layer("avgpool", GlobalPoolingLayer.conf(pooling_type="avg"), cur)
    gb.add_layer("fc", OutputLayer.conf(n_out=n_classes, loss="mcxent",
                                        activation="softmax",
                                        weight_init="xavier"),
                 "avgpool")
    gb.set_outputs("fc")
    gb.set_input_types(InputType.convolutional(image_size, image_size,
                                               channels))
    return gb.build()


def _builder(seed: int, learning_rate: float):
    return (NeuralNetConfiguration.builder()
            .seed(seed)
            .learning_rate(learning_rate)
            .updater("nesterovs").momentum(0.9)
            .weight_init("relu")
            .graph_builder()
            .add_inputs("input"))


def resnet50(n_classes: int = 1000, image_size: int = 224, channels: int = 3,
             seed: int = 12345, learning_rate: float = 0.1,
             stage_blocks=(3, 4, 6, 3)) -> ComputationGraphConfiguration:
    """The 50-layer bottleneck ResNet (``stage_blocks`` cuts its depth)."""
    gb = _builder(seed, learning_rate)
    cur = _stem(gb)
    filters = [64, 128, 256, 512]
    for stage, blocks in enumerate(stage_blocks):
        for block in range(blocks):
            stride = 2 if (stage > 0 and block == 0) else 1
            cur = _bottleneck(gb, f"s{stage}b{block}", cur, filters[stage],
                              stride, block == 0)
    return _head(gb, cur, n_classes, image_size, channels)


def resnet18(n_classes: int = 1000, image_size: int = 224, channels: int = 3,
             seed: int = 12345,
             learning_rate: float = 0.1) -> ComputationGraphConfiguration:
    """The basic-block ResNet-18."""
    gb = _builder(seed, learning_rate)
    cur = _stem(gb)
    filters = [64, 128, 256, 512]
    for stage in range(4):
        for block in range(2):
            name = f"s{stage}b{block}"
            stride = 2 if (stage > 0 and block == 0) else 1
            a = _conv_bn(gb, f"{name}_a", filters[stage], (3, 3),
                         (stride, stride), cur)
            b = _conv_bn(gb, f"{name}_b", filters[stage], (3, 3), (1, 1), a,
                         activation="identity")
            if stage > 0 and block == 0:
                shortcut = _conv_bn(gb, f"{name}_proj", filters[stage], (1, 1),
                                    (stride, stride), cur,
                                    activation="identity")
            else:
                shortcut = cur
            gb.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), b,
                          shortcut)
            gb.add_layer(f"{name}_relu", ActivationLayer.conf(activation="relu"),
                         f"{name}_add")
            cur = f"{name}_relu"
    return _head(gb, cur, n_classes, image_size, channels)
