"""GoogLeNet (Inception-v1) as a ``ComputationGraph`` configuration.

Counterpart of ``deeplearning4j_tpu/models/googlenet.py`` (``googlenet``),
written with the same builder calls, so the JSON is the JAX one: the stem
(7x7/2 convolution, 3x3/2 max pooling, LRN, 1x1 and 3x3 convolutions,
LRN, pooling), nine inception modules (four towers: 1x1, 1x1 -> 3x3, 1x1
-> 5x5, 3x3 max pooling -> 1x1, concatenated on the channel axis by a
``MergeVertex``) with 3x3/2 pooling after 3b and 4e, global average
pooling, dropout (``dropout`` is the retain probability: 0.6 keeps 60%)
and a softmax output; no auxiliary heads; NHWC images.
"""
from __future__ import annotations

from ..nn.conf.builders import NeuralNetConfiguration
from ..nn.conf.graphconf import ComputationGraphConfiguration
from ..nn.conf.inputs import InputType
from ..nn.conf.layers import (
    ConvolutionLayer, DropoutLayer, GlobalPoolingLayer,
    LocalResponseNormalization, OutputLayer, SubsamplingLayer)
from ..nn.conf.vertices import MergeVertex

#: (1x1, 3x3 reduce, 3x3, 5x5 reduce, 5x5, pool projection) a module
_INCEPTION = {
    "3a": (64, 96, 128, 16, 32, 32),
    "3b": (128, 128, 192, 32, 96, 64),
    "4a": (192, 96, 208, 16, 48, 64),
    "4b": (160, 112, 224, 24, 64, 64),
    "4c": (128, 128, 256, 24, 64, 64),
    "4d": (112, 144, 288, 32, 64, 64),
    "4e": (256, 160, 320, 32, 128, 128),
    "5a": (256, 160, 320, 32, 128, 128),
    "5b": (384, 192, 384, 48, 128, 128),
}


def _conv(gb, name, n_out, kernel, stride, input_name):
    gb.add_layer(name, ConvolutionLayer.conf(
        n_out=n_out, kernel_size=kernel, stride=stride,
        convolution_mode="same", activation="relu"), input_name)
    return name


def _max_pool(gb, name, stride, input_name):
    gb.add_layer(name, SubsamplingLayer.conf(
        pooling_type="max", kernel_size=(3, 3), stride=stride,
        convolution_mode="same"), input_name)
    return name


def _inception(gb, name: str, in_name: str, cfg) -> str:
    c1, r3, c3, r5, c5, pp = cfg
    b1 = _conv(gb, f"{name}_1x1", c1, (1, 1), (1, 1), in_name)
    t3 = _conv(gb, f"{name}_3x3r", r3, (1, 1), (1, 1), in_name)
    b3 = _conv(gb, f"{name}_3x3", c3, (3, 3), (1, 1), t3)
    t5 = _conv(gb, f"{name}_5x5r", r5, (1, 1), (1, 1), in_name)
    b5 = _conv(gb, f"{name}_5x5", c5, (5, 5), (1, 1), t5)
    _max_pool(gb, f"{name}_pool", (1, 1), in_name)
    bp = _conv(gb, f"{name}_poolproj", pp, (1, 1), (1, 1), f"{name}_pool")
    gb.add_vertex(f"{name}_concat", MergeVertex(), b1, b3, b5, bp)
    return f"{name}_concat"


def googlenet(n_classes: int = 1000, image_size: int = 224, channels: int = 3,
              seed: int = 12345, learning_rate: float = 0.01,
              dropout: float = 0.6) -> ComputationGraphConfiguration:
    gb = (NeuralNetConfiguration.builder()
          .seed(seed)
          .learning_rate(learning_rate)
          .updater("nesterovs").momentum(0.9)
          .weight_init("relu")
          .graph_builder()
          .add_inputs("input"))
    _conv(gb, "stem_conv", 64, (7, 7), (2, 2), "input")
    _max_pool(gb, "stem_pool", (2, 2), "stem_conv")
    gb.add_layer("stem_lrn", LocalResponseNormalization.conf(n=5),
                 "stem_pool")
    _conv(gb, "stem_conv2r", 64, (1, 1), (1, 1), "stem_lrn")
    _conv(gb, "stem_conv2", 192, (3, 3), (1, 1), "stem_conv2r")
    gb.add_layer("stem_lrn2", LocalResponseNormalization.conf(n=5),
                 "stem_conv2")
    cur = _max_pool(gb, "pool2", (2, 2), "stem_lrn2")
    for mod in ("3a", "3b"):
        cur = _inception(gb, mod, cur, _INCEPTION[mod])
    cur = _max_pool(gb, "pool3", (2, 2), cur)
    for mod in ("4a", "4b", "4c", "4d", "4e"):
        cur = _inception(gb, mod, cur, _INCEPTION[mod])
    cur = _max_pool(gb, "pool4", (2, 2), cur)
    for mod in ("5a", "5b"):
        cur = _inception(gb, mod, cur, _INCEPTION[mod])
    gb.add_layer("avgpool", GlobalPoolingLayer.conf(pooling_type="avg"), cur)
    gb.add_layer("drop", DropoutLayer.conf(dropout=dropout), "avgpool")
    gb.add_layer("fc", OutputLayer.conf(n_out=n_classes, loss="mcxent",
                                        activation="softmax",
                                        weight_init="xavier"), "drop")
    gb.set_outputs("fc")
    gb.set_input_types(InputType.convolutional(image_size, image_size,
                                               channels))
    return gb.build()
