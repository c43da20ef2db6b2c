"""Input preprocessors: the reshapes between layer families.

Counterpart of ``deeplearning4j_tpu/nn/conf/preprocessors.py``: the same six
preprocessors under the same ``"@type"`` names and JSON fields, and the same
inference of the preprocessor a layer needs (``infer_preprocessor``), which
``ListBuilder.build`` runs when an input type is set. Only the forward
reshape is written; autograd reverses it.

Layouts: feed-forward ``[B, F]``; convolutional NHWC ``[B, H, W, C]``;
recurrent ``[B, T, F]``. ``CnnToFeedForward`` flattens NHWC in (h, w, c)
order, as the JAX package does, so a dense layer after it takes the JAX
weights unpermuted.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from .inputs import InputType

PREPROCESSOR_TYPES: Dict[str, type] = {}


def _register(name: str):
    def deco(cls):
        cls.TYPE = name
        PREPROCESSOR_TYPES[name] = cls
        return cls
    return deco


@dataclasses.dataclass
class InputPreProcessor:
    TYPE = ""

    def pre_process(self, x: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def output_type(self, itype: InputType) -> InputType:
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@type": self.TYPE, **dataclasses.asdict(self)}


@_register("FeedForwardToCnn")
@dataclasses.dataclass
class FeedForwardToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 1

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width, self.channels)


@_register("CnnToFeedForward")
@dataclasses.dataclass
class CnnToFeedForwardPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(x.shape[0], -1)

    def output_type(self, itype):
        return InputType.feed_forward(itype.flat_size())


@_register("RnnToFeedForward")
@dataclasses.dataclass
class RnnToFeedForwardPreProcessor(InputPreProcessor):
    """``[B, T, F]`` -> ``[B * T, F]``."""

    def pre_process(self, x, mask=None):
        return x.reshape(-1, x.shape[-1])

    def output_type(self, itype):
        return InputType.feed_forward(itype.size)


@_register("FeedForwardToRnn")
@dataclasses.dataclass
class FeedForwardToRnnPreProcessor(InputPreProcessor):
    """``[B * T, F]`` -> ``[B, T, F]`` for a known ``timesteps``."""

    timesteps: int = 0

    def pre_process(self, x, mask=None):
        return x.reshape(-1, self.timesteps, x.shape[-1])

    def output_type(self, itype):
        return InputType.recurrent(itype.size, self.timesteps or None)


@_register("CnnToRnn")
@dataclasses.dataclass
class CnnToRnnPreProcessor(InputPreProcessor):
    """``[B, H, W, C]`` -> ``[B / T, T, H * W * C]`` (one step a row by
    default)."""

    timesteps: int = 1

    def pre_process(self, x, mask=None):
        flat = x.reshape(x.shape[0], -1)
        return flat.reshape(-1, self.timesteps, flat.shape[-1])

    def output_type(self, itype):
        return InputType.recurrent(itype.flat_size(), self.timesteps or None)


@_register("RnnToCnn")
@dataclasses.dataclass
class RnnToCnnPreProcessor(InputPreProcessor):
    height: int = 0
    width: int = 0
    channels: int = 1

    def pre_process(self, x, mask=None):
        return x.reshape(-1, self.height, self.width, self.channels)

    def output_type(self, itype):
        return InputType.convolutional(self.height, self.width, self.channels)


def preprocessor_from_dict(d: dict) -> InputPreProcessor:
    """A preprocessor from its JSON object; an unknown ``"@type"`` raises."""
    name = d.get("@type")
    if name not in PREPROCESSOR_TYPES:
        raise ValueError(f"unknown preprocessor @type {name!r}; this port "
                         f"reads {sorted(PREPROCESSOR_TYPES)}")
    cls = PREPROCESSOR_TYPES[name]
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def infer_preprocessor(prev: InputType, layer_cls: type
                       ) -> Optional[InputPreProcessor]:
    """The preprocessor between data of type ``prev`` and a layer of class
    ``layer_cls``, or None, by the JAX package's rules: flat images before a
    convolutional layer are reshaped to NHWC, images before a recurrent layer
    become a sequence, images before any other feed-forward layer are
    flattened; recurrent data reaches dense layers unchanged (their product
    broadcasts over time)."""
    from .layers.base import FeedForwardLayer
    from .layers.convolutional import (
        ConvolutionLayer, SubsamplingLayer, Upsampling2D, ZeroPaddingLayer)
    from .layers.normalization import (
        BatchNormalization, LocalResponseNormalization)
    from .layers.recurrent import LSTM, RnnOutputLayer

    if issubclass(layer_cls, (ConvolutionLayer, SubsamplingLayer,
                              Upsampling2D, ZeroPaddingLayer,
                              LocalResponseNormalization)):
        if prev.kind == "convolutionalflat":
            return FeedForwardToCnnPreProcessor(prev.height, prev.width,
                                                prev.channels)
        return None
    if issubclass(layer_cls, (LSTM, RnnOutputLayer)):
        if prev.kind == "convolutional":
            return CnnToRnnPreProcessor()
        return None
    if issubclass(layer_cls, BatchNormalization):
        return None  # takes images and features alike
    if issubclass(layer_cls, FeedForwardLayer) \
            and prev.kind == "convolutional":
        return CnnToFeedForwardPreProcessor(prev.height, prev.width,
                                            prev.channels)
    return None
