"""``InputType``: the shape of the data between layers.

Counterpart of ``deeplearning4j_tpu/nn/conf/inputs.py``, with the same
fields, defaults and JSON. ``ListBuilder.set_input_type`` walks it through
the layers to infer each layer's ``n_in`` and the preprocessors at the
boundaries between layer families.

Layouts, as in the JAX package: feed-forward ``[B, F]``; convolutional NHWC
``[B, H, W, C]``; recurrent ``[B, T, F]``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class InputType:
    kind: str = "feedforward"  # feedforward | recurrent | convolutional | convolutionalflat
    size: int = 0              # feature dim (feed-forward, recurrent)
    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: Optional[int] = None  # recurrent; None = variable

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType(kind="feedforward", size=int(size))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType(kind="recurrent", size=int(size), timesteps=timesteps)

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType(kind="convolutional", height=int(height),
                         width=int(width), channels=int(channels))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        """Images given flat, ``[B, H * W * C]`` in (h, w, c) order."""
        return InputType(kind="convolutionalflat", height=int(height),
                         width=int(width), channels=int(channels),
                         size=int(height) * int(width) * int(channels))

    def flat_size(self) -> int:
        if self.kind in ("feedforward", "recurrent", "convolutionalflat"):
            return self.size if self.size else (self.height * self.width
                                                * self.channels)
        return self.height * self.width * self.channels

    def array_shape(self, batch: int = 1) -> tuple:
        """The array shape of this type (NHWC, ``[B, T, F]``)."""
        if self.kind in ("feedforward", "convolutionalflat"):
            return (batch, self.flat_size())
        if self.kind == "recurrent":
            return (batch, self.timesteps or 1, self.size)
        if self.kind == "convolutional":
            return (batch, self.height, self.width, self.channels)
        raise ValueError(self.kind)

    def to_dict(self) -> dict:
        return {"@type": "InputType", **dataclasses.asdict(self)}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        names = {f.name for f in dataclasses.fields(InputType)}
        return InputType(**{k: v for k, v in d.items() if k in names})
