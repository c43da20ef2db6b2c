"""Graph vertices of a ``ComputationGraph``.

Counterpart of ``deeplearning4j_tpu/nn/conf/vertices.py``: the same twelve
vertex types under the same ``"@type"`` names and JSON fields. A vertex is
config data plus a pure function over its input activations
(``apply(inputs, mask)``) and the type it hands on (``output_type``).
``LayerVertex`` holds a layer's ``LayerConf``; the network builds the
layer module from it and runs the layer itself, with its params and state.

Layouts as in the JAX package: feed-forward ``[B, F]``, convolutional NHWC
``[B, H, W, C]``, recurrent ``[B, T, F]``, so the feature or channel axis
is the last one at every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import torch

from .inputs import InputType
from .multilayer import LayerConf
from .preprocessors import InputPreProcessor, preprocessor_from_dict
from .serde import layer_class

VERTEX_TYPES: Dict[str, type] = {}


def _register(name: str):
    def deco(cls):
        cls.TYPE = name
        VERTEX_TYPES[name] = cls
        return cls
    return deco


@dataclasses.dataclass
class GraphVertex:
    """A vertex without params: a pure function of its inputs."""

    TYPE = ""

    def apply(self, inputs: List[torch.Tensor],
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    def output_type(self, itypes: List[InputType]) -> InputType:
        return itypes[0]

    def to_dict(self) -> dict:
        return {"@type": self.TYPE, **dataclasses.asdict(self)}


@_register("LayerVertex")
@dataclasses.dataclass
class LayerVertex(GraphVertex):
    """A layer; the network runs it (``layer`` is its config)."""

    layer: Optional[LayerConf] = None

    def output_type(self, itypes):
        return layer_class(self.layer.type).output_type(self.layer.fields,
                                                        itypes[0])

    def to_dict(self):
        return {"@type": self.TYPE,
                "layer": None if self.layer is None else self.layer.to_dict()}


@_register("MergeVertex")
@dataclasses.dataclass
class MergeVertex(GraphVertex):
    """Concatenation along the feature or channel axis (the last)."""

    def apply(self, inputs, mask=None):
        return torch.cat(inputs, dim=-1)

    def output_type(self, itypes):
        first = itypes[0]
        if first.kind == "convolutional":
            return InputType.convolutional(first.height, first.width,
                                           sum(t.channels for t in itypes))
        if first.kind == "recurrent":
            return InputType.recurrent(sum(t.size for t in itypes),
                                       first.timesteps)
        return InputType.feed_forward(sum(t.flat_size() for t in itypes))


@_register("ElementWiseVertex")
@dataclasses.dataclass
class ElementWiseVertex(GraphVertex):
    """Elementwise add, subtract, product, max or average of the inputs."""

    op: str = "add"

    def apply(self, inputs, mask=None):
        op = self.op.lower()
        out = inputs[0]
        if op in ("add", "average", "avg"):
            for x in inputs[1:]:
                out = out + x
            return out / len(inputs) if op != "add" else out
        if op == "subtract":
            return inputs[0] - inputs[1]
        if op in ("product", "mul"):
            for x in inputs[1:]:
                out = out * x
            return out
        if op == "max":
            for x in inputs[1:]:
                out = torch.maximum(out, x)
            return out
        raise ValueError(f"Unknown elementwise op '{self.op}'")


@_register("SubsetVertex")
@dataclasses.dataclass
class SubsetVertex(GraphVertex):
    """Features ``start`` to ``end``, both included, of the last axis."""

    start: int = 0
    end: int = 0

    def apply(self, inputs, mask=None):
        return inputs[0][..., self.start:self.end + 1]

    def output_type(self, itypes):
        n = self.end - self.start + 1
        t = itypes[0]
        if t.kind == "recurrent":
            return InputType.recurrent(n, t.timesteps)
        if t.kind == "convolutional":
            return InputType.convolutional(t.height, t.width, n)
        return InputType.feed_forward(n)


@_register("L2NormalizeVertex")
@dataclasses.dataclass
class L2NormalizeVertex(GraphVertex):
    """``x / sqrt(sum of x^2 over every axis but the batch + eps)``."""

    eps: float = 1e-8

    def apply(self, inputs, mask=None):
        x = inputs[0]
        dims = tuple(range(1, x.ndim))
        return x / torch.sqrt((x * x).sum(dims, keepdim=True) + self.eps)


@_register("L2Vertex")
@dataclasses.dataclass
class L2Vertex(GraphVertex):
    """The L2 distance of two inputs, ``[B, 1]``."""

    eps: float = 1e-8

    def apply(self, inputs, mask=None):
        d = inputs[0] - inputs[1]
        dims = tuple(range(1, d.ndim))
        return torch.sqrt((d * d).sum(dims)[..., None] + self.eps)

    def output_type(self, itypes):
        return InputType.feed_forward(1)


@_register("ScaleVertex")
@dataclasses.dataclass
class ScaleVertex(GraphVertex):
    scale: float = 1.0

    def apply(self, inputs, mask=None):
        return inputs[0] * self.scale


@_register("ShiftVertex")
@dataclasses.dataclass
class ShiftVertex(GraphVertex):
    shift: float = 0.0

    def apply(self, inputs, mask=None):
        return inputs[0] + self.shift


@_register("StackVertex")
@dataclasses.dataclass
class StackVertex(GraphVertex):
    """The inputs stacked along the batch axis."""

    def apply(self, inputs, mask=None):
        return torch.cat(inputs, dim=0)


@_register("UnstackVertex")
@dataclasses.dataclass
class UnstackVertex(GraphVertex):
    """Part ``index`` of ``num_stacks`` equal parts of the batch axis."""

    index: int = 0
    num_stacks: int = 1

    def apply(self, inputs, mask=None):
        x = inputs[0]
        size = x.shape[0] // self.num_stacks
        return x[self.index * size:(self.index + 1) * size]


@_register("PreprocessorVertex")
@dataclasses.dataclass
class PreprocessorVertex(GraphVertex):
    """An input preprocessor on its own (``build()`` inserts one before a
    layer whose input family differs, as ``"{layer}-preprocessor"``)."""

    preprocessor: Optional[InputPreProcessor] = None

    def apply(self, inputs, mask=None):
        return self.preprocessor.pre_process(inputs[0], mask)

    def output_type(self, itypes):
        return self.preprocessor.output_type(itypes[0])

    def to_dict(self):
        return {"@type": self.TYPE, "preprocessor": (
            None if self.preprocessor is None else self.preprocessor.to_dict())}


@_register("LastTimeStepVertex")
@dataclasses.dataclass
class LastTimeStepVertex(GraphVertex):
    """``[B, T, F] -> [B, F]``: the last step, or with a ``[B, T]`` mask
    each row's last unmasked step (step 0 for a row without one)."""

    mask_input: Optional[str] = None

    def apply(self, inputs, mask=None):
        x = inputs[0]
        if mask is not None:
            idx = torch.clamp_min(mask.to(torch.int64).sum(1) - 1, 0)
            return x[torch.arange(x.shape[0], device=x.device), idx]
        return x[:, -1]

    def output_type(self, itypes):
        return InputType.feed_forward(itypes[0].size)


@_register("DuplicateToTimeSeriesVertex")
@dataclasses.dataclass
class DuplicateToTimeSeriesVertex(GraphVertex):
    """``[B, F] -> [B, T, F]``: the first input repeated over the time axis
    of the second."""

    ts_input: Optional[str] = None

    def apply(self, inputs, mask=None):
        x, ts = inputs[0], inputs[1]
        return x[:, None, :].expand(x.shape[0], ts.shape[1], x.shape[-1])

    def output_type(self, itypes):
        return InputType.recurrent(itypes[0].flat_size(), itypes[1].timesteps)


def vertex_from_dict(d: dict) -> GraphVertex:
    """A vertex from its JSON object; an unknown ``"@type"`` raises."""
    name = d.get("@type")
    if name not in VERTEX_TYPES:
        raise ValueError(f"unknown vertex @type {name!r}; this port reads "
                         f"{sorted(VERTEX_TYPES)}")
    cls = VERTEX_TYPES[name]
    if cls is LayerVertex:
        ld = dict(d["layer"])
        return LayerVertex(LayerConf(ld.pop("@type", None), ld))
    if cls is PreprocessorVertex:
        pp = d.get("preprocessor")
        return PreprocessorVertex(None if pp is None
                                  else preprocessor_from_dict(pp))
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})
