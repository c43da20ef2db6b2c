"""``NeuralNetConfiguration``: the fluent builder DSL.

Counterpart of ``deeplearning4j_tpu/nn/conf/builders.py``, with the same
method names, so a JAX config reads the same here::

    conf = (NeuralNetConfiguration.builder()
            .seed(123).learning_rate(0.1).updater("nesterovs").momentum(0.9)
            .weight_init("xavier")
            .list()
            .layer(DenseLayer.conf(n_out=500, activation="relu"))
            .layer(OutputLayer.conf(n_out=10, loss="mcxent",
                                    activation="softmax"))
            .set_input_type(InputType.convolutional_flat(28, 28, 1))
            .build())

A layer is given as a ``LayerConf``, made by its class's ``conf(**fields)``
(``layers/base.py``) with the JAX dataclass's defaults filled in.
``build()`` checks the global config, infers the preprocessors and each
layer's ``n_in`` from the input type, and bakes the global defaults into
every layer, so its ``to_json()`` is the JAX ``build()``'s for the same
calls.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from ...common import resolve_policy
from .inputs import InputType
from .multilayer import GlobalConf, LayerConf, MultiLayerConfiguration
from .preprocessors import InputPreProcessor, infer_preprocessor
from .serde import layer_class

#: camelCase names the builder also takes, as the JAX builder does
_ALIASES = {"regularization": "use_regularization",
            "optimizationAlgo": "optimization_algo"}


def validate_global_conf(g: GlobalConf) -> None:
    """Refuse a misspelt dtype policy at ``build()``."""
    if g.dtype is not None:
        resolve_policy(g.dtype)  # raises ValueError naming the known ones


class NeuralNetConfiguration:
    """Namespace of the DSL: ``NeuralNetConfiguration.builder()``."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    """The global settings: a setter for every ``GlobalConf`` field
    (``.seed(1).learning_rate(0.1)...``), then ``list()`` or
    ``graph_builder()``."""

    def __init__(self):
        self._g = GlobalConf()

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        field = _ALIASES.get(name, name)
        if field not in {f.name for f in dataclasses.fields(GlobalConf)}:
            raise AttributeError(f"No config field '{name}'")

        def setter(value):
            setattr(self._g, field, value)
            if field == "mini_batch":
                self._g.minibatch = value
            return self
        return setter

    def list(self) -> "ListBuilder":
        return ListBuilder(self._g)

    def graph_builder(self):
        """A ``GraphBuilder`` over these global settings (``graphconf.py``);
        its ``add_layer`` bakes them into each layer."""
        from .graphconf import GraphBuilder
        return GraphBuilder(self._g)

    def global_conf(self) -> GlobalConf:
        return self._g


class ListBuilder:
    """A sequential network's layers, preprocessors, input type and
    training settings."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._layers: List[LayerConf] = []
        self._preprocessors: Dict[int, InputPreProcessor] = {}
        self._input_type: Optional[InputType] = None
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "Standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def layer(self, idx_or_layer: Union[int, LayerConf],
              maybe_layer: Optional[LayerConf] = None) -> "ListBuilder":
        """``.layer(conf)`` or ``.layer(i, conf)``, layers in order."""
        layer = idx_or_layer if maybe_layer is None else maybe_layer
        if maybe_layer is not None and idx_or_layer != len(self._layers):
            raise ValueError(f"layer index {idx_or_layer} given where "
                             f"{len(self._layers)} comes next: layers must be "
                             "added in order")
        if not isinstance(layer, LayerConf):
            raise TypeError(f"a layer is a LayerConf (e.g. DenseLayer.conf("
                            f"n_out=...)), got {type(layer).__name__}")
        self._layers.append(layer)
        return self

    def input_pre_processor(self, idx: int,
                            pp: InputPreProcessor) -> "ListBuilder":
        self._preprocessors[idx] = pp
        return self

    def set_input_type(self, itype: InputType) -> "ListBuilder":
        self._input_type = itype
        return self

    def backprop(self, flag: bool) -> "ListBuilder":
        self._backprop = flag
        return self

    def pretrain(self, flag: bool) -> "ListBuilder":
        self._pretrain = flag
        return self

    def backprop_type(self, t: str) -> "ListBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "ListBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "ListBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> MultiLayerConfiguration:
        validate_global_conf(self._g)
        layers = [LayerConf(lc.type, dict(lc.fields)) for lc in self._layers]
        pps = dict(self._preprocessors)
        # walk the input type through the stack: preprocessors where a
        # layer family changes, then each layer's n_in and output type
        if self._input_type is not None:
            cur = self._input_type
            for i, lc in enumerate(layers):
                cls = layer_class(lc.type)
                if i not in pps:
                    pp = infer_preprocessor(cur, cls)
                    if pp is not None:
                        pps[i] = pp
                if i in pps:
                    cur = pps[i].output_type(cur)
                cls.set_n_in(lc.fields, cur)
                cur = cls.output_type(lc.fields, cur)
        return MultiLayerConfiguration(
            global_conf=dataclasses.replace(self._g), layers=layers,
            preprocessors={str(k): v for k, v in sorted(pps.items())},
            input_type=self._input_type, backprop=self._backprop,
            pretrain=self._pretrain, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back)
