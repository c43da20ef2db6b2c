"""``ComputationGraphConfiguration`` and the ``GraphBuilder`` DSL.

Counterpart of ``deeplearning4j_tpu/nn/conf/graphconf.py``::

    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .graph_builder()
            .add_inputs("in")
            .add_layer("dense", DenseLayer.conf(n_out=16), "in")
            .add_vertex("half", SubsetVertex(start=0, end=7), "dense")
            .add_layer("out", OutputLayer.conf(n_out=3), "half")
            .set_outputs("out")
            .set_input_types(InputType.feed_forward(4))
            .build())

``add_layer`` bakes the global defaults into the layer, as the JAX builder
does. ``build()`` checks the inputs and outputs, sorts the vertices
(Kahn's algorithm over a sorted ready list, the JAX order exactly), and,
with input types set, walks them through the graph: a layer whose input
family differs gets a ``"{name}-preprocessor"`` vertex before it, every
layer its ``n_in``, and the order is sorted again. :meth:`to_json` writes
the JAX ``to_json()`` dict (``topological_order`` included) and
:meth:`from_json` reads it unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from .inputs import InputType
from .multilayer import GlobalConf, LayerConf, bake_layer_defaults
from .preprocessors import infer_preprocessor
from . import serde
from .serde import layer_class
from .vertices import GraphVertex, LayerVertex, PreprocessorVertex, \
    vertex_from_dict


@dataclasses.dataclass
class ComputationGraphConfiguration:
    global_conf: GlobalConf = dataclasses.field(default_factory=GlobalConf)
    #: name -> vertex, and name -> the names of its inputs
    vertices: Dict[str, GraphVertex] = dataclasses.field(default_factory=dict)
    vertex_inputs: Dict[str, List[str]] = dataclasses.field(
        default_factory=dict)
    network_inputs: List[str] = dataclasses.field(default_factory=list)
    network_outputs: List[str] = dataclasses.field(default_factory=list)
    input_types: List[InputType] = dataclasses.field(default_factory=list)
    topological_order: List[str] = dataclasses.field(default_factory=list)
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "Standard"
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    #: the top-level training fields, in the JAX schema's order
    TRAINING_FIELDS = ("backprop", "pretrain", "backprop_type",
                       "tbptt_fwd_length", "tbptt_back_length")

    def to_dict(self) -> dict:
        return {
            "@type": "ComputationGraphConfiguration",
            "global_conf": self.global_conf.to_dict(),
            "vertices": {n: v.to_dict() for n, v in self.vertices.items()},
            "vertex_inputs": {n: list(v)
                              for n, v in self.vertex_inputs.items()},
            "network_inputs": list(self.network_inputs),
            "network_outputs": list(self.network_outputs),
            "input_types": [t.to_dict() for t in self.input_types],
            "topological_order": list(self.topological_order),
            **{f: getattr(self, f) for f in self.TRAINING_FIELDS},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_json(text: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(text))

    @staticmethod
    def from_dict(d: dict) -> "ComputationGraphConfiguration":
        if d.get("@type") != "ComputationGraphConfiguration":
            raise ValueError("JSON does not encode a "
                             "ComputationGraphConfiguration (@type "
                             f"{d.get('@type')!r})")
        return ComputationGraphConfiguration(
            global_conf=GlobalConf.from_dict(d.get("global_conf") or {}),
            vertices={n: vertex_from_dict(v)
                      for n, v in (d.get("vertices") or {}).items()},
            vertex_inputs={n: list(v)
                           for n, v in (d.get("vertex_inputs") or {}).items()},
            network_inputs=list(d.get("network_inputs") or []),
            network_outputs=list(d.get("network_outputs") or []),
            input_types=[InputType.from_dict(t)
                         for t in d.get("input_types") or []],
            topological_order=list(d.get("topological_order") or []),
            **{f: d[f] for f in ComputationGraphConfiguration.TRAINING_FIELDS
               if f in d})

    def topo_sort(self) -> List[str]:
        """Kahn's topological order over the vertices, the ready list kept
        sorted (the JAX package's order exactly)."""
        indeg = {name: 0 for name in self.vertices}
        children: Dict[str, list] = {name: [] for name in self.vertices}
        for name, ins in self.vertex_inputs.items():
            for src in ins:
                if src in self.vertices:
                    indeg[name] += 1
                    children[src].append(name)
        ready = sorted(n for n, d in indeg.items() if d == 0)
        order = []
        while ready:
            n = ready.pop(0)
            order.append(n)
            for c in children[n]:
                indeg[c] -= 1
                if indeg[c] == 0:
                    ready.append(c)
            ready.sort()
        if len(order) != len(self.vertices):
            cyc = set(self.vertices) - set(order)
            raise ValueError(f"Graph has a cycle involving: {sorted(cyc)}")
        return order


class GraphBuilder:
    """The graph's vertices, inputs, outputs, input types and training
    settings (``NeuralNetConfiguration.builder()....graph_builder()``)."""

    def __init__(self, g: GlobalConf):
        self._g = g
        self._vertices: Dict[str, GraphVertex] = {}
        self._vertex_inputs: Dict[str, list] = {}
        self._inputs: list = []
        self._outputs: list = []
        self._input_types: list = []
        self._backprop = True
        self._pretrain = False
        self._backprop_type = "Standard"
        self._tbptt_fwd = 20
        self._tbptt_back = 20

    def add_inputs(self, *names: str) -> "GraphBuilder":
        self._inputs.extend(names)
        return self

    def add_layer(self, name: str, layer: LayerConf,
                  *inputs: str) -> "GraphBuilder":
        """A layer vertex (``layer`` a ``LayerConf``, e.g.
        ``DenseLayer.conf(n_out=...)``) with the global defaults baked in;
        an unnamed layer takes the vertex's name."""
        if not isinstance(layer, LayerConf):
            raise TypeError(f"a layer is a LayerConf (e.g. DenseLayer.conf("
                            f"n_out=...)), got {type(layer).__name__}")
        fields = bake_layer_defaults(layer.fields, self._g)
        if fields["name"] is None:
            fields["name"] = name
        self._vertices[name] = LayerVertex(LayerConf(layer.type, fields))
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: GraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._vertices[name] = vertex
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def set_input_types(self, *itypes: InputType) -> "GraphBuilder":
        self._input_types = list(itypes)
        return self

    def backprop(self, flag: bool) -> "GraphBuilder":
        self._backprop = flag
        return self

    def pretrain(self, flag: bool) -> "GraphBuilder":
        self._pretrain = flag
        return self

    def backprop_type(self, t: str) -> "GraphBuilder":
        self._backprop_type = t
        return self

    def t_bptt_forward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_fwd = n
        return self

    def t_bptt_backward_length(self, n: int) -> "GraphBuilder":
        self._tbptt_back = n
        return self

    def build(self) -> ComputationGraphConfiguration:
        from .builders import validate_global_conf
        validate_global_conf(self._g)
        conf = ComputationGraphConfiguration(
            global_conf=dataclasses.replace(self._g),
            vertices=dict(self._vertices),
            vertex_inputs={n: list(v) for n, v in self._vertex_inputs.items()},
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            input_types=list(self._input_types),
            backprop=self._backprop, pretrain=self._pretrain,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_back_length=self._tbptt_back)
        for out in conf.network_outputs:
            if out not in conf.vertices:
                raise ValueError(f"Output '{out}' is not a vertex")
        for name, ins in conf.vertex_inputs.items():
            for src in ins:
                if src not in conf.vertices and src not in conf.network_inputs:
                    raise ValueError(f"Vertex '{name}' input '{src}' undefined")
        conf.topological_order = conf.topo_sort()
        if not self._input_types:
            return conf
        # the input types through the graph: preprocessors where a layer's
        # input family differs, then each layer's n_in and output type
        types = dict(zip(conf.network_inputs, self._input_types))
        for name in conf.topological_order:
            v = conf.vertices[name]
            in_types = [types[src] for src in conf.vertex_inputs[name]]
            if isinstance(v, LayerVertex):
                cls = layer_class(v.layer.type)
                pp = infer_preprocessor(in_types[0], cls)
                if pp is not None:
                    pre_name = f"{name}-preprocessor"
                    conf.vertices[pre_name] = PreprocessorVertex(pp)
                    conf.vertex_inputs[pre_name] = conf.vertex_inputs[name]
                    conf.vertex_inputs[name] = [pre_name]
                    in_types = [pp.output_type(in_types[0])]
                cls.set_n_in(v.layer.fields, in_types[0])
            types[name] = v.output_type(in_types)
        conf.topological_order = conf.topo_sort()
        return conf


serde.register_reader("ComputationGraphConfiguration",
                      ComputationGraphConfiguration.from_dict)
