"""``MultiLayerConfiguration`` in the JAX package's JSON schema.

Counterpart of ``deeplearning4j_tpu/nn/conf/multilayer.py``. A configuration
is plain data: the global defaults, one :class:`LayerConf` per layer (its
``"@type"`` name and its resolved fields), the input preprocessors by layer
index and the input type. ``NeuralNetConfiguration.builder()``
(``builders.py``) writes one as the JAX DSL does.
:meth:`MultiLayerConfiguration.from_json` reads what the JAX package's
``conf.to_json()`` writes, and :meth:`to_json` writes the same schema;
:meth:`to_yaml` and :meth:`from_yaml` do the same in YAML.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from .inputs import InputType
from .preprocessors import InputPreProcessor, preprocessor_from_dict
from . import serde
from .serde import layer_class


@dataclasses.dataclass
class GlobalConf:
    """The network-wide defaults: every field of the JAX package's
    ``GlobalConf``, with the same defaults. The JAX package bakes the
    per-layer ones into each layer at ``build()``; the network reads the rest
    (``iterations``, ``lr_policy*``, ``use_regularization``, ...) when it
    trains."""

    seed: int = 12345
    optimization_algo: str = "stochastic_gradient_descent"
    iterations: int = 1                 # updates per presented minibatch
    learning_rate: float = 0.1
    bias_learning_rate: Optional[float] = None
    lr_policy: Optional[str] = None
    lr_policy_decay_rate: float = 0.0
    lr_policy_power: float = 0.0
    lr_policy_steps: float = 1.0
    lr_schedule: Optional[dict] = None
    max_num_iterations: int = 1         # for the poly and cosine policies
    updater: str = "sgd"
    momentum: float = 0.9
    momentum_schedule: Optional[dict] = None
    rho: float = 0.95
    rms_decay: float = 0.95
    adam_mean_decay: float = 0.9
    adam_var_decay: float = 0.999
    epsilon: float = 1e-8
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    dist: Optional[dict] = None
    bias_init: float = 0.0
    l1: float = 0.0
    l2: float = 0.0
    dropout: float = 0.0
    gradient_normalization: Optional[str] = None
    gradient_normalization_threshold: float = 1.0
    minibatch: bool = True
    mini_batch: bool = True
    use_regularization: bool = False
    max_num_line_search_iterations: int = 5
    gradient_checkpointing: bool = False
    dtype: Optional[str] = None

    def to_dict(self) -> dict:
        return {"@type": "GlobalConf", **dataclasses.asdict(self)}

    @staticmethod
    def from_dict(g: dict) -> "GlobalConf":
        """Every field of the dict; a field this port does not know raises,
        so no setting of the JSON is dropped in silence."""
        g = {k: v for k, v in g.items() if k != "@type"}
        known = {f.name for f in dataclasses.fields(GlobalConf)}
        unknown = sorted(set(g) - known)
        if unknown:
            raise ValueError(f"GlobalConf fields {unknown} are not known to "
                             "this port")
        return GlobalConf(**g)


#: per-layer fields a layer takes from the global defaults when unset (the
#: JAX package's ``_LAYER_INHERIT_FIELDS``)
LAYER_INHERIT_FIELDS = (
    "activation", "weight_init", "dist", "l1", "l2", "dropout",
    "learning_rate", "bias_learning_rate", "updater", "momentum", "rho",
    "rms_decay", "adam_mean_decay", "adam_var_decay", "epsilon",
    "gradient_normalization", "gradient_normalization_threshold",
)


def bake_layer_defaults(fields: dict, g: GlobalConf) -> dict:
    """A layer's fields with every unset inherited field filled from ``g``,
    as the JAX package bakes them at ``build()``. An unset bias learning rate
    becomes the layer's learning rate, which is baked first, so the global
    ``bias_learning_rate`` reaches no layer there either."""
    out = {"name": None, **fields}
    if out.get("bias_init") is None:
        out["bias_init"] = g.bias_init
    for f in LAYER_INHERIT_FIELDS:
        if out.get(f) is None:
            out[f] = getattr(g, f)
    if fields.get("bias_learning_rate") is None:
        out["bias_learning_rate"] = out["learning_rate"]
    return out


@dataclasses.dataclass
class LayerConf:
    """One entry of ``"layers"``: the ``"@type"`` name and every field of
    the JSON object (``n_in``, ``n_out``, ``activation``, ``n_heads``, ...)."""

    type: str
    fields: Dict[str, Any]

    def __post_init__(self):
        layer_class(self.type)  # unknown @type raises here

    def __getitem__(self, name: str):
        return self.fields[name]

    def get(self, name: str, default=None):
        v = self.fields.get(name)
        return default if v is None else v

    def to_dict(self) -> dict:
        return {"@type": self.type, **self.fields}


@dataclasses.dataclass
class MultiLayerConfiguration:
    global_conf: GlobalConf = dataclasses.field(default_factory=GlobalConf)
    layers: List[LayerConf] = dataclasses.field(default_factory=list)
    #: the preprocessor before layer i under the key str(i)
    preprocessors: Dict[str, InputPreProcessor] = dataclasses.field(
        default_factory=dict)
    input_type: Optional[InputType] = None
    backprop: bool = True
    pretrain: bool = False
    backprop_type: str = "Standard"       # Standard | TruncatedBPTT
    tbptt_fwd_length: int = 20
    tbptt_back_length: int = 20

    #: the top-level training fields, in the JAX schema's order
    TRAINING_FIELDS = ("backprop", "pretrain", "backprop_type",
                       "tbptt_fwd_length", "tbptt_back_length")

    def __post_init__(self):
        # the one place the global defaults reach the layers: a layer reads
        # its baked fields and holds no defaults of its own
        self.layers = [LayerConf(lc.type, bake_layer_defaults(lc.fields,
                                                              self.global_conf))
                       for lc in self.layers]
        self.preprocessors = {str(k): v for k, v in self.preprocessors.items()}

    def preprocessor(self, idx: int) -> Optional[InputPreProcessor]:
        return self.preprocessors.get(str(idx))

    @property
    def n_layers(self) -> int:
        return len(self.layers)

    def to_dict(self) -> dict:
        return {
            "@type": "MultiLayerConfiguration",
            "global_conf": self.global_conf.to_dict(),
            "layers": [lc.to_dict() for lc in self.layers],
            "preprocessors": {k: pp.to_dict()
                              for k, pp in self.preprocessors.items()},
            "input_type": (None if self.input_type is None
                           else self.input_type.to_dict()),
            **{f: getattr(self, f) for f in self.TRAINING_FIELDS},
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    def to_yaml(self) -> str:
        """The same document as YAML (``yaml.safe_dump`` in key order, as
        the JAX ``to_yaml`` writes it). PyYAML is imported here, at call
        time: the package itself does not need it. The dict goes through
        JSON first, so layers that share a list object are written out in
        full, not as YAML anchors."""
        import yaml

        return yaml.safe_dump(json.loads(self.to_json()), sort_keys=False)

    @staticmethod
    def from_json(text: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(text))

    @staticmethod
    def from_yaml(text: str) -> "MultiLayerConfiguration":
        import yaml

        return MultiLayerConfiguration.from_dict(yaml.safe_load(text))

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        if d.get("@type") != "MultiLayerConfiguration":
            raise ValueError(f"expected a MultiLayerConfiguration, got "
                             f"@type {d.get('@type')!r}")
        global_conf = GlobalConf.from_dict(d.get("global_conf") or {})
        layers = []
        for ld in d["layers"]:
            ld = dict(ld)
            layers.append(LayerConf(type=ld.pop("@type", None), fields=ld))
        preprocessors = {k: preprocessor_from_dict(v)
                         for k, v in (d.get("preprocessors") or {}).items()}
        it = d.get("input_type")
        input_type = None if it is None else InputType.from_dict(it)
        training = {f: d[f] for f in MultiLayerConfiguration.TRAINING_FIELDS
                    if f in d}
        return MultiLayerConfiguration(global_conf, layers, preprocessors,
                                       input_type, **training)


serde.register_reader("MultiLayerConfiguration", MultiLayerConfiguration.from_dict)
