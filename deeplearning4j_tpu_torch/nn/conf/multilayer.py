"""``MultiLayerConfiguration`` in the JAX package's JSON schema.

Counterpart of ``deeplearning4j_tpu/nn/conf/multilayer.py``. A configuration
is plain data: the global defaults, one :class:`LayerConf` per layer (its
``"@type"`` name and its resolved fields) and the input type.
:meth:`MultiLayerConfiguration.from_json` reads what the JAX package's
``conf.to_json()`` writes, and :meth:`to_json` writes the same schema.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from .serde import layer_class


@dataclasses.dataclass
class InputType:
    kind: str = "recurrent"
    size: int = 0
    height: int = 0
    width: int = 0
    channels: int = 0
    timesteps: int = 0

    def to_dict(self) -> dict:
        return {"@type": "InputType", **dataclasses.asdict(self)}


@dataclasses.dataclass
class GlobalConf:
    """The network-wide defaults that the forward pass reads."""

    seed: int = 12345
    activation: str = "sigmoid"
    weight_init: str = "xavier"
    bias_init: float = 0.0
    dtype: Optional[str] = None

    def to_dict(self) -> dict:
        return {"@type": "GlobalConf", **dataclasses.asdict(self)}


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
    global_conf: GlobalConf
    layers: List[LayerConf]
    input_type: Optional[InputType] = None

    def to_json(self) -> str:
        return json.dumps({
            "@type": "MultiLayerConfiguration",
            "global_conf": self.global_conf.to_dict(),
            "layers": [lc.to_dict() for lc in self.layers],
            "preprocessors": {},
            "input_type": (None if self.input_type is None
                           else self.input_type.to_dict()),
        }, indent=2)

    @staticmethod
    def from_json(text: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(text))

    @staticmethod
    def from_dict(d: dict) -> "MultiLayerConfiguration":
        if d.get("@type") != "MultiLayerConfiguration":
            raise ValueError(f"expected a MultiLayerConfiguration, got "
                             f"@type {d.get('@type')!r}")
        if d.get("preprocessors"):
            raise ValueError("input preprocessors are not supported by this "
                             "port yet (ROADMAP.md)")
        g = d.get("global_conf") or {}
        gfields = {f.name for f in dataclasses.fields(GlobalConf)}
        global_conf = GlobalConf(**{k: v for k, v in g.items() if k in gfields})
        layers = []
        for ld in d["layers"]:
            ld = dict(ld)
            layers.append(LayerConf(type=ld.pop("@type", None), fields=ld))
        it = d.get("input_type")
        input_type = None
        if it is not None:
            ifields = {f.name for f in dataclasses.fields(InputType)}
            input_type = InputType(**{k: v for k, v in it.items()
                                      if k in ifields})
        return MultiLayerConfiguration(global_conf, layers, input_type)
