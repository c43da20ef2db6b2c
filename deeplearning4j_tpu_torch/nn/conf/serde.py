"""The ``"@type"`` registry of the JAX package's JSON config schema.

Counterpart of ``deeplearning4j_tpu/nn/conf/serde.py``. Layer classes
register under the JAX package's registry names (``"Dense"``,
``"Convolution"``, ``"GravesLSTM"``, ``"TransformerBlock"``, ...), so a JAX
``conf.to_json()`` reads here unchanged: every layer type the JAX package
registers is registered here. A name that is not registered raises.
"""
from __future__ import annotations

from typing import Dict

LAYER_TYPES: Dict[str, type] = {}

def register_layer(name: str):
    """Class decorator: register a layer module under its ``"@type"`` name."""
    def deco(cls):
        cls.TYPE = name
        LAYER_TYPES[name] = cls
        return cls
    return deco


def layer_class(name: str) -> type:
    from . import layers  # noqa: F401  (registers the layer modules)
    try:
        return LAYER_TYPES[name]
    except KeyError:
        raise ValueError(f"unknown layer @type {name!r}; this port reads "
                         f"{sorted(LAYER_TYPES)}") from None
