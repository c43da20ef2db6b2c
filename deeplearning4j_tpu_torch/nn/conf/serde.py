"""The ``"@type"`` registry of the JAX package's JSON config schema.

Counterpart of ``deeplearning4j_tpu/nn/conf/serde.py``. Layer classes
register under the JAX package's registry names (``"Embedding"``,
``"TransformerBlock"``, ``"GravesLSTM"``, ``"RnnOutput"``), so a JAX ``conf.to_json()`` reads
here unchanged. A name that is not registered raises.
"""
from __future__ import annotations

from typing import Dict

LAYER_TYPES: Dict[str, type] = {}

#: layer types the JAX package registers that this port does not have yet
#: (queued in ROADMAP.md)
NOT_YET_PORTED = (
    "Dense", "Output", "Loss", "Activation", "Dropout", "AutoEncoder", "RBM",
    "VariationalAutoencoder", "SelfAttention", "MoE", "MoETransformerBlock",
    "BatchNormalization", "LocalResponseNormalization", "Convolution",
    "Subsampling", "Upsampling2D", "ZeroPadding", "GlobalPooling")


def register_layer(name: str):
    """Class decorator: register a layer module under its ``"@type"`` name."""
    def deco(cls):
        cls.TYPE = name
        LAYER_TYPES[name] = cls
        return cls
    return deco


def layer_class(name: str) -> type:
    from . import layers  # noqa: F401  (registers the layer modules)
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"layer @type {name!r} is not ported yet "
                                  "(ROADMAP.md)")
    try:
        return LAYER_TYPES[name]
    except KeyError:
        raise ValueError(f"unknown layer @type {name!r}; this port reads "
                         f"{sorted(LAYER_TYPES)}") from None
