"""Weights from the JAX package into the port.

:func:`from_jax` takes a JAX ``conf.to_json()`` string and the JAX network's
``params_list`` as numpy arrays, and returns a port
:class:`~deeplearning4j_tpu_torch.nn.multilayer.MultiLayerNetwork` that
computes the same function. The two packages' RNGs differ, so weights cross
only this way, never by seed.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .nn.conf.multilayer import MultiLayerConfiguration
from .nn.multilayer import MultiLayerNetwork


def from_jax(conf_json: str, params_list: List[Dict[str, np.ndarray]],
             device=None) -> MultiLayerNetwork:
    """A port network on ``device`` (``None`` means CUDA) with the given
    config and params (matched by layer index and JAX param name)."""
    conf = MultiLayerConfiguration.from_json(conf_json)
    return MultiLayerNetwork(conf, device=device).load_params(params_list)
