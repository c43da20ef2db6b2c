"""Weights and training state from the JAX package into the port, and back.

:func:`from_jax` takes a JAX ``conf.to_json()`` string and the JAX network's
``params_list`` as numpy arrays (and, to continue a trajectory, its
``updater_state`` and ``iteration``), and returns a port
:class:`~deeplearning4j_tpu_torch.nn.multilayer.MultiLayerNetwork` that
computes the same function and takes the same next step. The two packages'
RNGs differ, so weights cross only this way, never by seed. :func:`to_numpy`
gives a port tree (params, updater state) back as numpy arrays.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from .nn.conf.multilayer import MultiLayerConfiguration
from .nn.multilayer import MultiLayerNetwork


def from_jax(conf_json: str, params_list: List[Dict[str, np.ndarray]],
             device=None, updater_state: Optional[List[dict]] = None,
             iteration: int = 0) -> MultiLayerNetwork:
    """A port network on ``device`` (``None`` means CUDA) with the given
    config and params (matched by layer index and JAX param name). With
    ``updater_state`` (the JAX ``net.updater_state`` as numpy) and
    ``iteration`` the updater state and the step count are carried over
    too; without them the updater state starts at zero."""
    conf = MultiLayerConfiguration.from_json(conf_json)
    net = MultiLayerNetwork(conf, device=device).load_params(params_list)
    if updater_state is not None:
        net.load_updater_state(updater_state, iteration=iteration)
    return net


def to_numpy(tree):
    """A nested list/dict of tensors (``net.params_list``,
    ``net.updater_state``) as the same structure of numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)
