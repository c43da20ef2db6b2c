"""Weights and training state from the JAX package into the port, and back.

:func:`from_jax` takes a JAX ``conf.to_json()`` string and the JAX network's
``params_list`` as numpy arrays (and, to continue a trajectory, its
``updater_state`` and ``iteration``; for batch norm, its ``state_list``),
and returns the port network of the JSON's ``"@type"``: a
:class:`~deeplearning4j_tpu_torch.nn.multilayer.MultiLayerNetwork` (params,
states and updater state as lists by layer index) or a
:class:`~deeplearning4j_tpu_torch.nn.graph_network.ComputationGraph` (dicts
by vertex name). It computes the same function and takes the same next
step. Params match by JAX name and keep the JAX layouts (dense
``W [in, out]``, convolution ``W [kh, kw, in, out]`` HWIO; the port's
convolutional layers run NHWC as the JAX ones do), so every leaf is copied
as it is. The two packages' RNGs differ, so weights cross only this way,
never by seed. :func:`to_numpy` gives a port tree (params, states, updater
state) back as numpy arrays.
"""
from __future__ import annotations

import json
from typing import Union

import numpy as np
import torch

from .nn.conf.graphconf import ComputationGraphConfiguration
from .nn.conf.multilayer import MultiLayerConfiguration
from .nn.graph_network import ComputationGraph
from .nn.multilayer import MultiLayerNetwork


def from_jax(conf_json: str, params_list, device=None,
             updater_state=None, iteration: int = 0,
             state_list=None) -> Union[MultiLayerNetwork, ComputationGraph]:
    """A port network on ``device`` (``None`` means CUDA) with the given
    config and params. With ``state_list`` (the JAX ``net.state_list`` as
    numpy) the layers' running states (batch norm's mean and var) are
    carried over; without it they start at their init values. With
    ``updater_state`` and ``iteration`` the updater state and the step count
    are carried over too; without them the updater state starts at zero."""
    kind = json.loads(conf_json).get("@type")
    if kind == "ComputationGraphConfiguration":
        net = ComputationGraph(ComputationGraphConfiguration.from_json(
            conf_json), device=device)
    else:
        net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf_json),
                                device=device)
    net.load_params(params_list)
    if state_list is not None:
        net.load_state(state_list)
    if updater_state is not None:
        net.load_updater_state(updater_state, iteration=iteration)
    return net


def to_numpy(tree):
    """A nested list/dict of tensors (``net.params_list``,
    ``net.state_list``, ``net.updater_state``) as the same structure of
    numpy arrays."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(v) for v in tree]
    return np.asarray(tree)
