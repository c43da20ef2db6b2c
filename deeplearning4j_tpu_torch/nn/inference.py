"""Snapshot-pinned inference: the serving seam.

Counterpart of ``deeplearning4j_tpu/nn/inference.py``. :class:`PredictFn`
pins a copy of a network's parameters and layer states on its device, so
serving never sees a later change to the source network and the source
never sees serving. It serves a ``MultiLayerNetwork`` or a
``ComputationGraph``; a graph takes one positional array per declared input
(:attr:`PredictFn.n_inputs`) and returns its one output, or a list when it
declares several.
With ``quant="int8"`` the pinned copy holds int8 codes and per-channel
scales (``ops/quant.py``) and is dequantized on every call, as the JAX
package does inside its compiled program (``inference.py:60``): the weights
at rest are 8-bit, the forward computes on the dequantized float copy.
Every call runs under the dtype policy the network's config names (the
ambient one when it names none), as the JAX ``PredictFn``'s program is
traced under it. :func:`make_predict_fn` decorates the pin's name as the
JAX package does (``serve_predict@v2+int8~r0``). Sharded pins
(``sharding=``, ``mesh=``) wait for the parallel modes (ROADMAP.md A7.8).
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..common import resolve_device, wrap_with_policy
from .graph_network import ComputationGraph
from ..ops.quant import dequantize_tree, quantize_tree, tree_param_bytes

#: the name every serving forward pins under, decorated per version, int8
#: policy and replica by :func:`make_predict_fn`
PREDICT_PROGRAM_NAME = "serve_predict"

#: serving dtype policies: None and "bf16" serve the snapshot at the
#: network's policy dtype; "int8" quantizes the large matrix leaves at pin
#: time
QUANT_MODES = (None, "bf16", "int8")


def copy_tree(tree, device: torch.device):
    """Real copies on ``device`` of a per-layer tree of tensor dicts, params
    or layer states: a list (a ``MultiLayerNetwork``'s, by layer) or a dict
    (a ``ComputationGraph``'s, by vertex)."""
    def copy_dict(p):
        return {k: v.detach().clone().to(device) for k, v in p.items()}
    if isinstance(tree, dict):
        return {n: copy_dict(p) for n, p in tree.items()}
    return [copy_dict(p) for p in tree]


def to_device_tensor(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x)).to(device)


def _refuse_sharding(sharding, mesh) -> None:
    if sharding is not None or mesh is not None:
        raise NotImplementedError(
            "sharded serving pins (sharding=, mesh=) wait for the parallel "
            "modes over torch.distributed (ROADMAP.md A7.8)")


class PredictFn:
    """A snapshot-pinned forward pass on ``device`` (``None`` means CUDA).

    ``predict_fn(*xs) -> tensor`` on the pin's device, where each input
    carries a leading batch axis: one for a ``MultiLayerNetwork``, one per
    declared input for a ``ComputationGraph`` (a graph with several outputs
    returns a list). Thread-safe: the pinned tensors are only read."""

    def __init__(self, net, quant: Optional[str] = None, device=None,
                 name: str = PREDICT_PROGRAM_NAME, sharding=None, mesh=None):
        net._require_init()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        _refuse_sharding(sharding, mesh)
        self._net = net
        self._name = name
        #: placement of the pin; sharded pins are not ported (A7.8)
        self.sharding = None
        self.quant = quant if quant == "int8" else None
        self.device = resolve_device(device)
        # copies at pin time: a later fit of ``net`` changes neither the
        # served weights nor the served batch-norm statistics
        self._params = copy_tree(net.params_list, self.device)
        self._states = copy_tree(net.state_list, self.device)
        self._graph = isinstance(net, ComputationGraph)
        self._n_in = len(net.conf.network_inputs) if self._graph else 1
        self._single_out = (not self._graph
                            or len(net.conf.network_outputs) == 1)
        if self.quant == "int8":
            self._params = quantize_tree(self._params)
        #: the network's forward under the policy its config names
        self._forward = wrap_with_policy(net._output_pure,
                                         net.conf.global_conf.dtype)
        self._lock = threading.Lock()
        self.calls = 0  #: dispatches served
        #: the batch sizes :meth:`warm` has run, in order
        self.warmed: list = []

    @property
    def name(self) -> str:
        return self._name

    @property
    def n_inputs(self) -> int:
        """Positional input arrays one call takes (1 for a stack)."""
        return self._n_in

    @property
    def param_bytes(self) -> int:
        """Resident bytes of the pinned params (int8 shows the 4x cut)."""
        return tree_param_bytes(self._params)

    def _run(self, xs):
        if len(xs) != self._n_in:
            raise ValueError(f"model takes {self._n_in} input(s), "
                             f"got {len(xs)}")
        params = self._params
        if self.quant == "int8":
            params = dequantize_tree(params)
        xs = [to_device_tensor(x, self.device) for x in xs]
        if not self._graph:
            return self._forward(params, self._states, xs[0])
        outs = self._forward(params, self._states, xs)
        return outs[0] if self._single_out else outs

    @torch.no_grad()
    def __call__(self, *xs):
        out = self._run(xs)
        with self._lock:
            self.calls += 1
        return out

    @torch.no_grad()
    def warm(self, *xs) -> None:
        """One forward on an example batch, waited for, so its kernels are
        built and the libraries' algorithms chosen before the pin serves;
        not counted in :attr:`calls`."""
        self._run(xs)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            self.warmed.append(int(np.shape(xs[0])[0]))


def make_predict_fn(net, name: str = PREDICT_PROGRAM_NAME,
                    version: Optional[str] = None,
                    quant: Optional[str] = None, device=None,
                    replica: Optional[int] = None, sharding=None,
                    mesh=None) -> PredictFn:
    """Pin ``net`` for serving on ``device`` (``None`` means CUDA). The name
    gains ``@version``, ``+int8`` and ``~r<replica>`` as in the JAX package,
    so each version's and each replica's pin is told apart in status."""
    _refuse_sharding(sharding, mesh)
    if version:
        name = f"{name}@{version}"
    if quant == "int8":
        name = f"{name}+int8"
    if replica is not None:
        name = f"{name}~r{replica}"
    return PredictFn(net, quant=quant, device=device, name=name)
