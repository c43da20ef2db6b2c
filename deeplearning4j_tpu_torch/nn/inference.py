"""Snapshot-pinned inference: the serving seam.

Counterpart of ``deeplearning4j_tpu/nn/inference.py``. :class:`PredictFn`
pins a copy of a network's parameters and layer states on its device, so
serving never sees a later change to the source network and the source
never sees serving. It serves a ``MultiLayerNetwork`` or a
``ComputationGraph`` of one input and one output.
With ``quant="int8"`` the pinned copy holds int8 codes and per-channel
scales (``ops/quant.py``) and is dequantized on every call, as the JAX
package does inside its compiled program (``inference.py:60``): the weights
at rest are 8-bit, the forward computes on the dequantized float copy.
Every call runs under the dtype policy the network's config names (the
ambient one when it names none), as the JAX ``PredictFn``'s program is
traced under it.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..common import resolve_device, wrap_with_policy
from .graph_network import ComputationGraph
from ..ops.quant import dequantize_tree, quantize_tree, tree_param_bytes

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


class PredictFn:
    """A snapshot-pinned forward pass on ``device`` (``None`` means CUDA).

    ``predict_fn(x) -> tensor`` on the pin's device, where ``x`` carries a
    leading batch axis. Thread-safe: the pinned tensors are only read."""

    def __init__(self, net, quant: Optional[str] = None, device=None):
        net._require_init()
        if quant not in QUANT_MODES:
            raise ValueError(f"quant must be one of {QUANT_MODES}, got {quant!r}")
        self._net = net
        self.quant = quant if quant == "int8" else None
        self.device = resolve_device(device)
        # copies at pin time: a later fit of ``net`` changes neither the
        # served weights nor the served batch-norm statistics
        self._params = copy_tree(net.params_list, self.device)
        self._states = copy_tree(net.state_list, self.device)
        #: a ComputationGraph serves its one input and one output here
        self._graph = isinstance(net, ComputationGraph)
        if self._graph and (len(net.conf.network_inputs) != 1
                            or len(net.conf.network_outputs) != 1):
            raise ValueError("PredictFn serves graphs of one input and one "
                             "output")
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
    def param_bytes(self) -> int:
        """Resident bytes of the pinned params (int8 shows the 4x cut)."""
        return tree_param_bytes(self._params)

    def _run(self, x) -> torch.Tensor:
        params = self._params
        if self.quant == "int8":
            params = dequantize_tree(params)
        x = to_device_tensor(x, self.device)
        if self._graph:
            return self._forward(params, self._states, [x])[0]
        return self._forward(params, self._states, x)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        out = self._run(x)
        with self._lock:
            self.calls += 1
        return out

    @torch.no_grad()
    def warm(self, *xs) -> None:
        """One forward on an example batch, waited for, so its kernels are
        built and the libraries' algorithms chosen before the pin serves;
        not counted in :attr:`calls`."""
        if len(xs) != 1:
            raise ValueError(f"PredictFn serves one input, got {len(xs)}")
        self._run(xs[0])
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        with self._lock:
            self.warmed.append(int(np.shape(xs[0])[0]))
