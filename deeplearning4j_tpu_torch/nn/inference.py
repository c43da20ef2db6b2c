"""Snapshot-pinned inference: the serving seam.

Counterpart of ``deeplearning4j_tpu/nn/inference.py``. :class:`PredictFn`
pins a copy of a network's parameters on its device, so serving never sees
a later change to the source network and the source never sees serving.
With ``quant="int8"`` the pinned copy holds int8 codes and per-channel
scales (``ops/quant.py``) and is dequantized on every call, as the JAX
package does inside its compiled program (``inference.py:60``): the weights
at rest are 8-bit, the forward computes on the dequantized float copy.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from ..common import resolve_device
from ..ops.quant import dequantize_tree, quantize_tree, tree_param_bytes

#: serving dtype policies: None serves the snapshot at the network's policy
#: dtype; "int8" quantizes the large matrix leaves at pin time
QUANT_MODES = (None, "int8")


def copy_params(params_list, device: torch.device):
    """Real copies of a list of param dicts on ``device``."""
    return [{k: v.detach().clone().to(device) for k, v in p.items()}
            for p in params_list]


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
        self.quant = quant
        self.device = resolve_device(device)
        self._params = copy_params(net.params_list, self.device)
        self._states = net.state_list
        if self.quant == "int8":
            self._params = quantize_tree(self._params)
        self._lock = threading.Lock()
        self.calls = 0  #: dispatches served

    @property
    def param_bytes(self) -> int:
        """Resident bytes of the pinned params (int8 shows the 4x cut)."""
        return tree_param_bytes(self._params)

    @torch.no_grad()
    def __call__(self, x) -> torch.Tensor:
        params = self._params
        if self.quant == "int8":
            params = dequantize_tree(params)
        out = self._net._output_pure(params, self._states,
                                     to_device_tensor(x, self.device))
        with self._lock:
            self.calls += 1
        return out

