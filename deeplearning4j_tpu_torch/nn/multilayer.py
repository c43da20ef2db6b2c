"""``MultiLayerNetwork``: a stack of layers run forward.

Counterpart of the inference half of ``deeplearning4j_tpu/nn/multilayer.py``
(``init``, ``output``, ``_output_pure``, ``params_list``, ``state_list``).
Training (``fit``) is not part of this port yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..common import resolve_device
from .conf.multilayer import MultiLayerConfiguration
from .conf.serde import layer_class


class MultiLayerNetwork(nn.Module):
    """Layers built from ``conf`` on ``device`` (``None`` means CUDA)."""

    def __init__(self, conf: MultiLayerConfiguration, device=None):
        super().__init__()
        if conf.global_conf.dtype not in (None, "float32"):
            raise ValueError(f"config dtype {conf.global_conf.dtype!r} is not "
                             "supported by this port yet (ROADMAP.md)")
        self.conf = conf
        self.device = resolve_device(device)
        self.layers = nn.ModuleList(
            layer_class(lc.type)(lc, self.device) for lc in conf.layers)
        self._initialized = False

    def init(self, seed: Optional[int] = None) -> "MultiLayerNetwork":
        """Draw every parameter from one CPU ``torch.Generator`` seeded with
        ``seed`` (default: the config's seed), so one seed gives the same
        weights on every device. The JAX package's RNG differs: weights cross
        between the two packages through ``convert.from_jax`` only."""
        gen = torch.Generator(device="cpu")
        gen.manual_seed(self.conf.global_conf.seed if seed is None else seed)
        for layer in self.layers:
            layer.init_params(gen)
        self._initialized = True
        return self

    @torch.no_grad()
    def load_params(self, params_list: List[dict]) -> "MultiLayerNetwork":
        """Copy params given per layer by JAX name (numpy arrays or tensors);
        names and shapes must match exactly."""
        if len(params_list) != len(self.layers):
            raise ValueError(f"{len(params_list)} param dicts for "
                             f"{len(self.layers)} layers")
        for i, (layer, given) in enumerate(zip(self.layers, params_list)):
            own = layer.params()
            if set(given) != set(own):
                raise ValueError(f"layer {i} ({layer.TYPE}) params "
                                 f"{sorted(given)} != expected {sorted(own)}")
            for name, value in given.items():
                t = torch.as_tensor(np.array(value, dtype=np.float32))
                if tuple(t.shape) != tuple(own[name].shape):
                    raise ValueError(f"layer {i} param {name}: shape "
                                     f"{tuple(t.shape)} != "
                                     f"{tuple(own[name].shape)}")
                own[name].copy_(t)
        self._initialized = True
        return self

    def _require_init(self) -> None:
        if not self._initialized:
            raise RuntimeError("network is not initialized: call init() or "
                               "load_params() first")

    @property
    def params_list(self) -> List[dict]:
        return [layer.params() for layer in self.layers]

    @property
    def state_list(self) -> List[dict]:
        return [{} for _ in self.layers]

    def _output_pure(self, params_list, state_list, x: torch.Tensor,
                     mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x
        for layer, params in zip(self.layers, params_list):
            h = layer.apply(params, h, mask)
        return h

    @torch.no_grad()
    def output(self, x) -> torch.Tensor:
        """Forward pass returning the final activations on this network's
        device."""
        self._require_init()
        x = (x.to(self.device) if isinstance(x, torch.Tensor)
             else torch.from_numpy(np.array(x)).to(self.device))
        return self._output_pure(self.params_list, self.state_list, x)
