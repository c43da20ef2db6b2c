"""Feed-forward layers of the slice: ``EmbeddingLayer``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/feedforward.py``.
"""
from __future__ import annotations

import torch

from ....common import get_policy
from ..serde import register_layer
from .base import Layer


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` in the policy's compute dtype, returned in its output
    dtype."""
    pol = get_policy()
    cd = pol.compute_dtype
    out = torch.matmul(x.to(cd), params["W"].to(cd))
    return (out.to(cd) + params["b"].to(cd)).to(pol.output_dtype)


@register_layer("Embedding")
class EmbeddingLayer(Layer):
    """Index -> vector lookup, ``act(W[idx] + b)``. Takes integer ids or a
    one-hot encoding, told apart exactly as the JAX layer does; either way
    ``W`` gets its gradient through the gather (the one-hot input itself
    takes none, as in the JAX layer)."""

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def apply(self, params, x, mask=None, train=False, gen=None):
        # one-hot input: rank >= 3 ([B, T, V] sequences), or a floating-point
        # [B, V] matrix; integer ids are never taken for one-hot even when a
        # sequence length equals the vocab size
        one_hot = (x.shape[-1] == self.n_in and self.n_in > 1
                   and (x.ndim >= 3 or (x.ndim == 2 and x.is_floating_point())))
        if one_hot:
            idx = torch.argmax(x, dim=-1)
        else:
            idx = x.to(torch.long)
            if idx.ndim > 1 and idx.shape[-1] == 1:
                idx = idx[..., 0]
        emb = (params["W"][idx] + params["b"]).to(get_policy().output_dtype)
        return self.act_fn()(emb)
