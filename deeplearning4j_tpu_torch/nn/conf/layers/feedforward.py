"""Dense-family layers: ``DenseLayer``, ``OutputLayer``, ``LossLayer``,
``ActivationLayer``, ``DropoutLayer`` and ``EmbeddingLayer``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/feedforward.py`` (its
``AutoEncoder`` and ``RBM`` wait for layerwise pretraining, ROADMAP.md).
``W`` is ``[n_in, out]`` as in the JAX package. An ``OutputLayer`` with
``mcxent`` and a softmax takes the fused softmax cross-entropy
(``ops/losses.py``), the ``sm_xent`` kernel on the card.
"""
from __future__ import annotations

import torch

from ....common import get_policy
from ....ops.losses import get_loss
from ..serde import register_layer
from .base import FeedForwardLayer, Layer


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` in the policy's compute dtype, returned in its output
    dtype."""
    pol = get_policy()
    cd = pol.compute_dtype
    out = torch.matmul(x.to(cd), params["W"].to(cd))
    return (out.to(cd) + params["b"].to(cd)).to(pol.output_dtype)


@register_layer("Dense")
class DenseLayer(FeedForwardLayer):
    """Fully connected: ``act(x @ W + b)``."""

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,)}

    def apply(self, params, x, mask=None, train=False, gen=None):
        x = self.apply_dropout(x, gen, train)
        return self.act_fn()(dense(params, x))


@register_layer("Output")
class OutputLayer(DenseLayer):
    """A dense layer with a loss; it ends backprop."""

    FIELDS = {**FeedForwardLayer.FIELDS, "loss": "mcxent"}

    def __init__(self, conf, device):
        super().__init__(conf, device)
        self.loss = conf.get("loss", "mcxent")

    def has_loss(self) -> bool:
        return True

    def preout(self, params, x):
        return dense(params, x)

    def compute_loss(self, params, x, labels, mask=None) -> torch.Tensor:
        """The configured loss of ``labels`` against ``act(x @ W + b)``."""
        return get_loss(self.loss)(labels, self.preout(params, x),
                                   self.act_fn(), mask)


@register_layer("Loss")
class LossLayer(Layer):
    """A loss without parameters: ``act(x)`` against the labels."""

    FIELDS = {"loss": "mcxent"}

    def __init__(self, conf, device):
        super().__init__(conf, device)
        self.loss = conf.get("loss", "mcxent")

    def has_loss(self) -> bool:
        return True

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        return self.act_fn()(x)

    def compute_loss(self, params, x, labels, mask=None) -> torch.Tensor:
        return get_loss(self.loss)(labels, x, self.act_fn(), mask)


@register_layer("Activation")
class ActivationLayer(Layer):
    """An activation on its own."""

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        return self.act_fn()(x)


@register_layer("Dropout")
class DropoutLayer(Layer):
    """Dropout on its own; ``dropout`` is the retain probability."""

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        return self.apply_dropout(x, gen, train)


@register_layer("Embedding")
class EmbeddingLayer(FeedForwardLayer):
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
