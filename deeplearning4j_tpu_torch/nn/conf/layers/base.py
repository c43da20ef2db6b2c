"""Layer base classes: an ``nn.Module`` built from a layer config.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/base.py``: ``Layer`` holds
the fields every layer has, ``FeedForwardLayer`` adds ``n_in`` and ``n_out``
(a pooling or activation layer has neither). A layer class also owns its
config side, as the JAX dataclass does: :meth:`Layer.conf` makes a
``LayerConf`` with the JAX defaults of every field (what the builder DSL
takes), and :meth:`Layer.set_n_in` and :meth:`Layer.output_type` walk an
``InputType`` through it at ``build()``. Parameters
keep the JAX names (``W``, ``b``, ``ln1_g``, ``Wqkv``, ...) and the JAX
``[in, out]`` layout, so per-output-channel int8 scales stay on the last
axis; they are trainable. ``apply(params, x, mask, train, gen)`` is the pure
forward over an explicit param dict (the module's own parameters when
training, a pinned snapshot when serving); ``forward(x)`` runs it over the
module's own parameters.

A layer with running state (batch norm's mean and var) declares it in
:meth:`Layer.init_state` and keeps it as buffers under the JAX state names.
:meth:`Layer.apply_with_state` is the forward over explicit params and state
that returns ``(out, new_state)``, as the JAX ``apply(params, state, x, ...)``
does: the new state comes out of the forward and is written by the network
after the step, never in place inside the forward (a checkpointed layer runs
its forward twice).

A :class:`PretrainLayer` (``AutoEncoder``, ``RBM``,
``VariationalAutoencoder``) adds :meth:`PretrainLayer.pretrain_loss`, the
objective of greedy layerwise pretraining.

Dropout follows DL4J: ``dropout`` is the *retain* probability, and kept
values are divided by it (inverted dropout). It applies only in training
and only when a ``torch.Generator`` is given.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ....ops.activations import get_activation
from ...weights import init_weights
from ..inputs import InputType

#: the fields of every layer, in the JAX ``Layer`` dataclass's order; None
#: inherits the network default at ``build()``
BASE_FIELDS = (
    "name", "activation", "weight_init", "dist", "bias_init", "l1", "l2",
    "dropout", "learning_rate", "bias_learning_rate", "updater", "momentum",
    "rho", "rms_decay", "adam_mean_decay", "adam_var_decay", "epsilon",
    "gradient_normalization", "gradient_normalization_threshold")


def init_weight(gen: torch.Generator, shape: Tuple[int, ...],
                scheme: str, dist: Optional[dict] = None) -> torch.Tensor:
    """A weight drawn on the CPU from ``gen`` per DL4J WeightInit name
    (``nn/weights.py``)."""
    return init_weights(gen, shape, scheme, dist)


class Layer(nn.Module):
    """Hyperparameters from one ``LayerConf`` plus named parameters."""

    TYPE = ""
    #: the type's own fields and their JAX defaults, in the dataclass's order
    FIELDS: Dict[str, object] = {}

    @classmethod
    def conf(cls, **fields):
        """A ``LayerConf`` of this type: every base field None (inherited at
        ``build()``), the type's fields at their JAX defaults, then
        ``fields``. An unknown field raises."""
        from ..multilayer import LayerConf
        unknown = sorted(set(fields) - set(BASE_FIELDS) - set(cls.FIELDS))
        if unknown:
            raise TypeError(f"{cls.__name__} has no fields {unknown}")
        return LayerConf(cls.TYPE, {**dict.fromkeys(BASE_FIELDS),
                                    **cls.FIELDS, **fields})

    @classmethod
    def set_n_in(cls, fields: dict, itype: InputType) -> None:
        """Fill the input-size fields from the incoming type (in place)."""

    @classmethod
    def output_type(cls, fields: dict, itype: InputType) -> InputType:
        return itype

    def __init__(self, conf, device: torch.device):
        super().__init__()
        # the global defaults are baked into every LayerConf
        # (``MultiLayerConfiguration``), so the layer reads them as they are
        self.activation = conf["activation"]
        self.weight_init = conf["weight_init"]
        self.dist = conf["dist"]
        self.bias_init = float(conf["bias_init"])
        self.l1 = float(conf["l1"])
        self.l2 = float(conf["l2"])
        self.dropout = float(conf["dropout"])
        self.learning_rate = float(conf["learning_rate"])
        self.bias_learning_rate = float(conf["bias_learning_rate"])
        self.updater = conf["updater"]
        self.momentum = float(conf["momentum"])
        self.momentum_schedule = conf.get("momentum_schedule")
        self.rho = float(conf["rho"])
        self.rms_decay = float(conf["rms_decay"])
        self.adam_mean_decay = float(conf["adam_mean_decay"])
        self.adam_var_decay = float(conf["adam_var_decay"])
        self.epsilon = float(conf["epsilon"])
        self.gradient_normalization = conf["gradient_normalization"]
        self.gradient_normalization_threshold = float(
            conf["gradient_normalization_threshold"])
        self.device = device
        for name, shape in self.param_shapes().items():
            self.register_parameter(name, nn.Parameter(
                torch.zeros(shape, device=device)))
        for name, value in self.init_state().items():
            self.register_buffer(name, value.to(device))

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {}

    def init_state(self) -> Dict[str, torch.Tensor]:
        """The layer's running state at init, by JAX name (CPU tensors);
        empty for a layer without state."""
        return {}

    def state(self) -> Dict[str, torch.Tensor]:
        """The layer's running state (its buffers) by JAX name."""
        return dict(self.named_buffers(recurse=False))

    @torch.no_grad()
    def reset_state(self) -> None:
        for name, value in self.init_state().items():
            getattr(self, name).copy_(value)

    def regularizable_params(self) -> Sequence[str]:
        """Param names subject to l1/l2 (weights, not biases)."""
        return ("W",)

    def has_loss(self) -> bool:
        """True for output layers that end backprop with a loss function."""
        return False

    def is_pretrain_layer(self) -> bool:
        """True for layers with an unsupervised objective
        (:class:`PretrainLayer`)."""
        return False

    def init_param(self, name: str, shape, gen: torch.Generator) -> torch.Tensor:
        """Weights (``W*``) by the weight-init scheme, biases by bias_init."""
        if name.startswith("W"):
            return init_weight(gen, shape, self.weight_init, self.dist)
        return torch.full(shape, self.bias_init)

    @torch.no_grad()
    def init_params(self, gen: torch.Generator) -> None:
        for name, shape in self.param_shapes().items():
            getattr(self, name).copy_(self.init_param(name, shape, gen))

    def params(self) -> Dict[str, torch.Tensor]:
        """The layer's parameters by JAX name (trainable tensors)."""
        return dict(self.named_parameters())

    def act_fn(self):
        return get_activation(self.activation or "identity")

    def apply_dropout(self, x: torch.Tensor, gen: Optional[torch.Generator],
                      train: bool) -> torch.Tensor:
        """Inverted dropout with retain probability ``self.dropout``: keep
        each value with that probability and divide kept values by it."""
        p = self.dropout
        if not train or not self.uses_dropout() or gen is None:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) < p
        return torch.where(keep, x / p, torch.zeros((), dtype=x.dtype,
                                                    device=x.device))

    def uses_dropout(self) -> bool:
        return 0.0 < self.dropout < 1.0

    def apply(self, params: dict, x: torch.Tensor,
              mask: Optional[torch.Tensor] = None, train: bool = False,
              gen: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError

    def apply_with_state(self, params: dict, state: dict, x: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         train: bool = False,
                         gen: Optional[torch.Generator] = None):
        """``(out, new_state)``: the forward over explicit params and state.
        A layer without state hands its state back unchanged."""
        return self.apply(params, x, mask, train, gen), state

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.apply_with_state(self.params(), self.state(), x, mask)[0]


class FeedForwardLayer(Layer):
    """A layer with an ``n_in -> n_out`` shape contract."""

    FIELDS = {"n_in": 0, "n_out": 0}

    @classmethod
    def set_n_in(cls, fields, itype):
        if not fields.get("n_in"):
            fields["n_in"] = (itype.size if itype.kind == "recurrent"
                              else itype.flat_size())

    @classmethod
    def output_type(cls, fields, itype):
        if itype.kind == "recurrent":
            return InputType.recurrent(fields["n_out"], itype.timesteps)
        return InputType.feed_forward(fields["n_out"])

    def __init__(self, conf, device: torch.device):
        self.n_in = int(conf["n_in"])
        self.n_out = int(conf["n_out"])
        super().__init__(conf, device)


def random_uniform(gen: Optional[torch.Generator], shape,
                   device) -> torch.Tensor:
    """Uniforms in [0, 1) drawn on ``device`` from ``gen``, a generator on
    that device (as the dropout masks' are)."""
    return torch.rand(tuple(shape), generator=gen, device=device)


def random_normal(gen: Optional[torch.Generator], shape,
                  device) -> torch.Tensor:
    """Standard normals drawn as :func:`random_uniform` draws uniforms."""
    return torch.randn(tuple(shape), generator=gen, device=device)


class PretrainLayer(FeedForwardLayer):
    """A layer with an unsupervised objective, minimized by layerwise
    pretraining (``MultiLayerNetwork.pretrain_layer``,
    ``ComputationGraph.pretrain_layer``).

    :meth:`pretrain_loss` takes its random draws from ``noise`` when given
    (uniforms for a Bernoulli draw, normals for the VAE, in the order the
    JAX layer splits its key), else from ``gen``. The JAX package's
    ``jax.random`` bits cannot be made in torch, so a test that holds the
    port against it passes the JAX draws in ``noise``."""

    def is_pretrain_layer(self) -> bool:
        return True

    def pretrain_loss(self, params: dict, x: torch.Tensor, *,
                      gen: Optional[torch.Generator] = None,
                      noise=None) -> torch.Tensor:
        raise NotImplementedError
