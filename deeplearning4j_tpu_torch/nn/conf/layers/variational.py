"""The variational autoencoder layer and its reconstruction distributions.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/variational.py``. The
pretraining objective is the negative ELBO with the reparameterization
trick; the supervised forward is the mean of q(z|x). Encoder and decoder
are MLPs of ``encoder_layer_sizes`` and ``decoder_layer_sizes`` units.

p(x|z) is one of the reconstruction distributions below: Gaussian (learned
variance), Bernoulli (logits), Exponential, or a Composite of them over
feature slices. A config names one by a string shortcut (``"gaussian"``,
``"bernoulli"``, ``"exponential"``) or holds its JSON object, which is the
JAX package's (``{"@type": "CompositeReconstruction", "components":
[[3, {"@type": "GaussianReconstruction", "activation": "tanh"}], ...]}``);
a distribution object given to :meth:`VariationalAutoencoder.conf` is
stored as its JSON object.
"""
from __future__ import annotations

import math
from typing import List, Optional

import torch
import torch.nn.functional as F

from ....ops.activations import get_activation
from ..inputs import InputType
from ..serde import register_layer
from .base import FeedForwardLayer, PretrainLayer, random_normal


class ReconstructionDistribution:
    """p(x|z) from the decoder's pre-output ``pre``: a negative
    log-likelihood and a mean."""

    TYPE = ""

    def input_size(self, data_size: int) -> int:
        """Decoder output units for ``data_size`` features."""
        raise NotImplementedError

    def nll(self, x: torch.Tensor, pre: torch.Tensor) -> torch.Tensor:
        """Each example's ``-log p(x|z)``, summed over the features."""
        raise NotImplementedError

    def mean(self, pre: torch.Tensor) -> torch.Tensor:
        """E[x|z]."""
        raise NotImplementedError

    def to_dict(self) -> dict:
        return {"@type": self.TYPE}


class GaussianReconstructionDistribution(ReconstructionDistribution):
    """Diagonal Gaussian with learned variance: ``pre`` is ``[mean |
    logvar]``, ``activation`` applies to the mean half."""

    TYPE = "GaussianReconstruction"

    def __init__(self, activation: str = "identity"):
        self.activation = activation

    def input_size(self, data_size):
        return 2 * data_size

    def _split(self, pre):
        d = pre.shape[-1] // 2
        return get_activation(self.activation)(pre[..., :d]), pre[..., d:]

    def nll(self, x, pre):
        rmean, rlogvar = self._split(pre)
        return 0.5 * torch.sum(rlogvar + (x - rmean) ** 2 / torch.exp(rlogvar)
                               + math.log(2 * math.pi), dim=-1)

    def mean(self, pre):
        return self._split(pre)[0]

    def to_dict(self):
        return {"@type": self.TYPE, "activation": self.activation}


class BernoulliReconstructionDistribution(ReconstructionDistribution):
    """Bernoulli over logits (sigmoid parameterization)."""

    TYPE = "BernoulliReconstruction"

    def input_size(self, data_size):
        return data_size

    def nll(self, x, pre):
        return torch.sum(x * F.softplus(-pre) + (1 - x) * F.softplus(pre),
                         dim=-1)

    def mean(self, pre):
        return torch.sigmoid(pre)


class ExponentialReconstructionDistribution(ReconstructionDistribution):
    """Exponential with rate ``exp(gamma)``, ``gamma = act(pre)``:
    ``log p(x) = gamma - exp(gamma) x``, mean ``exp(-gamma)``."""

    TYPE = "ExponentialReconstruction"

    def __init__(self, activation: str = "identity"):
        self.activation = activation

    def input_size(self, data_size):
        return data_size

    def nll(self, x, pre):
        gamma = get_activation(self.activation)(pre)
        return torch.sum(torch.exp(gamma) * x - gamma, dim=-1)

    def mean(self, pre):
        return torch.exp(-get_activation(self.activation)(pre))

    def to_dict(self):
        return {"@type": self.TYPE, "activation": self.activation}


class CompositeReconstructionDistribution(ReconstructionDistribution):
    """Distributions over feature slices, in feature order:
    ``components`` is a list of ``[data_size, distribution]`` pairs."""

    TYPE = "CompositeReconstruction"

    def __init__(self, components: Optional[List] = None):
        self.components = [[int(s), resolve_reconstruction_distribution(d)]
                           for s, d in (components or [])]

    def add(self, data_size: int, dist) -> "CompositeReconstructionDistribution":
        self.components.append([int(data_size),
                                resolve_reconstruction_distribution(dist)])
        return self

    def input_size(self, data_size):
        total = sum(s for s, _ in self.components)
        if total != data_size:
            raise ValueError(f"composite components cover {total} features, "
                             f"layer has {data_size}")
        return sum(d.input_size(s) for s, d in self.components)

    def nll(self, x, pre):
        total = 0.0
        xo = po = 0
        for s, d in self.components:
            ins = d.input_size(s)
            total = total + d.nll(x[..., xo:xo + s], pre[..., po:po + ins])
            xo += s
            po += ins
        return total

    def mean(self, pre):
        outs = []
        po = 0
        for s, d in self.components:
            ins = d.input_size(s)
            outs.append(d.mean(pre[..., po:po + ins]))
            po += ins
        return torch.cat(outs, dim=-1)

    def to_dict(self):
        return {"@type": self.TYPE,
                "components": [[s, d.to_dict()] for s, d in self.components]}


_SHORTCUTS = {
    "gaussian": GaussianReconstructionDistribution,
    "bernoulli": BernoulliReconstructionDistribution,
    "exponential": ExponentialReconstructionDistribution,
}
_BY_TYPE = {cls.TYPE: cls for cls in (
    GaussianReconstructionDistribution, BernoulliReconstructionDistribution,
    ExponentialReconstructionDistribution,
    CompositeReconstructionDistribution)}


def resolve_reconstruction_distribution(rd) -> ReconstructionDistribution:
    """A distribution from a string shortcut, its JSON object or itself."""
    if isinstance(rd, ReconstructionDistribution):
        return rd
    if isinstance(rd, str):
        if rd not in _SHORTCUTS:
            raise ValueError(f"unknown reconstruction distribution {rd!r}; "
                             f"known: {sorted(_SHORTCUTS)}")
        return _SHORTCUTS[rd]()
    if isinstance(rd, dict) and rd.get("@type") in _BY_TYPE:
        fields = {k: v for k, v in rd.items() if k != "@type"}
        return _BY_TYPE[rd["@type"]](**fields)
    raise TypeError(f"reconstruction_distribution must be a string, a "
                    f"distribution or its JSON object, got {rd!r}")


@register_layer("VariationalAutoencoder")
class VariationalAutoencoder(PretrainLayer):
    """Encoder MLP -> q(z|x) = N(mean, exp(logvar)) -> decoder MLP ->
    p(x|z). Params: ``eW{i}``/``eb{i}`` per encoder layer, ``zMeanW``,
    ``zMeanb``, ``zLogVarW``, ``zLogVarb``, ``dW{i}``/``db{i}`` per decoder
    layer, ``outW``/``outb`` (the distribution's input size)."""

    FIELDS = {**FeedForwardLayer.FIELDS, "encoder_layer_sizes": (100,),
              "decoder_layer_sizes": (100,),
              "reconstruction_distribution": "gaussian",
              "pzx_activation": "identity", "num_samples": 1}

    @classmethod
    def conf(cls, **fields):
        rd = fields.get("reconstruction_distribution")
        if isinstance(rd, ReconstructionDistribution):
            fields["reconstruction_distribution"] = rd.to_dict()
        return super().conf(**fields)

    @classmethod
    def output_type(cls, fields, itype):
        return InputType.feed_forward(fields["n_out"])

    def __init__(self, conf, device):
        self.encoder_layer_sizes = [int(s) for s in
                                    conf.get("encoder_layer_sizes", (100,))]
        self.decoder_layer_sizes = [int(s) for s in
                                    conf.get("decoder_layer_sizes", (100,))]
        self.recon_dist = resolve_reconstruction_distribution(
            conf.get("reconstruction_distribution", "gaussian"))
        self.pzx_activation = conf.get("pzx_activation", "identity")
        self.num_samples = int(conf.get("num_samples", 1))
        super().__init__(conf, device)

    def _weight_names(self) -> list:
        return ([f"eW{i}" for i in range(len(self.encoder_layer_sizes))]
                + ["zMeanW", "zLogVarW"]
                + [f"dW{i}" for i in range(len(self.decoder_layer_sizes))]
                + ["outW"])

    def param_shapes(self):
        shapes = {}
        sizes = [self.n_in] + self.encoder_layer_sizes
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            shapes[f"eW{i}"], shapes[f"eb{i}"] = (a, b), (b,)
        shapes["zMeanW"], shapes["zMeanb"] = (sizes[-1], self.n_out), (self.n_out,)
        shapes["zLogVarW"] = (sizes[-1], self.n_out)
        shapes["zLogVarb"] = (self.n_out,)
        dsizes = [self.n_out] + self.decoder_layer_sizes
        for i, (a, b) in enumerate(zip(dsizes[:-1], dsizes[1:])):
            shapes[f"dW{i}"], shapes[f"db{i}"] = (a, b), (b,)
        out_units = self.recon_dist.input_size(self.n_in)
        shapes["outW"], shapes["outb"] = (dsizes[-1], out_units), (out_units,)
        return shapes

    def init_param(self, name, shape, gen):
        if name in self._weight_names():
            return super().init_param("W", shape, gen)
        return torch.full(shape, self.bias_init)

    def regularizable_params(self):
        return tuple(self._weight_names())

    def _encode(self, params, x):
        act = self.act_fn()
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = act(torch.matmul(h, params[f"eW{i}"]) + params[f"eb{i}"])
        mean = get_activation(self.pzx_activation)(
            torch.matmul(h, params["zMeanW"]) + params["zMeanb"])
        logvar = torch.matmul(h, params["zLogVarW"]) + params["zLogVarb"]
        return mean, logvar

    def _decode(self, params, z):
        act = self.act_fn()
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = act(torch.matmul(h, params[f"dW{i}"]) + params[f"db{i}"])
        return torch.matmul(h, params["outW"]) + params["outb"]

    def apply(self, params, x, mask=None, train=False, gen=None):
        return self._encode(params, x)[0]

    def reconstruct(self, params, x):
        """E[x | z = mean of q(z|x)]."""
        mean, _ = self._encode(params, x)
        return self.recon_dist.mean(self._decode(params, mean))

    def _eps(self, mean, n, gen, noise):
        if noise is not None:
            return list(noise)
        return [random_normal(gen, mean.shape, mean.device) for _ in range(n)]

    def reconstruction_log_probability(self, params, x, *, gen=None,
                                       noise=None, num_samples=None):
        """Each example's ``log p(x)``, estimated by Monte Carlo over
        q(z|x). ``noise``: the samples' ``[N, n_out]`` normals."""
        n = num_samples or self.num_samples
        mean, logvar = self._encode(params, x)
        total = 0.0
        for eps in self._eps(mean, n, gen, noise):
            z = mean + torch.exp(0.5 * logvar) * eps
            total = total - self.recon_dist.nll(x, self._decode(params, z))
        return total / n

    def pretrain_loss(self, params, x, *, gen=None, noise=None):
        """The negative ELBO: the mean reconstruction NLL over
        ``num_samples`` draws of z plus KL(q(z|x) || N(0, I)). ``noise``:
        one ``[N, n_out]`` tensor of normals a sample (the JAX layer's
        ``num_samples`` keys)."""
        mean, logvar = self._encode(params, x)
        total = 0.0
        for eps in self._eps(mean, self.num_samples, gen, noise):
            z = mean + torch.exp(0.5 * logvar) * eps
            total = total + torch.mean(
                self.recon_dist.nll(x, self._decode(params, z)))
        recon = total / self.num_samples
        kl = 0.5 * torch.mean(torch.sum(torch.exp(logvar) + mean ** 2 - 1.0
                                        - logvar, dim=-1))
        return recon + kl
