"""Dense-family layers: ``DenseLayer``, ``OutputLayer``, ``LossLayer``,
``ActivationLayer``, ``DropoutLayer``, ``EmbeddingLayer``, and the
pretraining layers ``AutoEncoder`` and ``RBM``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/feedforward.py``.
``W`` is ``[n_in, out]`` as in the JAX package. An ``OutputLayer`` with
``mcxent`` and a softmax takes the fused softmax cross-entropy
(``ops/losses.py``), the ``sm_xent`` kernel on the card.

:func:`policy_matmul` is the contraction of every dense-family and
attention layer: compute-dtype operands and, when the policy's
``grad_accum_dtype`` widens them (``bfloat16_flagship``), a float32 result
with the JAX transpose rule's gradients (:class:`WideMatmul`), the
counterpart of the JAX layers' ``preferred_element_type``.
"""
from __future__ import annotations

import torch

from ....common import accum_dtype, get_policy
from ....ops.fixed_matmul import fixed_matmul, row_invariant
from ....ops.losses import get_loss
from ..serde import register_layer
from .base import FeedForwardLayer, Layer, PretrainLayer, random_uniform


class WideMatmul(torch.autograd.Function):
    """``x @ W`` with ``compute``-dtype operands and an ``accum``-dtype
    result, with the JAX transpose rule's gradients: each gradient is
    contracted in ``accum`` and rounded back to its operand's ``compute``
    dtype (``dx``, then widened to x's dtype; ``dW``, then widened to W's,
    float32), as JAX rounds the cotangent of a ``preferred_element_type``
    product to the operand dtype. On the card the forward is one cuBLAS
    GEMM of the bf16 operands with a float32 result; on the CPU (which has
    no such kernel) it multiplies the operands widened to ``accum``, the
    same function, since products of bf16 values are exact in float32. The
    gradient products take ``accum`` operands on both devices (the
    cotangent is ``accum``)."""

    @staticmethod
    def forward(ctx, x, w, compute, accum):
        xc, wc = x.to(compute), w.to(compute)
        ctx.save_for_backward(xc, wc)
        ctx.x_dtype, ctx.w_dtype = x.dtype, w.dtype
        if xc.is_cuda:
            out = torch.mm(xc.reshape(-1, wc.shape[0]), wc, out_dtype=accum)
            return out.reshape(*xc.shape[:-1], wc.shape[1])
        return torch.matmul(xc.to(accum), wc.to(accum))

    @staticmethod
    def backward(ctx, g):
        xc, wc = ctx.saved_tensors
        acc = g.dtype
        dx = torch.matmul(g, wc.to(acc).t()).to(xc.dtype).to(ctx.x_dtype)
        n_in = wc.shape[0]
        dw = xc.reshape(-1, n_in).to(acc).t() @ g.reshape(-1, g.shape[-1])
        return dx, dw.to(wc.dtype).to(ctx.w_dtype), None, None


def policy_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ W`` with operands in the policy's compute dtype: the result in
    that dtype, or in ``grad_accum_dtype`` when that widens it."""
    cd = get_policy().compute_dtype
    acc = accum_dtype(cd)
    if acc is None:
        if cd == torch.float32 and row_invariant():
            # a serving pin's product (ops/fixed_matmul.py)
            return fixed_matmul(x.to(cd), w.to(cd))
        return torch.matmul(x.to(cd), w.to(cd))
    return WideMatmul.apply(x, w, cd, acc)


def dense(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ W + b`` in the policy's compute dtype, returned in its output
    dtype."""
    pol = get_policy()
    cd = pol.compute_dtype
    out = policy_matmul(x, params["W"])
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


@register_layer("AutoEncoder")
class AutoEncoder(PretrainLayer):
    """Denoising autoencoder: ``encode = act(x @ W + b)``, ``decode =
    act(h @ W^T + vb)``. Its pretraining objective is the
    ``pretrain_loss_fn`` loss of the reconstruction of a corrupted input
    (each input unit zeroed with probability ``corruption_level``), plus a
    KL sparsity term on the mean hidden activation when ``sparsity`` > 0.
    The supervised forward is the encoder."""

    FIELDS = {**FeedForwardLayer.FIELDS, "corruption_level": 0.3,
              "sparsity": 0.0, "pretrain_loss_fn": "mse"}

    def __init__(self, conf, device):
        self.corruption_level = float(conf.get("corruption_level", 0.0))
        self.sparsity = float(conf.get("sparsity", 0.0))
        self.pretrain_loss_fn = conf.get("pretrain_loss_fn", "mse")
        super().__init__(conf, device)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}

    def apply(self, params, x, mask=None, train=False, gen=None):
        x = self.apply_dropout(x, gen, train)
        return self.encode(params, x)

    def encode(self, params, x):
        return self.act_fn()(dense(params, x))

    def decode(self, params, h):
        return self.act_fn()(torch.matmul(h, params["W"].t()) + params["vb"])

    def pretrain_loss(self, params, x, *, gen=None, noise=None):
        """``noise``: the ``[N, n_in]`` uniforms of the corruption mask (a
        unit is kept where its uniform is below ``1 - corruption_level``)."""
        corrupted = x
        if self.corruption_level > 0:
            u = noise if noise is not None else random_uniform(gen, x.shape,
                                                               x.device)
            corrupted = torch.where(u < 1.0 - self.corruption_level, x,
                                    torch.zeros((), dtype=x.dtype,
                                                device=x.device))
        recon = self.decode(params, self.encode(params, corrupted))
        loss = get_loss(self.pretrain_loss_fn)(x, recon, lambda v: v, None)
        if self.sparsity > 0:
            rho = self.sparsity
            h_c = torch.clamp(self.encode(params, x).mean(dim=0), 1e-7,
                              1 - 1e-7)
            loss = loss + torch.sum(rho * torch.log(rho / h_c)
                                    + (1 - rho) * torch.log((1 - rho)
                                                            / (1 - h_c)))
        return loss


@register_layer("RBM")
class RBM(PretrainLayer):
    """Restricted Boltzmann machine trained by CD-k; the supervised forward
    is ``act(x @ W + b)``.

    The CD-k update is not the gradient of a function, so pretraining
    minimizes a surrogate whose gradient is the negative CD update: the
    Gibbs chain runs without gradient (the JAX ``stop_gradient``) and the
    surrogate is linear in the params. ``visible_unit`` is ``"binary"``
    (sampled) or ``"gaussian"`` (the mean, unsampled)."""

    FIELDS = {**FeedForwardLayer.FIELDS, "k": 1, "visible_unit": "binary",
              "hidden_unit": "binary"}

    def __init__(self, conf, device):
        self.k = int(conf.get("k", 1))
        self.visible_unit = conf.get("visible_unit", "binary")
        self.hidden_unit = conf.get("hidden_unit", "binary")
        super().__init__(conf, device)

    def param_shapes(self):
        return {"W": (self.n_in, self.n_out), "b": (self.n_out,),
                "vb": (self.n_in,)}

    def apply(self, params, x, mask=None, train=False, gen=None):
        x = self.apply_dropout(x, gen, train)
        return self.act_fn()(dense(params, x))

    def prop_up(self, params, v):
        return torch.sigmoid(torch.matmul(v, params["W"]) + params["b"])

    def prop_down(self, params, h):
        pre = torch.matmul(h, params["W"].t()) + params["vb"]
        return pre if self.visible_unit == "gaussian" else torch.sigmoid(pre)

    def noise_shapes(self, n: int) -> list:
        """The shape of each of the chain's ``2k + 1`` uniforms (the JAX
        layer's ``2k + 1`` keys): the first hidden sample, then a visible
        and a hidden one a Gibbs step."""
        return ([(n, self.n_out)]
                + [(n, self.n_in), (n, self.n_out)] * self.k)

    @torch.no_grad()
    def gibbs_chain(self, params, x, *, gen=None, noise=None):
        """The CD-k chain from ``x``: ``(ph, vk, hk, draws)``, the data's
        hidden probabilities, the chain's last visible and hidden values,
        and every Bernoulli draw as ``(uniform, probability, sample)``.
        Element ``j`` of ``noise`` is the uniform of the JAX key ``j``."""
        shapes = self.noise_shapes(x.shape[0])
        draws = []

        def sample(j, p):
            u = noise[j] if noise is not None else random_uniform(
                gen, shapes[j], p.device)
            s = (u < p).to(p.dtype)
            draws.append((u, p, s))
            return s

        ph = self.prop_up(params, x)
        vk = x
        hk = sample(0, ph)
        for i in range(self.k):
            vk = self.prop_down(params, hk)
            if self.visible_unit == "binary":
                vk = sample(2 * i + 1, vk)
            hk_prob = self.prop_up(params, vk)
            hk = sample(2 * i + 2, hk_prob) if i < self.k - 1 else hk_prob
        return ph, vk, hk, draws

    def pretrain_loss(self, params, x, *, gen=None, noise=None):
        """The surrogate ``-(<v+ h+> - <v- h->) . W - (<v+> - <v->) . vb -
        (<h+> - <h->) . b`` (means over the batch): its gradient is the
        negative CD-k update. ``noise``: the chain's uniforms, by
        :meth:`noise_shapes`."""
        ph, vk, hk, _ = self.gibbs_chain(params, x, gen=gen, noise=noise)
        n = x.shape[0]
        w = params["W"]
        w_term = (torch.sum(torch.matmul(x.t(), ph) * w)
                  - torch.sum(torch.matmul(vk.t(), hk) * w)) / n
        vb_term = torch.sum((x.mean(dim=0) - vk.mean(dim=0)) * params["vb"])
        b_term = torch.sum((ph.mean(dim=0) - hk.mean(dim=0)) * params["b"])
        return -(w_term + vb_term + b_term)
