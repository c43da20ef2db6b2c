"""Attention layers of the slice: ``TransformerBlock`` and ``attend``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/attention.py``. The
attention core is the flash-attention forward and backward kernels
(``ops/flash_attention.py``) at every sequence length; the projections and
the MLP are plain ``torch.matmul``, as the JAX package leaves them to XLA.
Layout: ``[batch, time, features]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....common import at_least_f32, get_policy
from ....ops.activations import gelu
from ....ops.flash_attention import flash_attention, masked_attention
from ..serde import register_layer
from .base import Layer


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention core every attention-bearing layer uses: the flash
    kernels (differentiable: the backward is ``flash_bwd``), with a
    ``[B, Tk]`` key mask when one is given. Returns the output only."""
    if mask is not None:
        return masked_attention(q, k, v, mask, causal)[0]
    return flash_attention(q, k, v, causal)[0]


def layer_norm(x: torch.Tensor, g: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm with statistics in at least float32 (``TransformerBlock._ln``
    of the JAX package: biased variance, ``rsqrt(var + eps)``)."""
    xf = x.to(at_least_f32(x.dtype))
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    xhat = ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)
    return xhat * g.to(x.dtype) + b.to(x.dtype)


@register_layer("TransformerBlock")
class TransformerBlock(Layer):
    """Pre-LN transformer block: LN -> MHA -> residual, LN -> MLP ->
    residual. Params: ln1/ln2 scales and biases, ``Wqkv`` [F, 3F], ``Wo``
    [F, F], ``bo``, ``W1`` [F, hidden], ``b1``, ``W2`` [hidden, F], ``b2``."""

    def __init__(self, conf, device):
        self.n_heads = int(conf.get("n_heads", 4))
        self.ffn_multiplier = int(conf.get("ffn_multiplier", 4))
        self.causal = bool(conf.get("causal", True))
        super().__init__(conf, device)
        if self.n_out % self.n_heads:
            raise ValueError(f"width {self.n_out} not divisible by heads "
                             f"{self.n_heads}")

    def param_shapes(self):
        F_ = self.n_out
        hidden = self.ffn_multiplier * F_
        return {"ln1_g": (F_,), "ln1_b": (F_,), "Wqkv": (F_, 3 * F_),
                "Wo": (F_, F_), "bo": (F_,), "ln2_g": (F_,), "ln2_b": (F_,),
                "W1": (F_, hidden), "b1": (hidden,), "W2": (hidden, F_),
                "b2": (F_,)}

    def regularizable_params(self):
        return ("Wqkv", "Wo", "W1", "W2")

    def init_param(self, name, shape, gen):
        if name.endswith("_g"):
            return torch.ones(shape)
        if not name.startswith("W"):
            return torch.zeros(shape)
        return super().init_param(name, shape, gen)

    def apply(self, params, x, mask=None, train=False, gen=None):
        pol = get_policy()
        cd, od = pol.compute_dtype, pol.output_dtype
        B, T, F_ = x.shape
        H = self.n_heads
        D = F_ // H
        h = layer_norm(x, params["ln1_g"], params["ln1_b"])
        qkv = torch.matmul(h.to(cd), params["Wqkv"].to(cd)).to(od)
        q, k, v = (t.reshape(B, T, H, D).contiguous()
                   for t in torch.split(qkv, F_, dim=-1))
        o = attend(q, k, v, self.causal, mask).reshape(B, T, F_)
        att = torch.matmul(o.to(cd), params["Wo"].to(cd))
        x = x + att.to(od) + params["bo"].to(od)
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        h = torch.matmul(h.to(cd), params["W1"].to(cd))
        h = gelu(h.to(od) + params["b1"].to(od))
        h = self.apply_dropout(h, gen, train)
        h = torch.matmul(h.to(cd), params["W2"].to(cd))
        return x + h.to(od) + params["b2"].to(od)
