"""Attention layers: ``SelfAttentionLayer``, ``TransformerBlock`` and
``attend``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/attention.py``. The
attention core is the flash-attention forward and backward kernels
(``ops/flash_attention.py``) at every sequence length; the projections and
the MLP are plain matmuls (:func:`~.feedforward.policy_matmul`), as the
JAX package leaves them to XLA; under a bf16 policy q, k and v reach the
flash kernels in bf16.
``SelfAttentionLayer`` is non-causal by default; a masked batch reaches
the flash kernels with its ``[B, Tk]`` key mask (``masked_attention``).
Layout: ``[batch, time, features]``.
"""
from __future__ import annotations

from typing import Optional

import torch

from ....common import at_least_f32, get_policy
from ....ops.activations import gelu
from ....ops.flash_attention import flash_attention, masked_attention
from ..inputs import InputType
from ..serde import register_layer
from .base import FeedForwardLayer
from .feedforward import policy_matmul


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The attention core every attention-bearing layer uses: the flash
    kernels (differentiable: the backward is ``flash_bwd``), with a
    ``[B, Tk]`` key mask when one is given. Returns the output only.

    Under a sequence-parallel step (a ``ParallelContext`` with a
    ``seq_axis``, published by ``ParallelWrapper``) q, k and v are this
    rank's time blocks, and an unmasked batch runs Ulysses (the flash
    kernels on a head split) or ring attention over that axis, as the JAX
    ``attend`` dispatches; a masked batch keeps the single-device path."""
    from ....parallel import context as pctx

    ctx = pctx.current()
    if ctx is not None and ctx.seq_axis is not None and mask is None:
        from ....parallel.ring_attention import (
            ring_attention_sharded, ulysses_attention_sharded)
        if ctx.seq_mode == "ring":
            return ring_attention_sharded(q, k, v, ctx.mesh, ctx.seq_axis,
                                          causal, batch_axis=ctx.data_axis)
        return ulysses_attention_sharded(q, k, v, ctx.mesh, ctx.seq_axis,
                                         causal, batch_axis=ctx.data_axis)
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


def attention_residual(params: dict, x: torch.Tensor, n_heads: int,
                       causal: bool, mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """A pre-LN block's first half, ``x + attn(LN1(x) Wqkv) Wo + bo`` (the
    ``ln1_*``, ``Wqkv``, ``Wo`` and ``bo`` params), shared by
    ``TransformerBlock`` and ``MoETransformerBlock``."""
    od = get_policy().output_dtype
    B, T, F_ = x.shape
    D = F_ // n_heads
    h = layer_norm(x, params["ln1_g"], params["ln1_b"])
    qkv = policy_matmul(h, params["Wqkv"]).to(od)
    q, k, v = (t.reshape(B, T, n_heads, D).contiguous()
               for t in torch.split(qkv, F_, dim=-1))
    o = attend(q, k, v, causal, mask).reshape(B, T, F_)
    att = policy_matmul(o, params["Wo"])
    return x + att.to(od) + params["bo"].to(od)


@register_layer("SelfAttention")
class SelfAttentionLayer(FeedForwardLayer):
    """Multi-head self-attention with a fused QKV projection: ``act(attn(x
    Wqkv) Wo + b)``. ``n_out`` is the model width; params ``Wqkv`` [n_in,
    3 n_out], ``Wo`` [n_out, n_out], ``b`` [n_out]."""

    FIELDS = {**FeedForwardLayer.FIELDS, "n_heads": 4, "causal": False}

    @classmethod
    def set_n_in(cls, fields, itype):
        super().set_n_in(fields, itype)
        if not fields.get("n_out"):
            fields["n_out"] = fields["n_in"]

    @classmethod
    def output_type(cls, fields, itype):
        return InputType.recurrent(fields["n_out"], itype.timesteps)

    def __init__(self, conf, device):
        self.n_heads = int(conf.get("n_heads", 4))
        self.causal = bool(conf.get("causal", False))
        super().__init__(conf, device)
        if self.n_out % self.n_heads:
            raise ValueError(f"n_out {self.n_out} not divisible by n_heads "
                             f"{self.n_heads}")

    def param_shapes(self):
        return {"Wqkv": (self.n_in, 3 * self.n_out),
                "Wo": (self.n_out, self.n_out), "b": (self.n_out,)}

    def regularizable_params(self):
        return ("Wqkv", "Wo")

    def apply(self, params, x, mask=None, train=False, gen=None):
        od = get_policy().output_dtype
        x = self.apply_dropout(x, gen, train)
        B, T, _ = x.shape
        H = self.n_heads
        D = self.n_out // H
        qkv = policy_matmul(x, params["Wqkv"]).to(od)
        q, k, v = (t.reshape(B, T, H, D).contiguous()
                   for t in torch.split(qkv, self.n_out, dim=-1))
        o = attend(q, k, v, self.causal, mask).reshape(B, T, self.n_out)
        out = policy_matmul(o, params["Wo"]).to(od) + params["b"].to(od)
        return self.act_fn()(out)


@register_layer("TransformerBlock")
class TransformerBlock(FeedForwardLayer):
    """Pre-LN transformer block: LN -> MHA -> residual, LN -> MLP ->
    residual. Params: ln1/ln2 scales and biases, ``Wqkv`` [F, 3F], ``Wo``
    [F, F], ``bo``, ``W1`` [F, hidden], ``b1``, ``W2`` [hidden, F], ``b2``."""

    FIELDS = {**FeedForwardLayer.FIELDS, "n_heads": 4, "ffn_multiplier": 4,
              "causal": True}

    @classmethod
    def set_n_in(cls, fields, itype):
        super().set_n_in(fields, itype)
        if not fields.get("n_out"):
            fields["n_out"] = fields["n_in"]

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
        od = get_policy().output_dtype
        x = attention_residual(params, x, self.n_heads, self.causal, mask)
        h = layer_norm(x, params["ln2_g"], params["ln2_b"])
        h = policy_matmul(h, params["W1"])
        h = gelu(h.to(od) + params["b1"].to(od))
        h = self.apply_dropout(h, gen, train)
        h = policy_matmul(h, params["W2"])
        return x + h.to(od) + params["b2"].to(od)
