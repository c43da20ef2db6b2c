"""Mixture-of-experts layers with top-1 (Switch) routing: ``MoELayer`` and
``MoETransformerBlock``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/moe.py``, its dense
path: every expert runs on every token (batched ``torch.einsum``, as the
JAX package leaves the expert products to XLA, outside any Pallas kernel)
and each token keeps its routed expert's output, selected by a one-hot and
scaled by the gate. The JAX package's expert-parallel path (``_ep_context``
and ``parallel/moe.py``: all_to_all dispatch over an ``expert`` mesh axis)
waits for the parallel context (ROADMAP.md); this port has none, so the
dense path is the only one.

Params: ``Wg`` [F, E] router; experts on the leading axis, ``W1`` [E, F,
H], ``b1`` [E, H], ``W2`` [E, H, F], ``b2`` [E, F]. A training forward
publishes the Switch load-balance term ``E * sum_e f_e P_e`` as the
layer's ``"aux_loss"`` state, which the networks' training objectives add,
weighted by ``aux_loss_weight``; an eval forward publishes 0. The block's
attention runs through :func:`~.attention.attend`, so through the flash
kernels.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ....common import accum_dtype, get_policy
from ..inputs import InputType
from ..serde import register_layer
from .attention import attention_residual, layer_norm
from .base import FeedForwardLayer, random_normal


def expert_einsum(pattern: str, a: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """``einsum(pattern, a, w)`` with compute-dtype operands, the result in
    the compute dtype or, when the policy's ``grad_accum_dtype`` widens it,
    in that dtype (the operands widened: products of bf16 values are exact
    in float32, so the forward is the JAX ``preferred_element_type`` one;
    the gradients stay float32)."""
    cd = get_policy().compute_dtype
    acc = accum_dtype(cd)
    if acc is None:
        return torch.einsum(pattern, a.to(cd), w.to(cd))
    return torch.einsum(pattern, a.to(cd).to(acc), w.to(cd).to(acc))


@register_layer("MoE")
class MoELayer(FeedForwardLayer):
    """Top-1 routed expert FFN: ``act(gate * expert_e(x))``, ``expert_e(x)
    = relu(x W1[e] + b1[e]) W2[e] + b2[e]``. ``expert_hidden`` 0 means 4 x
    width; ``router_noise`` is the stddev of normal jitter on the router
    logits in training."""

    FIELDS = {**FeedForwardLayer.FIELDS, "n_experts": 4, "expert_hidden": 0,
              "router_noise": 0.0, "aux_loss_weight": 0.01}

    @classmethod
    def set_n_in(cls, fields, itype):
        super().set_n_in(fields, itype)
        if not fields.get("n_out"):
            fields["n_out"] = fields["n_in"]

    @classmethod
    def output_type(cls, fields, itype):
        if itype is not None and itype.kind == "recurrent":
            return InputType.recurrent(fields["n_out"], itype.timesteps)
        return InputType.feed_forward(fields["n_out"])

    def __init__(self, conf, device):
        self.n_experts = int(conf.get("n_experts", 4))
        self.expert_hidden = int(conf.get("expert_hidden", 0))
        self.router_noise = float(conf.get("router_noise", 0.0))
        self.aux_loss_weight = float(conf.get("aux_loss_weight", 0.01))
        super().__init__(conf, device)

    def hidden(self) -> int:
        return self.expert_hidden or 4 * self.n_out

    def param_shapes(self):
        E, F_, H = self.n_experts, self.n_in, self.hidden()
        return {"Wg": (F_, E), "W1": (E, F_, H), "b1": (E, H),
                "W2": (E, H, F_), "b2": (E, F_)}

    def init_param(self, name, shape, gen):
        if name in ("W1", "W2"):
            # one draw of the expert's own [in, out] matrix an expert, so
            # each has the fans of a dense layer (the JAX vmap over experts)
            return torch.stack([super(MoELayer, self).init_param(
                name, shape[1:], gen) for _ in range(shape[0])])
        if name.startswith("W"):
            return super().init_param(name, shape, gen)
        return torch.zeros(shape)

    def init_state(self):
        return {"aux_loss": torch.zeros(())}

    def regularizable_params(self):
        return ("W1", "W2")

    def uses_dropout(self) -> bool:
        # router jitter draws from the step's generator as dropout does (and
        # keeps a network off the captured K-step path, as dropout does)
        return super().uses_dropout() or self.router_noise > 0

    def route(self, params, x2d, train: bool = False, gen=None):
        """``(expert index [S], gate [S], probs [S, E])`` of the top-1
        router."""
        logits = x2d @ params["Wg"]
        if train and self.router_noise > 0 and gen is not None:
            logits = logits + self.router_noise * random_normal(
                gen, logits.shape, logits.device)
        probs = torch.softmax(logits, dim=-1)
        gate, eidx = torch.max(probs, dim=-1)
        return eidx, gate, probs

    def _one_hot(self, eidx: torch.Tensor, dtype) -> torch.Tensor:
        # a comparison, not F.one_hot: no host sync, so it captures in a
        # CUDA graph
        experts = torch.arange(self.n_experts, device=eidx.device)
        return (eidx[:, None] == experts).to(dtype)

    def balance_term(self, eidx, probs) -> torch.Tensor:
        """The Switch load-balance term ``E * sum_e f_e * P_e`` of a routing
        decision (``f_e`` the share of tokens routed to ``e``, ``P_e`` its
        mean router probability). In a data-parallel step ``f_e`` is the
        whole batch's (all-reduced over the batch's ranks) and ``P_e`` this
        rank's: the term's mean over the ranks is the global term, and so
        is its gradient."""
        from ....parallel.context import batch_group

        frac = self._one_hot(eidx, probs.dtype).mean(dim=0)
        group, n = batch_group()
        if group is not None:
            # a data-parallel step: the global batch's routing shares, with
            # this rank's P_e, so the ranks' mean gradient is the global one
            dist.all_reduce(frac, group=group)
            frac = frac / n
        return self.n_experts * torch.sum(frac * probs.mean(dim=0))

    def load_balance_loss(self, params, x2d) -> torch.Tensor:
        eidx, _, probs = self.route(params, x2d)
        return self.balance_term(eidx, probs)

    def moe_ffn_2d(self, params, x2d, train: bool = False, gen=None):
        """The top-1 expert FFN on ``[S, F]`` tokens: ``(y [S, F], aux)``,
        every expert evaluated on every token, then each token's routed
        output selected by a one-hot and scaled by its gate."""
        od = get_policy().output_dtype
        eidx, gate, probs = self.route(params, x2d, train, gen)
        aux = self.balance_term(eidx, probs)
        h = (expert_einsum("sf,efh->esh", x2d, params["W1"]).to(od)
             + params["b1"][:, None].to(od))
        h = torch.relu(h)
        y_all = (expert_einsum("esh,ehf->esf", h, params["W2"]).to(od)
                 + params["b2"][:, None].to(od))
        sel = self._one_hot(eidx, y_all.dtype)
        y = torch.einsum("se,esf->sf", sel, y_all) * gate[:, None].to(
            y_all.dtype)
        return y, aux

    def _new_state(self, aux, train: bool) -> dict:
        return {"aux_loss": aux if train else torch.zeros_like(aux)}

    def apply_with_state(self, params, state, x, mask=None, train=False,
                         gen=None):
        shape = x.shape
        y, aux = self.moe_ffn_2d(params, x.reshape(-1, shape[-1]), train, gen)
        return self.act_fn()(y.reshape(shape)), self._new_state(aux, train)

    def apply(self, params, x, mask=None, train=False, gen=None):
        return self.apply_with_state(params, self.state(), x, mask, train,
                                     gen)[0]


@register_layer("MoETransformerBlock")
class MoETransformerBlock(MoELayer):
    """Switch transformer block: pre-LN residual attention (fused ``Wqkv``,
    ``Wo``/``bo``), then a pre-LN residual top-1 MoE FFN. Its activation
    defaults to identity (the residual stream)."""

    FIELDS = {**MoELayer.FIELDS, "n_heads": 4, "causal": True,
              "activation": "identity"}

    @classmethod
    def output_type(cls, fields, itype):
        return InputType.recurrent(fields["n_out"], itype.timesteps)

    def __init__(self, conf, device):
        self.n_heads = int(conf.get("n_heads", 4))
        self.causal = bool(conf.get("causal", True))
        super().__init__(conf, device)
        if self.n_out % self.n_heads:
            raise ValueError(f"width {self.n_out} not divisible by heads "
                             f"{self.n_heads}")

    def param_shapes(self):
        F_ = self.n_out
        return {**super().param_shapes(), "ln1_g": (F_,), "ln1_b": (F_,),
                "Wqkv": (F_, 3 * F_), "Wo": (F_, F_), "bo": (F_,),
                "ln2_g": (F_,), "ln2_b": (F_,)}

    def init_param(self, name, shape, gen):
        if name.endswith("_g"):
            return torch.ones(shape)
        return super().init_param(name, shape, gen)

    def regularizable_params(self):
        return ("Wqkv", "Wo", "W1", "W2")

    def attention_residual(self, params, x, mask=None) -> torch.Tensor:
        """The block's first half: ``x + attn(LN1(x)) Wo + bo``."""
        return attention_residual(params, x, self.n_heads, self.causal, mask)

    def ffn_tokens(self, params, x, mask=None):
        """``(r, t)``: the residual stream after the attention half and the
        MoE FFN's ``[S, F]`` input tokens ``LN2(r)``."""
        r = self.attention_residual(params, x, mask)
        h = layer_norm(r, params["ln2_g"], params["ln2_b"])
        return r, h.reshape(-1, h.shape[-1])

    def apply_with_state(self, params, state, x, mask=None, train=False,
                         gen=None):
        x, tokens = self.ffn_tokens(params, x, mask)
        y2d, aux = self.moe_ffn_2d(params, tokens, train, gen)
        out = self.act_fn()(x + y2d.reshape(x.shape))
        return out, self._new_state(aux, train)
