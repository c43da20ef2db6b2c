"""Convolution and pooling layers: ``ConvolutionLayer``, ``SubsamplingLayer``,
``Upsampling2D``, ``ZeroPaddingLayer`` and ``GlobalPoolingLayer``.

Counterpart of ``deeplearning4j_tpu/nn/conf/layers/convolutional.py``. The
JAX package leaves convolution and pooling to XLA (``conv_general_dilated``,
``reduce_window``); here they are ``F.conv2d`` (cuDNN on the card, TF32 off)
and ``F.max_pool2d``/``F.avg_pool2d``.

Layout as in the JAX package: activations NHWC, kernels HWIO
(``W [kh, kw, n_in, n_out]``), so weights cross unchanged. A layer views its
NHWC input as NCHW with ``permute`` (for a contiguous NHWC tensor that is
PyTorch's ``channels_last`` layout, which cuDNN takes as it is) and hands
NHWC on.

Under a policy whose ``grad_accum_dtype`` widens the compute dtype
(``bfloat16_flagship``) a convolution is :class:`ConvWide`, the JAX layer's
``_conv_wide``: bf16 operands in the forward, and gradient convolutions with
both operands upcast to float32. With TF32 off those are true float32
convolutions on the card (on a TPU the same program is still a bf16 MXU
pass): the reference's semantics, kept, at their cost.

``convolution_mode="same"`` is XLA's ``"SAME"``: ``ceil(size / stride)``
outputs, the padding split low = total // 2, high = the rest (asymmetric
for strided windows), padded explicitly with ``F.pad``: zeros for
convolutions and sums, -inf for max pooling (``reduce_window``'s initial
value). Average pooling divides by kh * kw whatever the padding, as the
JAX layer does. ``"truncate"`` and ``"strict"`` pad ``padding`` on both
sides.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ....common import accum_dtype, get_policy
from ..inputs import InputType
from ..serde import register_layer
from .base import Layer


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _out_dim(size: int, k: int, s: int, p: int, mode: str) -> int:
    if mode == "same":
        return -(-size // s)
    return (size + 2 * p - k) // s + 1


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high)."""
    total = max((-(-size // s) - 1) * s + k - size, 0)
    return total // 2, total - total // 2


def _pads(mode: str, x: torch.Tensor, k, s, pad) -> Tuple[int, int, int, int]:
    """``F.pad``'s (left, right, top, bottom) for NCHW ``x``."""
    if mode == "same":
        top, bottom = _same_pads(x.shape[2], k[0], s[0])
        left, right = _same_pads(x.shape[3], k[1], s[1])
        return (left, right, top, bottom)
    return (pad[1], pad[1], pad[0], pad[0])


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ConvWide(torch.autograd.Function):
    """A convolution of NCHW ``x`` and OIHW ``w`` with ``compute``-dtype
    operands, accumulated in ``accum`` and returned in ``out_dtype``; its
    backward runs the gradient convolutions with both operands (the saved
    input and the uncast weight) upcast to ``accum``, returning ``dx`` in
    ``x``'s dtype and ``dW`` in ``w``'s. The forward is one cuDNN
    convolution in ``compute`` on the card when ``out_dtype`` is
    ``compute`` (cuDNN accumulates bf16 in float32 and rounds once, the
    same function), else a convolution of the operands upcast to ``accum``
    (bf16 products are exact in float32) cast to ``out_dtype``."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, dilation, compute, accum,
                out_dtype):
        xc, wc = x.to(compute), w.to(compute)
        if x.is_cuda and out_dtype == compute:
            out = F.conv2d(xc, wc, stride=stride, padding=padding,
                           dilation=dilation)
        else:
            out = F.conv2d(xc.to(accum), wc.to(accum), stride=stride,
                           padding=padding, dilation=dilation).to(out_dtype)
        ctx.save_for_backward(x, w)
        ctx.conv = (stride, padding, dilation, accum)
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding, dilation, accum = ctx.conv
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(accum), x.to(accum), w.to(accum), None, stride, padding,
            dilation, False, (0, 0), 1,
            (ctx.needs_input_grad[0], ctx.needs_input_grad[1], False))
        return (None if dx is None else dx.to(x.dtype),
                None if dw is None else dw.to(w.dtype),
                None, None, None, None, None, None)


@register_layer("Convolution")
class ConvolutionLayer(Layer):
    """2-D convolution; ``n_in`` input channels (inferred), ``n_out``
    filters."""

    FIELDS = {"n_in": 0, "n_out": 0, "kernel_size": (5, 5),
              "stride": (1, 1), "padding": (0, 0), "dilation": (1, 1),
              "convolution_mode": "truncate", "has_bias": True}

    @classmethod
    def set_n_in(cls, fields, itype):
        if not fields.get("n_in"):
            if itype.kind not in ("convolutional", "convolutionalflat"):
                raise ValueError("ConvolutionLayer needs convolutional input, "
                                 f"got {itype.kind}")
            fields["n_in"] = itype.channels

    @classmethod
    def output_type(cls, fields, itype):
        kh, kw = _pair(fields["kernel_size"])
        sh, sw = _pair(fields["stride"])
        ph, pw = _pair(fields["padding"])
        dh, dw = _pair(fields["dilation"])
        mode = fields["convolution_mode"].lower()
        # the dilated kernel's extent, as XLA's rhs_dilation sees it
        h = _out_dim(itype.height, (kh - 1) * dh + 1, sh, ph, mode)
        w = _out_dim(itype.width, (kw - 1) * dw + 1, sw, pw, mode)
        return InputType.convolutional(h, w, fields["n_out"])

    def __init__(self, conf, device):
        self.n_in = int(conf["n_in"])
        self.n_out = int(conf["n_out"])
        self.kernel_size = _pair(conf["kernel_size"])
        self.stride = _pair(conf["stride"])
        self.padding = _pair(conf["padding"])
        self.dilation = _pair(conf["dilation"])
        self.convolution_mode = str(conf["convolution_mode"]).lower()
        self.has_bias = bool(conf["has_bias"])
        super().__init__(conf, device)

    def param_shapes(self):
        shapes = {"W": (*self.kernel_size, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def apply(self, params, x, mask=None, train=False, gen=None):
        x = self.apply_dropout(x, gen, train)
        pol = get_policy()
        cd, od = pol.compute_dtype, pol.output_dtype
        acc = accum_dtype(cd)
        # the raw input and weight go to ConvWide, so that their gradients
        # keep their dtypes
        xc = _nchw(x if acc is not None else x.to(cd))
        w = params["W"].permute(3, 2, 0, 1)  # OIHW
        padding = self.padding
        if self.convolution_mode == "same":
            k_eff = tuple((k - 1) * d + 1
                          for k, d in zip(self.kernel_size, self.dilation))
            xc = F.pad(xc, _pads("same", xc, k_eff, self.stride, None))
            padding = (0, 0)
        if acc is None:
            out = F.conv2d(xc, w.to(cd), stride=self.stride, padding=padding,
                           dilation=self.dilation).to(od)
        else:
            out = ConvWide.apply(xc, w, self.stride, padding, self.dilation,
                                 cd, acc, od)
        out = _nhwc(out)
        if self.has_bias:
            out = out + params["b"].to(out.dtype)
        return self.act_fn()(out)


@register_layer("Subsampling")
class SubsamplingLayer(Layer):
    """Pooling: max, avg, sum or pnorm."""

    FIELDS = {"pooling_type": "max", "kernel_size": (2, 2), "stride": (2, 2),
              "padding": (0, 0), "convolution_mode": "truncate", "pnorm": 2}

    @classmethod
    def output_type(cls, fields, itype):
        kh, kw = _pair(fields["kernel_size"])
        sh, sw = _pair(fields["stride"])
        ph, pw = _pair(fields["padding"])
        mode = fields["convolution_mode"].lower()
        return InputType.convolutional(_out_dim(itype.height, kh, sh, ph, mode),
                                       _out_dim(itype.width, kw, sw, pw, mode),
                                       itype.channels)

    def __init__(self, conf, device):
        self.pooling_type = str(conf["pooling_type"]).lower()
        if self.pooling_type not in ("max", "avg", "average", "sum", "pnorm"):
            raise ValueError(f"Unknown pooling type '{conf['pooling_type']}'")
        self.kernel_size = _pair(conf["kernel_size"])
        self.stride = _pair(conf["stride"])
        self.padding = _pair(conf["padding"])
        self.convolution_mode = str(conf["convolution_mode"]).lower()
        self.pnorm = float(conf["pnorm"])
        super().__init__(conf, device)

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        k, s = self.kernel_size, self.stride
        xc = _nchw(x)
        pads = _pads(self.convolution_mode, xc, k, s, self.padding)
        padded = any(pads)
        if self.pooling_type == "max":
            if padded:
                xc = F.pad(xc, pads, value=float("-inf"))
            out = F.max_pool2d(xc, k, s)
        else:
            if self.pooling_type == "pnorm":
                xc = xc.abs() ** self.pnorm
            if padded:
                xc = F.pad(xc, pads)
            # a window's sum, divided by kh * kw for avg, padding included
            div = k[0] * k[1] if self.pooling_type in ("avg", "average") else 1
            out = F.avg_pool2d(xc, k, s, divisor_override=div)
            if self.pooling_type == "pnorm":
                out = out ** (1.0 / self.pnorm)
        return _nhwc(out)


@register_layer("Upsampling2D")
class Upsampling2D(Layer):
    """Nearest-neighbour upsampling by ``size``."""

    FIELDS = {"size": (2, 2)}

    @classmethod
    def output_type(cls, fields, itype):
        sh, sw = _pair(fields["size"])
        return InputType.convolutional(itype.height * sh, itype.width * sw,
                                       itype.channels)

    def __init__(self, conf, device):
        self.size = _pair(conf["size"])
        super().__init__(conf, device)

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        sh, sw = self.size
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)


@register_layer("ZeroPadding")
class ZeroPaddingLayer(Layer):
    """Zeros around the image: ``padding`` rows above and below, columns
    left and right."""

    FIELDS = {"padding": (1, 1)}

    @classmethod
    def output_type(cls, fields, itype):
        ph, pw = _pair(fields["padding"])
        return InputType.convolutional(itype.height + 2 * ph,
                                       itype.width + 2 * pw, itype.channels)

    def __init__(self, conf, device):
        self.padding = _pair(conf["padding"])
        super().__init__(conf, device)

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        ph, pw = self.padding
        return F.pad(x, (0, 0, pw, pw, ph, ph))


@register_layer("GlobalPooling")
class GlobalPoolingLayer(Layer):
    """Pooling over all spatial or time positions: ``[B, H, W, C] -> [B, C]``,
    ``[B, T, F] -> [B, F]``; a ``[B, T]`` mask leaves padded steps out."""

    FIELDS = {"pooling_type": "avg"}

    @classmethod
    def output_type(cls, fields, itype):
        if itype.kind == "convolutional":
            return InputType.feed_forward(itype.channels)
        return InputType.feed_forward(itype.size)

    def __init__(self, conf, device):
        self.pooling_type = str(conf["pooling_type"]).lower()
        super().__init__(conf, device)

    def regularizable_params(self):
        return ()

    def apply(self, params, x, mask=None, train=False, gen=None):
        ptype = self.pooling_type
        if mask is not None and x.ndim == 3:
            m = mask.to(x.dtype)[..., None]
            if ptype in ("avg", "average"):
                return (x * m).sum(1) / torch.clamp_min(m.sum(1), 1.0)
            if ptype == "max":
                return torch.where(m > 0, x, float("-inf")).amax(1)
            return (x * m).sum(1)
        dims = tuple(range(1, x.ndim - 1))
        if ptype in ("avg", "average"):
            return x.mean(dim=dims)
        if ptype == "max":
            # amax splits a tie's gradient evenly, as jnp.max does
            return x.amax(dim=dims)
        if ptype == "sum":
            return x.sum(dim=dims)
        raise ValueError(f"Unknown pooling type '{self.pooling_type}'")
